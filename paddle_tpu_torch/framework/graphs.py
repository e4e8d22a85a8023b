"""CUDA-graph capture shared by the AOT engine (``inference/aot``),
``generate()``'s static route (``generation``), the inference API's
``Predictor`` (``inference/api.py``) and the train step
(``jit/bridge.py``): the port's counterpart of running a compiled XLA
program.

- ``capture_stream(device)``: the stream every capture on a device runs
  on; a capturing thread's cuBLAS and cuBLASLt workspaces on it are
  allocated before its first capture.
- ``run_on_capture_stream(device, fn, *args)``: ``fn`` run eagerly on
  the capture stream (a real run before its capture), under the device
  gate's exclusive side.
- ``graph_pool(device, owner)``: the graph memory pool an owner's
  programs on a device share.
- ``GraphProgram``: one function captured into a CUDA graph over static
  input buffers; a call copies its operands in, replays, adds the
  launch counts its capture recorded and returns clones of the outputs.
  Generators the function draws from are registered with the graph, so
  each replay advances them as an eager run would.
- ``Captured``: a program with the weights it reads by address, for
  the per-signature caches that re-capture when a weight is rebound.
- ``device_gate``: the process-wide rule that keeps captures apart from
  other threads' device work (below).

The capture rule across threads. ``torch.cuda.graph`` captures in the
"global" error mode: while one thread captures, a synchronising call
from any other thread (``.item()``, ``.cpu()``, an event wait, a
``cudaMalloc``) invalidates the capture ("operation not permitted when
stream is capturing"). Replicas of a serving pool (``serving.Router``)
run one serve loop per thread on one device, and a replica captures at a
warm start or a bucket miss while the others serve. So every capture
holds ``device_gate.exclusive()``, and every serve-loop iteration (and
every span export or import between iterations) holds
``device_gate.shared()``: a capture waits for the running iterations to
end, and no iteration starts while it runs. A thread that holds the
shared side and captures (a bucket miss inside its own iteration) sets
its shared hold aside while it waits, so two replicas that miss at once
capture one after the other instead of deadlocking. Other code that
drives the device beside live replicas must take the shared side too.

cuBLAS keeps one workspace per (handle, stream), and a handle is per
thread: every graph a thread captures on the capture stream uses that
thread's workspace there, whichever thread replays it. So an eager run
on the capture stream (the AOT engine's warm-up before a capture) holds
the exclusive side too, ordered after and before the default stream's
work: it would otherwise share a split-K workspace with another
thread's replays of graphs that the same thread captured.
"""
from __future__ import annotations

import contextlib
import gc
import threading
import weakref

import torch

from ..kernels import _build

__all__ = ["GraphProgram", "Captured", "capture_stream", "graph_pool",
           "run_on_capture_stream", "DeviceGate", "device_gate"]


class DeviceGate:
    """A re-entrant shared / exclusive lock over the device: shared for
    device work that may run on several threads at once, exclusive for a
    CUDA-graph capture (see the module's capture rule). Exclusive waiters
    go first: no new shared hold starts while a capture waits."""

    def __init__(self):
        self._cv = threading.Condition()
        self._shared = {}        # thread id -> shared depth
        self._owner = None       # thread id of the exclusive holder
        self._depth = 0          # its exclusive depth
        self._waiting = 0        # threads waiting for the exclusive side

    @contextlib.contextmanager
    def shared(self):
        me = threading.get_ident()
        with self._cv:
            if not (self._shared.get(me) or self._owner == me):
                while self._owner is not None or self._waiting:
                    self._cv.wait()
            self._shared[me] = self._shared.get(me, 0) + 1
        try:
            yield
        finally:
            with self._cv:
                n = self._shared[me] - 1
                if n:
                    self._shared[me] = n
                else:
                    del self._shared[me]
                    self._cv.notify_all()

    @contextlib.contextmanager
    def exclusive(self):
        me = threading.get_ident()
        held = 0
        with self._cv:
            if self._owner != me:
                # set this thread's shared hold aside while it waits: two
                # holders that both capture would otherwise wait on each
                # other
                held = self._shared.pop(me, 0)
                if held:
                    self._cv.notify_all()
                self._waiting += 1
                try:
                    while self._owner is not None or self._shared:
                        self._cv.wait()
                finally:
                    self._waiting -= 1
                self._owner = me
            self._depth += 1
        try:
            yield
        finally:
            with self._cv:
                self._depth -= 1
                if not self._depth:
                    self._owner = None
                    if held:
                        self._shared[me] = held
                    self._cv.notify_all()


device_gate = DeviceGate()


def _leaves(x, out):
    """The tensors of a nested argument or result, in order."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (tuple, list)):
        for y in x:
            _leaves(y, out)
    return out


def _rebuild(template, it):
    """``template`` with its tensors replaced by ``it``'s, in order."""
    if isinstance(template, torch.Tensor):
        return next(it)
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_rebuild(y, it) for y in template))
    if isinstance(template, (tuple, list)):
        return type(template)(_rebuild(y, it) for y in template)
    return template


def _structure(x):
    """What must match between a program's capture and its calls: every
    tensor's shape, dtype and device, and every other value."""
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), x.dtype, x.device)
    if isinstance(x, (tuple, list)):
        return (type(x).__name__,) + tuple(_structure(y) for y in x)
    return ("V", repr(x))


_capture_streams = {}     # device index -> the process's capture stream
_blas_ready = set()       # (device index, cuBLAS handle) warmed on it


def _device_index(device):
    return device.index if device.index is not None else \
        torch.cuda.current_device()


def _warm_blas(stream):
    """Allocate the calling thread's cuBLAS and cuBLASLt workspaces on
    ``stream`` (once per handle): cuBLAS keeps one workspace per (handle,
    stream), and one first allocated during a capture would come from
    that graph's pool, which the workspace cache would outlive."""
    device = stream.device
    key = (_device_index(device), torch.cuda.current_blas_handle())
    if key in _blas_ready:
        return
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        for dt in (torch.float32, torch.bfloat16):
            a = torch.ones(64, 64, device=device, dtype=dt)
            torch.mm(a, a)
            torch.nn.functional.linear(a, a, a[0])
    torch.cuda.current_stream(device).wait_stream(stream)
    _blas_ready.add(key)


def capture_stream(device):
    """The stream every capture on ``device`` runs on, the creating
    thread's cuBLAS workspaces allocated on it (another capturing thread
    allocates its own first: ``GraphProgram``)."""
    idx = _device_index(device)
    s = _capture_streams.get(idx)
    if s is None:
        s = torch.cuda.Stream(device)
        with device_gate.exclusive():
            _warm_blas(s)
        _capture_streams[idx] = s
    return s


def run_on_capture_stream(device, fn, *args):
    """``fn(*args)`` run eagerly on ``device``'s capture stream, ordered
    after and before the current stream's work, under the device gate's
    exclusive side: the run before a capture, which allocates what the
    capture will (cuBLAS keeps a workspace per stream) and does the real
    work of that call."""
    stream = capture_stream(device)
    with device_gate.exclusive():
        cur = torch.cuda.current_stream(device)
        stream.wait_stream(cur)
        with torch.cuda.stream(stream):
            out = fn(*args)
        cur.wait_stream(stream)
    return out


_pools = {}      # (owner, device index) -> graph memory pool


def graph_pool(device, owner):
    """The graph memory pool that ``owner``'s programs on ``device``
    share (they run one at a time on one stream, and every output is
    cloned out of it). Owners keep pools apart because a pool's memory
    goes back to the allocator only once every graph captured into it is
    freed (the AOT engine keeps a pool of its own, freed with it)."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    pool = _pools.get((owner, idx))
    if pool is None:
        pool = _pools[(owner, idx)] = torch.cuda.graph_pool_handle()
    return pool


class Captured:
    """A signature's CUDA graph and the weights it reads by address. It
    keeps weak references: a rebound weight is another tensor, so a dead
    reference is a rebind too, and the old weights are freed with their
    last other owner, not held by every signature captured against them.
    A load in place keeps the tensors and their storage: ``reads`` holds
    and the graph replays on the new values."""

    def __init__(self, program, baked):
        self.program = program
        self.bound = [(weakref.ref(t), t.data_ptr()) for t in baked]

    def reads(self, baked):
        return len(baked) == len(self.bound) and all(
            r() is t and t.data_ptr() == p
            for t, (r, p) in zip(baked, self.bound))


class GraphProgram:
    """One step captured into a CUDA graph over static input buffers.

    ``launches`` is the change of ``kernels.launch_counts`` over the
    capture and ``dtype_launches`` that of the per-instance counts
    (``_build.dtype_launch_counts``); the capture launched nothing, so
    the counters are put back and every replay adds both. A capture
    that fails raises."""

    def __init__(self, fn, args, pool, stream, generators=()):
        self._structure = _structure(args)
        # the whole capture, its input copies and launch-count snapshot
        # included, holds the device gate's exclusive side
        with device_gate.exclusive():
            _warm_blas(stream)
            self._inputs = [t.clone() for t in _leaves(args, [])]
            static_args = _rebuild(args, iter(self._inputs))
            before = _build.snapshot_launch_counts()
            self.graph = torch.cuda.CUDAGraph()
            for g in generators:
                self.graph.register_generator_state(g)
            # no cyclic garbage collection while capturing: a collected
            # graph (an engine and its predictor form a cycle) frees its
            # pool, and a cudaFree inside a capture invalidates it
            gc_was = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(self.graph, pool=pool,
                                      stream=stream):
                    out = fn(*static_args)
            finally:
                if gc_was:
                    gc.enable()
                self.launches, self.dtype_launches, self.route_launches = \
                    _build.launch_counts_since(before)
                _build.restore_launch_counts(before)
        self._out = out
        self._outputs = _leaves(out, [])

    def __call__(self, *args):
        leaves = _leaves(args, [])
        if _structure(args) != self._structure:
            raise RuntimeError("a captured program was called with "
                               "operands of another structure than its "
                               "capture's")
        for dst, src in zip(self._inputs, leaves):
            dst.copy_(src, non_blocking=True)
        self.graph.replay()
        _build.add_launch_counts((self.launches, self.dtype_launches,
                                  self.route_launches))
        return _rebuild(self._out, (t.clone() for t in self._outputs))
