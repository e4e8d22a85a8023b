"""CUDA-graph capture shared by the AOT engine (``inference/aot``),
``generate()``'s static route (``generation``) and the inference API's
``Predictor`` (``inference/api.py``): the port's counterpart of running
a compiled XLA program.

- ``capture_stream(device)``: the stream every capture on a device runs
  on, its cuBLAS and cuBLASLt workspaces allocated before any capture.
- ``graph_pool(device, owner)``: the graph memory pool an owner's
  programs on a device share.
- ``GraphProgram``: one function captured into a CUDA graph over static
  input buffers; a call copies its operands in, replays, adds the
  launch counts its capture recorded and returns clones of the outputs.
- ``Captured``: a program with the weights it reads by address, for
  the per-signature caches that re-capture when a weight is rebound.
"""
from __future__ import annotations

import gc
import weakref

import torch

from ..kernels import _build

__all__ = ["GraphProgram", "Captured", "capture_stream", "graph_pool"]


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


def capture_stream(device):
    """The stream every capture on ``device`` runs on, its cuBLAS and
    cuBLASLt workspaces allocated before any capture. cuBLAS keeps one
    workspace per (handle, stream); one first allocated during a capture
    would come from that graph's pool, and the workspace cache would
    still hold it after the graph and its pool are freed."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    s = _capture_streams.get(idx)
    if s is None:
        s = torch.cuda.Stream(device)
        s.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(s):
            for dt in (torch.float32, torch.bfloat16):
                a = torch.ones(64, 64, device=device, dtype=dt)
                torch.mm(a, a)
                torch.nn.functional.linear(a, a, a[0])
        torch.cuda.current_stream(device).wait_stream(s)
        _capture_streams[idx] = s
    return s


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

    def __init__(self, fn, args, pool, stream):
        self._structure = _structure(args)
        self._inputs = [t.clone() for t in _leaves(args, [])]
        static_args = _rebuild(args, iter(self._inputs))
        before = _build.snapshot_launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        # no cyclic garbage collection while capturing: a collected graph
        # (an engine and its predictor form a cycle) frees its pool, and a
        # cudaFree inside a capture invalidates the capture
        gc_was = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, pool=pool, stream=stream):
                out = fn(*static_args)
        finally:
            if gc_was:
                gc.enable()
            self.launches, self.dtype_launches = \
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
        _build.add_launch_counts((self.launches, self.dtype_launches))
        return _rebuild(self._out, (t.clone() for t in self._outputs))
