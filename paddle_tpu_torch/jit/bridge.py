"""The train step (counterpart of ``paddle_tpu/jit/bridge.py``
``TrainStep``).

The reference compiles forward, loss, ``jax.value_and_grad``, clipping
and the optimizer update into one XLA program per batch signature. Here
the same sequence is forward, loss, ``backward``, then the clip and the
update as the fused multi-tensor step (``optimizer/fused.py``: on the
card the ``grad_sq_norm`` and ``fused_update`` kernels, the counterpart
of the update inside the reference's program), or, where the reference's
eligibility refuses a plan or ``FLAGS_fused_optimizer`` is off, the
optimizer's gradient clip and ``Optimizer.apply_gradients`` (updating the
state in place). The clip ignores ``need_clip`` on both, as the
reference's ``_clip_grads_functional`` does, and
``apply_decay_param_fun`` sees the model's parameter names. With
``FLAGS_anomaly_guard`` (read when the step is built, as the reference
reads it at trace time) a non-finite loss leaves the parameters, master
weights, moments and step counters at their pre-step values: a device
predicate the kernel reads (a select on the per-parameter path); the
host never waits for the loss.

On a CUDA device each batch signature (the reference's key: every
input's shape and dtype name) runs as one CUDA graph, the counterpart of
the reference's one ``jax.jit`` program a signature. The first call of a
signature runs the step eagerly on the capture stream (the real step of
that call: it also allocates what the capture will), then captures it
into a graph pool of the step's own; later calls copy the
batch into the graph's static inputs, refill the learning rate, the
loss-scaler state when it changed on the host and the attention-dropout
seed slots (drawn on the host in the eager order, one copy from pinned
memory), replay, and return a clone of the loss. The elementwise-dropout
generator is registered with the graph, so a replay advances it as the
eager step does. Launch and dispatch counts are added per replay. A
signature is captured again when something its graph reads by address
was rebound (a parameter, buffer, optimizer-state tensor or the
learning-rate operand), the optimizer's state generation, clip or the
fused-optimizer flag changed, or the model's mode, the amp state or the
dropout generator did; a load in place replays. A capture that fails
raises: there is no eager fallback. On the CPU the step runs eagerly.

Buffers a training forward writes in place (BatchNorm's running
``_mean`` / ``_variance``) are read and written by address like the
parameters: the eager run of a signature's first call updates them once,
the capture does not run, and every replay updates them again, so N
calls advance them N times, as N eager steps do. cuDNN may pick
nondeterministic convolution algorithms; whether a replay is bitwise the
eager step then rests on ``torch.backends.cudnn.deterministic``, which
the package leaves to the caller.

With ``scaler`` (an enabled ``amp.GradScaler``; a disabled one is
ignored, as the reference ignores it) the step runs the reference's
compiled dynamic loss scaling: ``backward`` of the loss times the scale
(multiplied in f32), the gradients unscaled before the clip, found-inf
(some unscaled gradient not finite) ORed into that same predicate, so a
step with an overflow changes no parameter, master weight, moment or
step counter, and the scale and its counters adapted by selects on the
device, in the step's own device tensors (the scaler's ``_dev_state``).
The scaler reads them back only when a value is asked for, so the host
never waits for found-inf either. The guard still looks at the unscaled
loss.

``cost_analysis`` and ``memory_analysis`` read one whole step without
running it, as the reference's read its lowered program: forward and
backward are traced under ``FakeTensorMode`` (the kernels give their
outputs' shapes through their ops' fake implementations) with
``torch.utils.flop_counter``; nothing real is read or written, and the
random streams and launch counters are put back.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import weakref
from typing import Callable

import torch

from .. import amp
from ..amp.grad_scaler import (device_adapt, device_unscale,
                               new_scaler_state, scaler_state_in)
from ..framework import random as _random
from ..framework.flags import flag_value
from ..framework.graphs import Captured
from ..kernels import _build
from ..optimizer.fused import _count_dispatch, fused_plan


def batch_signature(batch) -> tuple:
    """The reference's per-signature key (``_ensure_compiled``): each
    input's shape and dtype name, as ``((2, 16), "int64")``."""
    return tuple((tuple(x.shape), str(x.dtype).rsplit(".", 1)[-1])
                 for x in batch)


@dataclasses.dataclass
class CompiledMemoryStats:
    """The fields of the reference's ``memory_analysis()`` (XLA's
    ``CompiledMemoryStats``), in bytes. ``argument``: what the step reads
    (parameters, buffers, optimizer state, batch, learning rate and
    scaler state); ``output``: the loss and the state it updates, all of
    it in place (``alias``); ``temp``: the high-water mark of the other
    storage live during forward and backward (activations, gradients,
    temporaries); ``peak_memory``: argument plus temp. No code is
    generated and nothing lives on the host."""
    generated_code_size_in_bytes: int = 0
    argument_size_in_bytes: int = 0
    output_size_in_bytes: int = 0
    alias_size_in_bytes: int = 0
    temp_size_in_bytes: int = 0
    host_generated_code_size_in_bytes: int = 0
    host_argument_size_in_bytes: int = 0
    host_output_size_in_bytes: int = 0
    host_alias_size_in_bytes: int = 0
    host_temp_size_in_bytes: int = 0
    peak_memory_in_bytes: int = 0


def _storage_bytes(tensors) -> int:
    """Bytes of the distinct storages under ``tensors``."""
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


class _LiveBytes(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the storage that ops create while it is on, and its
    high-water mark: a storage counts from the op that made it to its
    last reference (storages of the marked arguments never count)."""

    def __init__(self, args):
        super().__init__()
        self.live = self.peak = 0
        for t in args:
            t.untyped_storage()._live_counted = True

    def _free(self, n):
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                if not getattr(st, "_live_counted", False):
                    st._live_counted = True
                    n = st.nbytes()
                    self.live += n
                    self.peak = max(self.peak, self.live)
                    weakref.finalize(st, self._free, n)
        return out


@contextlib.contextmanager
def faked(model, mode, extra=()):
    """``model``'s parameters and buffers replaced by fakes of ``mode`` (a
    ``FakeTensorMode``) while the block runs; yields {id(real tensor):
    fake} over them and ``extra``. Parameter subclasses must not reach a
    fake op as they are (some torch versions refuse them)."""
    tensors = [*model.parameters(), *model.buffers(), *extra]
    fakes = {id(t): mode.from_tensor(t) for t in tensors}
    saved = []
    for m in model.modules():
        for table in (m._parameters, m._buffers):
            for k, t in table.items():
                if t is not None and id(t) in fakes:
                    saved.append((table, k, t))
                    table[k] = fakes[id(t)]
    try:
        yield fakes
    finally:
        for table, k, t in saved:
            table[k] = t


class _StepGraph(Captured):
    """One signature's captured step: the program and what it reads by
    address (``Captured``), the state it was captured under, the
    gradients it writes, its seed slots, its dispatch and its plan."""

    def __init__(self, program, baked, key, grads, slots, dispatch, plan):
        super().__init__(program, baked)
        self.key = key
        self.grads = grads
        self.slots = slots
        self.dispatch = dispatch
        self.plan = plan

    def current(self, baked, key):
        return key == self.key and self.reads(baked)

    def fill_seeds(self):
        """Draw this replay's attention-dropout words on the host, in the
        eager step's order, and copy them into the slots at once (a fresh
        pinned buffer: the caching host allocator keeps it until the copy
        has run)."""
        n = self.slots.shape[0]
        if not n:
            return
        host = torch.tensor(_random.dropout_words(n), dtype=torch.int32,
                            pin_memory=True)
        self.slots.copy_(host, non_blocking=True)


class TrainStep:
    """Call with the batch tensors; returns the (detached) loss tensor.

    ``loss_fn(*model_outputs, *labels)`` gives a scalar; the first
    ``n_model_inputs`` batch entries feed the model, the rest feed
    ``loss_fn``. Inputs that are not tensors (numpy arrays) are moved to
    the device of the model's first parameter. After a call each
    parameter's ``.grad`` holds its unclipped gradient of that step
    (unscaled, with a ``scaler``). ``graph_stats`` counts captures,
    replays, re-captures and the capture seconds (all 0 on the CPU).

    ``donate_state`` is taken in the reference's place and changes
    nothing: the reference donates the parameter and optimizer buffers to
    its compiled program, while here the update already runs in place and
    torch has no buffer donation.
    """

    def __init__(self, model, optimizer, loss_fn: Callable,
                 n_model_inputs: int = 1, donate_state: bool = True,
                 scaler=None):
        self._model = model
        self._opt = optimizer
        self._loss_fn = loss_fn
        self._n_in = n_model_inputs
        self._scaler = scaler if (scaler is not None
                                  and scaler.is_enable()) else None
        named = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
        self._p = [p for _, p in named]
        self._p_names = [n for n, _ in named]
        self._guard = bool(flag_value("anomaly_guard"))
        self._device = self._p[0].device if self._p else torch.device("cpu")
        for p in self._p:                 # state exists from the start,
            optimizer._state_of(p)        # as the reference's _fn_init_all
        self._plan = None                 # the fused plan, once built
        self._sc_state = (new_scaler_state(self._device)
                          if self._scaler is not None else None)
        self._graphs = {}                 # batch signature -> _StepGraph
        self._pool = None                 # their graph memory pool
        self._analysis = {}               # batch signature -> trace result
        self.graph_stats = {"captures": 0, "replays": 0, "recaptures": 0,
                            "capture_s": 0.0}

    @property
    def opt_state(self):
        """Per-parameter optimizer state, in the step's parameter order."""
        return [self._opt._state_of(p) for p in self._p]

    def _to_device(self, x):
        if isinstance(x, torch.Tensor):
            return x.to(self._device)
        return torch.as_tensor(x, device=self._device)

    # ------------------------------------------------------------ the step --
    def _step(self, batch, lr, decide_plan=True):
        """Forward, backward, clip and update on ``batch`` at the f32
        device scalar ``lr``: the eager step and the body of its capture
        (``decide_plan=False`` keeps the eager run's fused-plan decision:
        deciding may read the device). Returns (detached loss, (updates
        dispatched, path)) and counts nothing."""
        for p in self._p:
            p.grad = None
        outs = self._model(*batch[:self._n_in])
        outs = outs if isinstance(outs, tuple) else (outs,)
        loss = self._loss_fn(*outs, *batch[self._n_in:])
        sc_state = self._sc_state
        if self._scaler is None:
            loss.backward()
        else:
            (loss.float() * sc_state[0]).backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self._p]
        bad = ~torch.isfinite(loss.detach()) if self._guard else None
        if self._scaler is not None:
            found_inf = device_unscale(grads, sc_state[0])
            bad = found_inf if bad is None else bad | found_inf
            with torch.no_grad():
                for t, v in zip(sc_state, device_adapt(
                        self._scaler, found_inf, sc_state)):
                    t.copy_(v)
        if decide_plan:
            self._plan = fused_plan(
                self._opt, self._p, grads, self._p_names, self._plan,
                honour_need_clip=False) if flag_value("fused_optimizer") \
                else None
        if self._plan is not None:
            self._plan.run(grads, lr, bad)
            return loss.detach(), (1, "fused")
        clip = self._opt._grad_clip
        if clip is not None:
            grads = clip.clip_grads(grads)
        self._opt.apply_gradients(self._p, grads, lr, self._p_names, bad,
                                  in_place=True)
        return loss.detach(), (len(self._p), "per_param")

    def _operands(self):
        """The learning rate and the scaler state for the next step,
        written outside any graph (fills)."""
        lr = self._opt._lr_operand(self._device)
        if self._scaler is not None:
            scaler_state_in(self._scaler, self._sc_state)
        return lr

    def __call__(self, *batch):
        if self._device.type != "cuda":
            return self._eager(*batch)
        batch = [self._to_device(x) for x in batch]
        return self._graph_call(batch, self._operands())

    def _eager(self, *batch):
        """One step run op by op: the CPU's step, and on the card the
        yardstick its captured graphs are held to."""
        batch = [self._to_device(x) for x in batch]
        loss, dispatch = self._step(batch, self._operands())
        _count_dispatch(*dispatch)
        return loss

    # ---------------------------------------------------------- the graphs --
    def _baked(self, lr):
        """The tensors a captured step reads by address: parameters,
        buffers, every optimizer-state tensor and the learning-rate
        operand ``lr``."""
        states = [t for p in self._p
                  for _, t in sorted(self._opt._state_of(p).items())]
        return [*self._p, *self._model.buffers(), *states, lr]

    def _key(self):
        """What a captured step was traced under besides its tensors."""
        clip = self._opt._grad_clip
        return (self._opt._state_gen, type(clip).__name__,
                getattr(clip, "clip_norm", None), getattr(clip, "min", None),
                getattr(clip, "max", None),
                bool(flag_value("fused_optimizer")), self._model.training,
                repr(amp.snapshot()), _random.device_generator(self._device))

    def _graph_call(self, batch, lr):
        sig = batch_signature(batch)
        entry = self._graphs.get(sig)
        baked, key = self._baked(lr), self._key()
        if entry is not None and not entry.current(baked, key):
            # the graph would read old storage or replay an old decision
            del self._graphs[sig]
            entry = None
            self.graph_stats["recaptures"] += 1
        if entry is None:
            return self._capture(sig, batch, lr)
        entry.fill_seeds()
        (loss,) = entry.program(*batch)
        for p, g in zip(self._p, entry.grads):
            p.grad = g
        if entry.plan is not None:
            entry.plan.n_calls += 1
        _count_dispatch(*entry.dispatch)
        self.graph_stats["replays"] += 1
        return loss

    def _capture(self, sig, batch, lr):
        from ..framework.graphs import (GraphProgram, capture_stream,
                                        run_on_capture_stream)
        dev = self._device
        gen = _random.device_generator(dev)
        draws = _random.attention_draws()
        loss, dispatch = run_on_capture_stream(dev, self._step, batch, lr)
        _count_dispatch(*dispatch)
        slots = torch.empty((_random.attention_draws() - draws, 2),
                            dtype=torch.int32, device=dev)
        eager_grads = [p.grad for p in self._p]
        calls = self._plan.n_calls if self._plan is not None else 0

        def body(*b):
            with _random.capturing(slots):
                return (self._step(list(b), lr, decide_plan=False)[0],)

        t0 = time.perf_counter()
        if self._pool is None:
            # a pool of the step's own, freed with it (a pool's memory goes
            # back to the allocator once every graph captured into it is)
            self._pool = torch.cuda.graph_pool_handle()
        program = GraphProgram(body, tuple(batch), self._pool,
                               capture_stream(dev), generators=(gen,))
        self.graph_stats["capture_s"] += time.perf_counter() - t0
        self.graph_stats["captures"] += 1
        graph_grads = [p.grad for p in self._p]
        for p, g in zip(self._p, eager_grads):
            p.grad = g
        if self._plan is not None:
            self._plan.n_calls = calls
        self._graphs[sig] = _StepGraph(program, self._baked(lr), self._key(),
                                       graph_grads, slots, dispatch,
                                       self._plan)
        return loss

    # ----------------------------------------------------- the analyses --
    def _trace(self, batch):
        """Forward and backward of one step on ``batch`` without data:
        ``{"flops": ..., "argument": ..., "temp": ..., "state": ...,
        "loss": ...}`` (bytes), cached per signature."""
        from torch._subclasses.fake_tensor import FakeTensorMode
        from torch.utils.flop_counter import FlopCounterMode
        batch = [x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
                 for x in batch]
        sig = batch_signature(batch)
        if sig in self._analysis:
            return self._analysis[sig]
        model = self._model
        params = list(model.parameters())
        buffers = list(model.buffers())
        states = [t for p in self._p
                  for _, t in sorted(self._opt._state_of(p).items())]
        scaler = list(self._sc_state) if self._scaler is not None else []
        rng = _random.get_rng_state()
        counts = _build.snapshot_launch_counts()
        try:
            # the model's parameters and buffers are fakes for the trace
            # (other tensors it meets are made fake as they come), and so
            # are the gradients. Two passes: the flop counter's module
            # tracking keeps tensors alive
            with FakeTensorMode(allow_non_fake_inputs=True) as mode, \
                    faked(model, mode, scaler) as fakes:
                fbatch = [torch.empty_like(x, device=self._device)
                          for x in batch]
                fscaler = [fakes[id(t)] for t in scaler]
                leaves = [fakes[id(p)] for p in self._p]
                with FlopCounterMode(display=False) as flops:
                    self._fake_step(fbatch, leaves, fscaler)
                with _LiveBytes([*fakes.values(), *fbatch]) as live:
                    loss_bytes = self._fake_step(fbatch, leaves, fscaler)
        finally:
            _random.set_rng_state(rng)
            _build.restore_launch_counts(counts)
        temp = live.peak
        state = _storage_bytes([*params, *buffers, *states, *scaler])
        res = {"flops": float(flops.get_total_flops()), "temp": temp,
               "state": state, "loss": loss_bytes,
               # and the f32 learning rate
               "argument": state + _storage_bytes(batch) + 4}
        self._analysis[sig] = res
        return res

    def _fake_step(self, batch, leaves, scaler):
        """Forward and backward on fake tensors; the loss's bytes."""
        outs = self._model(*batch[:self._n_in])
        outs = outs if isinstance(outs, tuple) else (outs,)
        loss = self._loss_fn(*outs, *batch[self._n_in:])
        scaled = loss if not scaler else loss.float() * scaler[0]
        torch.autograd.grad(scaled, leaves, allow_unused=True)
        return loss.untyped_storage().nbytes()

    def cost_analysis(self, *batch):
        """``{"flops": ...}`` for one whole step on a batch of this
        signature, without running it: 2 FLOPs per multiply-add of every
        matrix product and convolution of forward and backward (each
        convolution's input and weight gradients), the attention products
        in full (Q K^T and P V at Sq x Sk, the backward's five), as the
        defensible numerator of MFU. Elementwise work (XLA counts it) and
        the optimizer update are not counted. Changes no parameter,
        optimizer state, random stream or launch counter."""
        return {"flops": self._trace(batch)["flops"]}

    def memory_analysis(self, *batch):
        """:class:`CompiledMemoryStats` of one step on a batch of this
        signature, from the same trace (the same definition on the CPU
        and the card; the optimizer's in-place update adds no storage)."""
        t = self._trace(batch)
        return CompiledMemoryStats(
            argument_size_in_bytes=t["argument"],
            output_size_in_bytes=t["loss"] + t["state"],
            alias_size_in_bytes=t["state"],
            temp_size_in_bytes=t["temp"],
            peak_memory_in_bytes=t["argument"] + t["temp"])

