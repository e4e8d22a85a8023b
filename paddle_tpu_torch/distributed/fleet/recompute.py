"""Activation recompute (counterpart of
``paddle_tpu/distributed/fleet/recompute.py``).

``recompute(function, *args)`` runs ``function`` without keeping its
activations and runs it again inside ``backward`` when they are needed:
``torch.utils.checkpoint.checkpoint(use_reentrant=False)``. The
reference gets two things for free from ``jax.checkpoint`` that here
need a context around the second run (``checkpoint``'s ``context_fn``),
because by then the caller's context has moved on:

- the ``amp`` state of the first run (``auto_cast`` has usually exited
  before ``backward``), so the recomputed tensors have the dtypes of the
  first run's;
- with ``preserve_rng_state`` (the default), the port's own random
  streams (``framework.random``: the attention-dropout seeds drawn on the
  host and the per-device elementwise-dropout generators), which
  ``checkpoint`` does not know: they are set back to where the first run
  started, and after the second run to where they were, so the second
  run draws the first run's dropout patterns and the live streams do not
  move. ``checkpoint`` itself saves torch's default generators, except
  while a ``jit.TrainStep`` captures its CUDA graph, where torch refuses
  to read or set a CUDA generator's state (the port draws nothing from
  torch's default generators in a step).

``use_reentrant`` is accepted and ignored: the non-reentrant form is the
only one (it also checks that every recomputed tensor has the first
run's shape and dtype).
"""
from __future__ import annotations

import contextlib

import torch.utils.checkpoint

from ... import amp
from ...framework import random as _random


@contextlib.contextmanager
def _replay(amp_state, rng_state):
    with amp.restored(amp_state):
        if rng_state is None:
            yield
            return
        now = _random.get_rng_state()
        _random.set_rng_state(rng_state)
        try:
            yield
        finally:
            _random.set_rng_state(now)


def recompute(function, *args, **kwargs):
    """``paddle.distributed.fleet.utils.recompute(function, *args)``:
    ``function(*args, **kwargs)``, its activations recomputed in the
    backward instead of kept."""
    kwargs.pop("use_reentrant", None)
    preserve = kwargs.pop("preserve_rng_state", True)
    amp_state = amp.snapshot()
    rng_state = _random.get_rng_state() if preserve else None

    def context_fn():
        return contextlib.nullcontext(), _replay(amp_state, rng_state)
    return torch.utils.checkpoint.checkpoint(
        function, *args, use_reentrant=False,
        preserve_rng_state=preserve and not _random.in_capture(),
        context_fn=context_fn, **kwargs)


def recompute_sequential(ctx, functions, *args, **kwargs):
    """``fleet.utils.recompute_sequential``: ``functions`` in
    ``ctx["segments"]`` segments (1 by default), each recomputed; a
    tuple output feeds the next function as its arguments."""
    segments = ctx.get("segments", 1) if isinstance(ctx, dict) else 1
    funcs = list(functions)
    seg = max(len(funcs) // max(segments, 1), 1)
    out = args
    i = 0
    while i < len(funcs):
        chunk = funcs[i:i + seg]

        def run(*xs, _chunk=chunk):
            y = xs
            for f in _chunk:
                y = f(*y) if isinstance(y, tuple) else f(y)
                y = y if isinstance(y, tuple) else (y,)
            return y if len(y) > 1 else y[0]
        out = recompute(run, *(out if isinstance(out, tuple) else (out,)))
        out = out if isinstance(out, tuple) else (out,)
        i += seg
    return out if len(out) > 1 else out[0]


def recompute_hybrid(ctx, function, *args, **kwargs):
    """``fleet.utils.recompute_hybrid``: on one device, ``recompute``
    (the reference's reduces to it too; its offload knob is ignored)."""
    return recompute(function, *args, **kwargs)
