"""Random state (counterpart of ``paddle_tpu/framework/random.py`` ``seed``
and ``next_key``).

Two streams, both set by :func:`seed`:

- **Attention dropout seeds** come from one host (CPU) ``torch.Generator``:
  each attention call with dropout draws two int32 words
  (:func:`dropout_seeds`), which the flash kernels hash with the element's
  coordinates (``kernels.attention.dropout_keep_mask``). Drawing on the
  host needs no device sync, and the same seed gives the same pattern on
  the card and on the CPU.
- **Elementwise dropout** (``nn.functional.dropout``) draws its mask with
  ``torch.bernoulli`` on the tensor's device, from one generator per
  device.
- **Generation seeds**: ``generate()`` without a ``seed`` draws the base
  of its sampling keys once on the host (:func:`generation_seed`).

``get_rng_state`` / ``set_rng_state`` save and put back all three
streams (a recomputed forward replays them: ``distributed.fleet.
recompute``).

``seed(s)`` also calls ``torch.manual_seed(s)``, so that parameters
initialised with torch's default generators (the layers' initializers,
``nn.initializer``, given no generator) are reproducible. The reference's jax keys give
other numbers from the same seed; tests hand both packages the same
seeds or data instead.
"""
from __future__ import annotations

import torch

_INT32_MIN, _INT32_MAX = -2 ** 31, 2 ** 31 - 1
# the attention stream's seed is kept apart from the elementwise one's
_ATTN_SALT = 0x5DEECE66D
_GEN_SALT = 0x2545F491

_seed = 0
_attn = torch.Generator().manual_seed(_seed ^ _ATTN_SALT)
_gen = torch.Generator().manual_seed(_seed ^ _GEN_SALT)
_per_device = {}


def seed(s: int):
    """``paddle.seed``: reset every stream of this module and torch's
    default generators to ``s``."""
    global _seed
    _seed = int(s)
    torch.manual_seed(_seed)
    _attn.manual_seed(_seed ^ _ATTN_SALT)
    _gen.manual_seed(_seed ^ _GEN_SALT)
    _per_device.clear()


def dropout_seeds() -> tuple:
    """Two int32 words in [int32 min, int32 max) for one attention call's
    dropout pattern, drawn on the host from the attention stream."""
    s = torch.randint(_INT32_MIN, _INT32_MAX, (2,), dtype=torch.int64,
                      generator=_attn)
    return int(s[0]), int(s[1])


def generation_seed() -> int:
    """One int in [0, 2^31 - 1) from the generation stream: the base seed
    of a ``generate()`` call given no ``seed``."""
    return int(torch.randint(0, _INT32_MAX, (1,), dtype=torch.int64,
                             generator=_gen))


def device_generator(device) -> torch.Generator:
    """The elementwise-dropout generator of ``device``, created (seeded
    from the current seed) at first use."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    g = _per_device.get(dev)
    if g is None:
        g = _per_device[dev] = torch.Generator(device=dev).manual_seed(_seed)
    return g


def get_rng_state() -> dict:
    """The state of every stream of this module (not torch's default
    generators), for :func:`set_rng_state`."""
    return {"seed": _seed, "attn": _attn.get_state(),
            "gen": _gen.get_state(),
            "devices": {d: g.get_state() for d, g in _per_device.items()}}


def set_rng_state(state: dict):
    """Put back a :func:`get_rng_state`: each stream continues from where
    it was then; a device generator created since starts anew from the
    seed, as it did then."""
    global _seed
    _seed = state["seed"]
    _attn.set_state(state["attn"])
    _gen.set_state(state["gen"])
    for dev in list(_per_device):
        if dev not in state["devices"]:
            del _per_device[dev]
    for dev, st in state["devices"].items():
        device_generator(dev).set_state(st)
