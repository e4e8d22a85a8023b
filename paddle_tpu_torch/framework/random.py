"""Random state (counterpart of ``paddle_tpu/framework/random.py`` ``seed``
and ``next_key``).

Two streams, both set by :func:`seed`:

- **Attention dropout seeds** come from one host (CPU) ``torch.Generator``:
  each attention call with dropout draws two int32 words
  (:func:`dropout_seeds`), which the flash kernels hash with the element's
  coordinates (``kernels.attention.dropout_keep_mask``). Drawing on the
  host needs no device sync, and the same seed gives the same pattern on
  the card and on the CPU. The kernels read the words from a device int32
  slot (:func:`dropout_seed_slot`): eagerly a new slot written by two
  fills; while a ``jit.TrainStep`` captures its CUDA graph, the next of
  the step's slots, which the step fills before each replay, in the order
  the eager step draws (:func:`capturing`). ``get_rng_state`` carries the
  count of draws, so a recomputed forward takes its first run's slots.
- **Elementwise dropout** (``nn.functional.dropout``) draws its mask with
  ``torch.bernoulli`` on the tensor's device, from one generator per
  device.
- **Generation seeds**: ``generate()`` without a ``seed`` draws the base
  of its sampling keys once on the host (:func:`generation_seed`).

``get_rng_state`` / ``set_rng_state`` save and put back all three
streams (a recomputed forward replays them: ``distributed.fleet.
recompute``). While a step captures, a CUDA generator's state cannot be
read or set (torch refuses both): the captured graph owns the device
streams' offsets, and a put-back there is refused when elementwise
dropout drew in between (a recomputed layer with elementwise dropout
cannot be captured).

``seed(s)`` also calls ``torch.manual_seed(s)``, so that parameters
initialised with torch's default generators (the layers' initializers,
``nn.initializer``, given no generator) are reproducible. The reference's jax keys give
other numbers from the same seed; tests hand both packages the same
seeds or data instead.
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import _disable_current_modes

_INT32_MIN, _INT32_MAX = -2 ** 31, 2 ** 31 - 1
# the attention stream's seed is kept apart from the elementwise one's
_ATTN_SALT = 0x5DEECE66D
_GEN_SALT = 0x2545F491

_seed = 0
_attn = torch.Generator().manual_seed(_seed ^ _ATTN_SALT)
_gen = torch.Generator().manual_seed(_seed ^ _GEN_SALT)
_per_device = {}
_draws = 0            # attention-dropout draws so far (get_rng_state keeps it)
_slots = None         # the capturing step's device slots [n, 2], or None
_dev_draws = {}       # elementwise-dropout draws per device while capturing


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
    # a host draw even inside a trace without data (TrainStep's analyses)
    with _disable_current_modes():
        s = torch.randint(_INT32_MIN, _INT32_MAX, (2,), dtype=torch.int64,
                          generator=_attn).tolist()
    return s[0], s[1]


def slot_of(words, device) -> torch.Tensor:
    """A device int32 [2] slot holding the two int32 ``words``, written by
    two fills (a host-to-device copy of pageable memory would wait for
    the device)."""
    t = torch.empty(2, dtype=torch.int32, device=device)
    t[0].fill_(int(words[0]))
    t[1].fill_(int(words[1]))
    return t


def dropout_seed_slot(device) -> torch.Tensor:
    """The slot of one attention call's dropout seeds: eagerly, two words
    from :func:`dropout_seeds` in a new slot on ``device``; while a step
    captures, the next of its slots (the words are drawn before each
    replay, in this order)."""
    global _draws
    i = _draws
    _draws += 1
    if _slots is None:
        return slot_of(dropout_seeds(), device)
    if i >= _slots.shape[0]:
        raise RuntimeError(
            f"the captured step draws more attention-dropout seeds than "
            f"its eager run ({_slots.shape[0]})")
    return _slots[i]


def dropout_words(n) -> list:
    """The words of the next ``n`` attention calls, drawn as those calls
    would draw them eagerly (a replayed step's slots)."""
    global _draws
    words = [dropout_seeds() for _ in range(n)]
    _draws += n
    return words


def in_capture() -> bool:
    """True while a step captures its CUDA graph (:func:`capturing`)."""
    return _slots is not None


def attention_draws() -> int:
    """The count of attention-dropout draws so far (a recomputed forward,
    which puts the count back, draws its first run's again)."""
    return _draws


@contextlib.contextmanager
def capturing(slots):
    """Run a step's capture: attention calls take ``slots`` (int32 [n, 2]
    on the device) in draw order, draws count from 0, and the host streams
    and the draw count are put back afterwards (the capture drew for no
    real step)."""
    global _slots, _draws
    host = (_attn.get_state(), _gen.get_state(), _draws)
    _slots, _draws = slots, 0
    _dev_draws.clear()
    try:
        yield
    finally:
        _slots = None
        _dev_draws.clear()
        _attn.set_state(host[0])
        _gen.set_state(host[1])
        _draws = host[2]


def dropout_generator(device) -> torch.Generator:
    """:func:`device_generator` for one elementwise-dropout draw (counted
    while a step captures: see :func:`set_rng_state`)."""
    g = device_generator(device)
    if _slots is not None:
        _dev_draws[g.device] = _dev_draws.get(g.device, 0) + 1
    return g


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


def _device_state(dev, g):
    # a CUDA generator's state is the captured graph's while a step
    # captures: its draw count stands in for it
    if _slots is not None and dev.type == "cuda":
        return ("captured", _dev_draws.get(dev, 0))
    return g.get_state()


def get_rng_state() -> dict:
    """The state of every stream of this module (not torch's default
    generators), for :func:`set_rng_state`."""
    return {"seed": _seed, "attn": _attn.get_state(),
            "gen": _gen.get_state(), "draws": _draws,
            "devices": {d: _device_state(d, g)
                        for d, g in _per_device.items()}}


def set_rng_state(state: dict):
    """Put back a :func:`get_rng_state`: each stream continues from where
    it was then; a device generator created since starts anew from the
    seed, as it did then."""
    global _seed, _draws
    _seed = state["seed"]
    _attn.set_state(state["attn"])
    _gen.set_state(state["gen"])
    _draws = state.get("draws", _draws)
    for dev in list(_per_device):
        if dev not in state["devices"]:
            del _per_device[dev]
    for dev, st in state["devices"].items():
        if isinstance(st, tuple):
            if st[1] != _dev_draws.get(dev, 0):
                raise NotImplementedError(
                    "a captured step cannot put an elementwise-dropout "
                    "generator back: its graph owns the generator's "
                    "offsets (elementwise dropout inside a recomputed "
                    "layer)")
            continue
        device_generator(dev).set_state(st)
