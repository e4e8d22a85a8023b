"""Counter-based random draws for on-device sampling: the CUDA kernel
``csrc/sampling.cu`` (``categorical_rows``, ``uniform64_rows``) and its
plain PyTorch version (counterpart of what
``paddle_tpu/generation/sampling.py`` ``sample_tokens`` / ``verify_spans``
leave to XLA: ``jax.random.fold_in``, ``categorical`` and ``uniform``;
there is no Pallas kernel).

The plain version reproduces jax's threefry stream bit for bit, as jax
0.9.0 computes it with ``jax_threefry_partitionable`` (its default):

- ``key(seed)`` is the word pair ``[0, seed]`` (a uint32 seed; an int32
  seed wraps);
- ``fold_in(key, c)`` is ``threefry2x32(key, [0, c])``;
- ``random_bits(key, shape)``: element i, its flat index split into
  ``(hi, lo)`` 32-bit words, is ``x0 ^ x1`` of ``threefry2x32(key, (hi,
  lo))`` (32 bits) or ``(x0 << 32) | x1`` (64 bits), so every element is
  independent of the others;
- ``uniform`` puts the top mantissa bits under the exponent of 1.0 and
  subtracts 1, then scales to ``[minval, maxval)`` and floors at minval;
- ``gumbel`` is ``-log(-log(uniform(minval=tiny, maxval=1)))``;
- ``categorical(key, l)`` is ``argmax(l + gumbel(key, l.shape))``, ties
  to the lowest index.

Words live in int64 tensors masked to 32 bits; every draw comes from an
explicit seed, with no global generator.

The wrappers take one key per row, ``fold_in(key(seed), counter)`` and
then ``fold_in(·, offset)`` where an offset is given, and draw over the
row alone: the reference ``vmap``s every draw per row, so the flat index
of an element is its column within its row. A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import check, count_launch, load, stream_ptr

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_F32_TINY = torch.finfo(torch.float32).tiny


# ------------------------------------------------------------ plain version

def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds on 32-bit words held in int64
    tensors (broadcast together). Returns the pair (y0, y1)."""
    ks = (k0 & _M32, k1 & _M32, (k0 ^ k1 ^ 0x1BD11BDA) & _M32)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def _word(v, device=None):
    return torch.as_tensor(v, dtype=torch.int64, device=device) & _M32


def key(seed):
    """``jax.random.key(seed)`` as its two words ``(0, seed)``; ``seed``
    an int or an int tensor (taken modulo 2^32, as a uint32 cast)."""
    s = _word(seed)
    return torch.zeros_like(s), s


def fold_in(k, c):
    """``jax.random.fold_in``: the key ``threefry2x32(k, (0, c))``."""
    c = _word(c, k[0].device)
    return threefry2x32(k[0], k[1], torch.zeros_like(c), c)


def _flat_index(shape, device):
    n = 1
    for d in shape:
        n *= int(d)
    i = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return i >> 32, i & _M32


def random_bits(k, shape, bits=32):
    """``jax.random.bits`` of one key over ``shape``: 32-bit words (or
    the int64 bit patterns of 64-bit words with ``bits=64``) in int64."""
    hi, lo = _flat_index(tuple(shape), k[0].device)
    y0, y1 = threefry2x32(k[0], k[1], hi, lo)
    if bits == 64:
        return (y0 << 32) | y1
    return y0 ^ y1


def _unit_f32(bits):
    """[0, 1) f32 from 32-bit words: the top 23 bits as the mantissa of
    a number in [1, 2), minus 1."""
    f = (bits >> 9) | 0x3F800000
    f = (f - ((f >> 31) << 32)).to(torch.int32)      # the int32 pattern
    return f.view(torch.float32) - 1.0


def _unit_f64(bits):
    """[0, 1) f64 from 64-bit words (int64 patterns), likewise."""
    f = ((bits >> 12) & ((1 << 52) - 1)) | 0x3FF0000000000000
    return f.view(torch.float64) - 1.0


def _scaled(f, minval, maxval):
    lo = torch.tensor(minval, dtype=f.dtype, device=f.device)
    hi = torch.tensor(maxval, dtype=f.dtype, device=f.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


def uniform(k, shape=(), dtype=torch.float32, minval=0.0, maxval=1.0):
    """``jax.random.uniform`` of one key over ``shape``, f32 or f64."""
    if dtype == torch.float64:
        f = _unit_f64(random_bits(k, shape, 64))
    else:
        f = _unit_f32(random_bits(k, shape))
    return _scaled(f, minval, maxval)


def _gumbel_from_bits(bits):
    u = _scaled(_unit_f32(bits), _F32_TINY, 1.0)
    return -torch.log(-torch.log(u))


def gumbel(k, shape):
    """``jax.random.gumbel`` (mode "low") of one key over ``shape``, f32."""
    return _gumbel_from_bits(random_bits(k, shape))


def categorical(k, logits):
    """``jax.random.categorical`` of one key over a [V] row of f32
    logits: ``argmax(logits + gumbel)``, ties to the lowest index."""
    return torch.argmax(logits + gumbel(k, logits.shape), dim=-1)


def row_keys(seed, counter, offset=None):
    """[N] keys ``fold_in(key(seed), counter)``, then folded with
    ``offset`` where given: the per-row key stream of every draw."""
    k = fold_in(key(seed), counter)
    if offset is not None:
        k = fold_in(k, offset)
    return k


def as_words(x, device=None):
    """Ints (python, numpy or a tensor) as an int32 tensor holding their
    low 32 bits, the layout the kernel takes; int32 tensors pass as they
    are."""
    t = torch.as_tensor(x, device=device)
    if t.dtype == torch.int32:
        return t
    t = t.to(torch.int64) & _M32
    return (t - ((t >> 31) << 32)).to(torch.int32)


def categorical_rows_plain(logits, seed, counter, offset=None):
    """One draw per row of f32 ``logits`` [N, V] with the row's own key:
    the Gumbel noise of row n over its V columns (flat index = column,
    as the reference's per-row ``vmap`` draws), argmax. [N] int32."""
    dev = logits.device
    k0, k1 = row_keys(as_words(seed, dev), as_words(counter, dev),
                      None if offset is None else as_words(offset, dev))
    hi, lo = _flat_index((logits.shape[1],), logits.device)
    y0, y1 = threefry2x32(k0[:, None], k1[:, None], hi[None], lo[None])
    g = _gumbel_from_bits(y0 ^ y1)
    return torch.argmax(logits + g, dim=-1).to(torch.int32)


def uniform64_rows_plain(seed, counter, offset=None):
    """One f64 ``uniform`` per row (shape (), so element 0 under the
    row's key): [N] float64."""
    k0, k1 = row_keys(seed, counter, offset)
    z = torch.zeros_like(k0)
    y0, y1 = threefry2x32(k0, k1, z, z)
    return _scaled(_unit_f64((y0 << 32) | y1), 0.0, 1.0)


# ------------------------------------------------------------------ kernel

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # logits, seed, counter, offset (or null), out, rows, vocab, stream
    "categorical_rows": [_P, _P, _P, _P, _P, _I, _I, _P],
    # seed, counter, offset (or null), out, rows, stream
    "uniform64_rows": [_P, _P, _P, _P, _I, _P],
}


def _int_rows(t, n, dev, what):
    """An int32 [n] operand on ``dev`` (a uint32 word's bits)."""
    t = as_words(t, dev)
    if t.shape != (n,):
        raise ValueError(f"{what}: expected shape ({n},), got "
                         f"{tuple(t.shape)}")
    return t.contiguous()


def categorical_rows_kernel(logits, seed, counter, offset=None):
    if logits.dtype != torch.float32 or logits.dim() != 2:
        raise ValueError("categorical_rows: logits must be f32 [N, V], got "
                         f"{logits.dtype} {tuple(logits.shape)}")
    dev = logits.device
    n, v = logits.shape
    logits = logits.contiguous()
    seed = _int_rows(seed, n, dev, "seed")
    counter = _int_rows(counter, n, dev, "counter")
    offset = None if offset is None else _int_rows(offset, n, dev, "offset")
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    lib = load("sampling", _SIGNATURES)
    err = lib.categorical_rows(
        logits.data_ptr(), seed.data_ptr(), counter.data_ptr(),
        None if offset is None else offset.data_ptr(), out.data_ptr(), n, v,
        stream_ptr(dev))
    check(err, "categorical_rows")
    count_launch("categorical_rows")
    return out


def uniform64_rows_kernel(seed, counter, offset=None):
    seed = torch.as_tensor(seed)
    dev = seed.device
    n = seed.shape[0]
    seed = _int_rows(seed, n, dev, "seed")
    counter = _int_rows(counter, n, dev, "counter")
    offset = None if offset is None else _int_rows(offset, n, dev, "offset")
    out = torch.empty(n, dtype=torch.float64, device=dev)
    if n == 0:
        return out
    lib = load("sampling", _SIGNATURES)
    err = lib.uniform64_rows(
        seed.data_ptr(), counter.data_ptr(),
        None if offset is None else offset.data_ptr(), out.data_ptr(), n,
        stream_ptr(dev))
    check(err, "uniform64_rows")
    count_launch("uniform64_rows")
    return out


def categorical_rows(logits, seed, counter, offset=None):
    """One categorical draw per row of f32 ``logits`` [N, V] with the key
    ``fold_in(fold_in(key(seed), counter), offset)`` (no second fold
    without ``offset``); ``seed``/``counter``/``offset`` [N] ints on the
    logits' device. Returns [N] int32. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises."""
    if logits.device.type == "cpu":
        return categorical_rows_plain(logits, seed, counter, offset)
    return categorical_rows_kernel(logits, seed, counter, offset)


def uniform64_rows(seed, counter, offset=None):
    """One f64 uniform in [0, 1) per row, keyed like
    ``categorical_rows``: [N] float64 on ``seed``'s device. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or
    raises."""
    if torch.as_tensor(seed).device.type == "cpu":
        return uniform64_rows_plain(seed, counter, offset)
    return uniform64_rows_kernel(seed, counter, offset)
