"""Flash attention: the CUDA kernels ``csrc/flash_fwd.cu`` (forward) and
``csrc/flash_bwd.cu`` (backward: dK/dV and dQ), their plain PyTorch
versions, the counter-hash attention dropout and the ``[B, S, H, D]``
entry ``flash_attention_bshd`` (counterpart of
``paddle_tpu/kernels/attention.py`` ``_fmix32`` / ``dropout_keep_mask`` /
``_fwd_kernel`` / ``_bwd_dkdv_kernel`` / ``_bwd_dq_kernel`` /
``_flash_bwd_pallas`` / ``_gen_reference`` / ``flash_attention_bshd``).

``flash_attention_bshd`` goes through ``_FlashAttention``, an autograd
Function that saves ``(q, k, v, out, lse)`` and recomputes the
probabilities from ``lse`` in the backward, as the reference's
custom_vjp does, when a gradient is needed or dropout is on. The
inference entry (no gradient, no dropout) is the custom op
``paddle_tpu_torch::flash_fwd`` (``_ops.define_op``: the plain version on
the CPU, the kernel wrapper on CUDA, a fake for traces), so that
``torch.export`` captures a forward that launches the kernel.

Dropout follows the reference's kernel path on every device: element
(b, h, q, k) is kept iff ``dropout_keep_mask`` says so for row b*H + h
(the query head) and the absolute positions q and k, with two int32
seeds drawn on the host per call (``framework.random.dropout_seeds``)
and handed to the kernels in a device int32 [2] slot
(``framework.random.dropout_seed_slot``), which they read: a captured
train step refills its slots before each replay. The plain versions take
the same slot (or the two words).
The normaliser and lse use the probabilities P before dropout;
``O = (P*D) V`` with ``D = keep / (1 - p)``, and the backward regenerates
the same pattern: ``dV = (P*D)^T dO``, ``dS = P * (dP*D - delta)``.
"""
from __future__ import annotations

import ctypes
import math

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.utils.flop_counter import register_flop_formula

from ..amp import cast_inputs
from ..framework import random as _random
from ._build import (NEG_INF, check, count_launch, count_route, load,
                     stream_ptr)
from ._ops import define_op

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the backward kernels' dtypes (one for q, k, v and dout)
_BWD_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_HEAD_DIMS = (64, 128)
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_DIMS = [_I, _I, _I, _I, _I,                # B, Sq, Sk, H, Hkv
         _LL, _LL, _LL, _LL,                # mask strides
         ctypes.c_float, _I,                # scale, causal
         _P, ctypes.c_uint, ctypes.c_float,  # seed slot, thresh, dscale
         _P]                                # stream
_SIGNATURES = {"flash_fwd": [
    _I, _I, _I,                             # dtype, kv_dtype, head_dim
    _P, _P, _P, _P, _P, _P, _P,             # pointers
    *_DIMS]}
_BWD_SIGNATURES = {
    # dtype, head_dim, q, k, v, dout, lse, delta, mask, kv_lens, dk, dv
    "flash_bwd_dkdv": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                       *_DIMS],
    # dtype, head_dim, q, k, v, dout, lse, delta, mask, kv_lens, dq
    "flash_bwd_dq": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, *_DIMS]}

_M32 = 0xFFFFFFFF


def _mul32(x, c):
    """(x * c) mod 2^32 for x in [0, 2^32) held in int64 (or a Python
    int): c is split into 16-bit halves so no product passes 2^49."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def fmix32(x):
    """murmur3's finalizer on uint32 words held in int64 (values in
    [0, 2^32); a tensor or a Python int): the reference's ``_fmix32``,
    whose shifts are logical, which ``>>`` on these non-negative values
    is."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def dropout_threshold(p: float) -> int:
    """``min(2^32 - 1, round(p * 2^32))`` on the host, as the reference
    computes it (Python's ``round``: ties to even); the kernels take it
    as a uint32 and never recompute it in float."""
    return min(_M32, int(round(p * 4294967296.0)))


def dropout_keep_mask(q_ids, k_ids, row, seed0, seed1, p):
    """Counter-hash attention-dropout keep mask, bit for bit the
    reference's ``dropout_keep_mask``: element (row, q, k) is kept iff
    ``fmix32(fmix32(fmix32(row ^ s0) ^ q) ^ k ^ s1) >= thresh`` in uint32
    order. ``row`` is b*H + h with the query head, ``q_ids`` and ``k_ids``
    absolute positions (never tile-local); the three broadcast together.
    Seeds are int32 (negative ones wrap to their uint32 bits)."""
    dev = q_ids.device if torch.is_tensor(q_ids) else None

    def u32(a):
        return torch.as_tensor(a, dtype=torch.int64, device=dev) & _M32
    x = fmix32(u32(row) ^ (seed0 & _M32))
    x = fmix32(x ^ u32(q_ids))
    x = fmix32(x ^ u32(k_ids) ^ (seed1 & _M32))
    return x >= dropout_threshold(p)


def seed_slot(dropout_p, seeds, device):
    """The device int32 [2] slot a kernel reads the call's seeds from
    (None without dropout): ``seeds`` itself when it is a slot on
    ``device``, else its two int32 words in a new one."""
    if not dropout_p:
        return None
    if seeds is None:
        raise ValueError("dropout_p > 0 needs the call's two int32 seeds")
    if not torch.is_tensor(seeds):
        return _random.slot_of(seeds, device)
    if seeds.dtype != torch.int32 or seeds.shape != (2,) \
            or seeds.device != device or not seeds.is_contiguous():
        raise TypeError("a dropout seed slot is a contiguous int32 [2] "
                        "tensor on the kernel's device")
    return seeds


def _dropout_args(dropout_p, slot):
    """(slot pointer, thresh, dscale) for a C entry; dscale 0 means no
    dropout, else it is float32(1 / (1 - p)) as in the reference."""
    if not dropout_p:
        return None, 0, 0.0
    return slot.data_ptr(), dropout_threshold(dropout_p), \
        1.0 / (1.0 - dropout_p)


def _seed_words(seeds):
    """(seed0, seed1): ints for a pair of ints, int64 0-dim tensors (no
    host read) for a slot."""
    if torch.is_tensor(seeds):
        s = seeds.reshape(2).to(torch.int64)
        return s[0], s[1]
    return int(seeds[0]), int(seeds[1])


def _dropout_mult(b, h, sq, sk, dropout_p, seeds, dev):
    """f32 [B, H, Sq, Sk]: 1 / (1 - p) where the pattern of ``seeds`` (a
    slot or two words) keeps, else 0."""
    rows = torch.arange(b * h, device=dev).reshape(b, h, 1, 1)
    seed0, seed1 = _seed_words(seeds)
    keep = dropout_keep_mask(torch.arange(sq, device=dev)[:, None],
                             torch.arange(sk, device=dev)[None, :], rows,
                             seed0, seed1, dropout_p)
    return torch.where(keep, torch.tensor(1.0 / (1.0 - dropout_p)), 0.0)


def additive_mask(mask, b, h, sq, sk):
    """Normalize an attention mask to an additive f32 [Bm, Hm, Sq', Sk']
    tensor (Bm in {1, B}, Hm in {1, H}, Sq' in {1, Sq}, Sk' in {1, Sk});
    a bool mask becomes 0 / -1e30, as in the reference."""
    if mask is None:
        return None
    if mask.dim() != 4 or mask.shape[0] not in (1, b) \
            or mask.shape[1] not in (1, h) or mask.shape[2] not in (1, sq) \
            or mask.shape[3] not in (1, sk):
        raise ValueError(
            f"attention mask of shape {tuple(mask.shape)} does not "
            f"broadcast to [{b}, {h}, {sq}, {sk}] as [Bm, Hm, Sq|1, Sk|1]")
    if mask.dtype == torch.bool:
        return torch.where(mask, 0.0, NEG_INF).to(torch.float32)
    return mask.to(torch.float32)


def _repeat_kv(x, h):
    return x if x.shape[2] == h else x.repeat_interleave(h // x.shape[2],
                                                         dim=2)


def _keep(sq, sk, causal, kv_lens, dev):
    """Bool [B|1, 1, Sq, Sk] of the entries causality and kv_lens keep,
    or None when both are off."""
    keep = None
    if causal:
        keep = (torch.arange(sq, device=dev)[:, None]
                >= torch.arange(sk, device=dev)[None, :])[None, None]
    if kv_lens is not None:
        lens = (torch.arange(sk, device=dev)[None, :]
                < kv_lens.to(dev)[:, None])[:, None, None, :]
        keep = lens if keep is None else keep & lens
    return keep


def flash_attention_plain(q, k, v, scale, causal=False, mask=None,
                          kv_lens=None, return_lse=False, dropout_p=0.0,
                          seeds=None):
    """Reference math (``_gen_reference``): q [B, Sq, H, D], k/v [B, Sk,
    Hkv, D], mask additive f32 broadcastable to [B, H, Sq, Sk], kv_lens
    [B] ints. Scores in f32; with ``dropout_p`` the probabilities are
    multiplied by the keep pattern of ``seeds`` (a slot or two int32) over
    1 - p after the normaliser; P is cast to V's dtype before the P.V
    product, accumulated in f32. With ``return_lse``, also the f32
    log-sum-exp [B, H, Sq] of the masked scores (before dropout), as the
    kernel returns it."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    k, v = _repeat_kv(k, h), _repeat_kv(v, h)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        s = s + mask.float()
    keep = _keep(sq, sk, causal, kv_lens, q.device)
    if keep is not None:
        s = torch.where(keep, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    if dropout_p:
        p = p * _dropout_mult(b, h, sq, sk, dropout_p, seeds, q.device)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(),
                       v.float()).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def bwd_delta(out, dout):
    """rowsum(dO * O) in f32 as [B, H, Sq] (the reference computes it in
    XLA outside its kernels too)."""
    return (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(q, k, v, out, lse, dout, scale, causal=False,
                              mask=None, kv_lens=None, dropout_p=0.0,
                              seeds=None):
    """The backward recomputed from ``lse`` (the reference's
    ``_bwd_dkdv_kernel`` / ``_bwd_dq_kernel`` math), in f32 plain torch
    ops; masked entries give exactly zero, as in the kernels. With
    dropout, D is the forward's pattern over 1 - p: dV = (P*D)^T dO,
    dS = P * (dP*D - delta). GQA dK/dV are summed over each KV head's
    query-head group. Returns (dq, dk, dv) in the inputs' dtypes."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    qf, gf = q.float(), dout.float()
    kf, vf = _repeat_kv(k, h).float(), _repeat_kv(v, h).float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if mask is not None:
        s = s + mask.float()
    keep = _keep(sq, sk, causal, kv_lens, q.device)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    if dropout_p:
        dmul = _dropout_mult(b, h, sq, sk, dropout_p, seeds, q.device)
        dp = dp * dmul
    ds = p * (dp - bwd_delta(out, dout)[..., None])
    if dropout_p:
        p = p * dmul
    if keep is not None:
        p = torch.where(keep, p, 0.0)
        ds = torch.where(keep, ds, 0.0)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gf)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    if hkv != h:
        dk = dk.reshape(b, sk, hkv, h // hkv, d).sum(3)
        dv = dv.reshape(b, sk, hkv, h // hkv, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(what, q, k, v, mask, kv_lens, dtypes=tuple(_DTYPE_CODE),
           mixed=True):
    """Validate kernel inputs (see ``flash_attention_kernel``): q, k and
    v of ``dtypes``, k and v of one dtype, q of another only where
    ``mixed``; returns (B, Sq, H, D, Sk, Hkv)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{what}: want q [B, Sq, H, D], k = v [B, Sk, "
                         f"Hkv, D]; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or h % hkv:
        raise ValueError(f"{what}: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree (batch, head_dim, or "
                         "H not a multiple of Hkv)")
    if d not in _HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {d} not in {_HEAD_DIMS}")
    if q.dtype not in dtypes or k.dtype not in dtypes \
            or v.dtype != k.dtype or (not mixed and k.dtype != q.dtype):
        names = ", ".join(str(d).rsplit(".", 1)[-1] for d in dtypes)
        raise TypeError(f"{what}: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                        f"the kernel takes q of one of {names} and k, v of "
                        + ("one of them" if mixed else "q's"))
    tensors = [q, k, v]
    if mask is not None:
        if mask.dtype != torch.float32 or mask.dim() != 4:
            raise TypeError(f"{what}: mask must be a 4-D float32 tensor")
        tensors.append(mask)
    if kv_lens is not None:
        if kv_lens.dtype != torch.int32 or kv_lens.shape != (b,) \
                or not kv_lens.is_contiguous():
            raise TypeError(f"{what}: kv_lens must be contiguous int32 [B]")
        tensors.append(kv_lens)
    for t in tensors:
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{what}: every input must be on q's CUDA "
                             "device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{what}: q, k, v must be contiguous")
    if b * h > 65535:
        raise ValueError(f"{what}: B*H = {b * h} exceeds the grid limit")
    return b, sq, h, d, sk, hkv


# the largest query-head group of the forward's one-row decode route
# (``kDecodeMaxGroup`` in csrc/flash_fwd.cu)
DECODE_MAX_GROUP = 64


def fwd_route(q_dtype, kv_dtype, sq, h, hkv, dropout_p=0.0) -> str:
    """The device kernel ``flash_fwd``'s C entry launches for these
    dtypes and shapes (``decode_route`` and the dispatch in
    csrc/flash_fwd.cu, ``tc::f32_kv`` in csrc/wgmma.cuh): "decode", the
    one-row decode walk (q, k and v of one 16-bit dtype, Sq = 1, no
    dropout, H / Hkv at most ``DECODE_MAX_GROUP``); "wgmma", the
    tensor-core kernel (one 16-bit dtype otherwise); "wgmma_f32", the
    tensor-core kernel with every operand in three bf16 parts (f32
    throughout, Sq > 1, with or without dropout); "wgmma_f32kv", the
    tensor-core kernel with f32 K/V in bf16 hi + lo parts (a 16-bit q
    over f32 K/V, Sq > 1, no dropout); "fma", the FMA kernel (f32 at Sq =
    1, other pairs of dtypes, and a 16-bit q over f32 K/V at Sq = 1)."""
    if q_dtype == kv_dtype == torch.float32:
        return "wgmma_f32" if sq > 1 else "fma"
    if q_dtype != kv_dtype:
        if kv_dtype == torch.float32 and sq > 1 and not dropout_p:
            return "wgmma_f32kv"
        return "fma"
    if sq == 1 and not dropout_p and h // hkv <= DECODE_MAX_GROUP:
        return "decode"
    return "wgmma"


def bwd_route(dtype, head_dim, dropout_p=0.0) -> str:
    """The device kernel the backward's C entries (``flash_bwd_dkdv`` and
    ``flash_bwd_dq`` in csrc/flash_bwd.cu) launch for q's dtype and the
    head dim (64 or 128): "wgmma", the tensor-core kernels on bf16 or f16
    operands; "wgmma_f32", the same kernels with every f32 operand split
    into bf16 parts (hi + lo; hi + mid + lo in dP, dK and dQ). Dropout
    takes no other route."""
    del dropout_p
    if dtype not in _BWD_DTYPES or head_dim not in _HEAD_DIMS:
        raise ValueError(f"flash_bwd: no kernel for {dtype}, head_dim "
                         f"{head_dim}")
    return "wgmma_f32" if dtype == torch.float32 else "wgmma"


def _mask_args(mask, sk):
    """(pointer, batch, head, query and key strides) of an additive mask
    broadcast over [B, H, Sq, Sk]; a size-1 axis gets stride 0."""
    if mask is None:
        return None, 0, 0, 0, 0
    mask = mask.expand(mask.shape[0], mask.shape[1], mask.shape[2], sk)
    msq, msk = mask.stride(2), mask.stride(3)
    msb = mask.stride(0) if mask.shape[0] > 1 else 0
    msh = mask.stride(1) if mask.shape[1] > 1 else 0
    if mask.shape[2] == 1:
        msq = 0
    return mask.data_ptr(), msb, msh, msq, msk


def flash_attention_kernel(q, k, v, scale, causal=False, mask=None,
                           kv_lens=None, dropout_p=0.0, seeds=None):
    """Launch ``csrc/flash_fwd.cu`` on CUDA tensors. q [B, Sq, H, D], k/v
    [B, Sk, Hkv, D] (contiguous, each of float32/bfloat16/float16, k and
    v of one dtype, q of that dtype or, without dropout, of another; D 64
    or 128, H % Hkv == 0); mask additive f32 [Bm, Hm, Sq|1, Sk|1] or
    None; kv_lens int32 [B] or None; ``dropout_p`` in [0, 1) with
    ``seeds`` (a slot on q's device, or two int32) when it is not 0. The
    device kernel follows from the dtypes and shapes alone
    (``fwd_route``). Returns (out [B, Sq, H, D] in q's dtype, lse [B, H,
    Sq] f32)."""
    b, sq, h, d, sk, hkv = _check("flash_fwd", q, k, v, mask, kv_lens)
    if dropout_p and k.dtype != q.dtype:
        raise TypeError("flash_fwd: dropout takes q, k and v of one dtype")
    m_ptr, *strides = _mask_args(mask, sk)
    slot = seed_slot(dropout_p, seeds, q.device)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = load("flash_fwd", _SIGNATURES)
    err = lib.flash_fwd(
        _DTYPE_CODE[q.dtype], _DTYPE_CODE[k.dtype], d, q.data_ptr(),
        k.data_ptr(), v.data_ptr(),
        m_ptr, kv_lens.data_ptr() if kv_lens is not None else None,
        out.data_ptr(), lse.data_ptr(), b, sq, sk, h, hkv, *strides,
        float(scale), int(bool(causal)), *_dropout_args(dropout_p, slot),
        stream_ptr(q.device))
    check(err, "flash_fwd")
    count_launch("flash_fwd", q.dtype, k.dtype)
    count_route("flash_fwd", fwd_route(q.dtype, k.dtype, sq, h, hkv,
                                       dropout_p))
    return out, lse


def _bwd_args(what, q, k, v, dout, lse, delta, mask, kv_lens):
    b, sq, h, d, sk, hkv = _check(what, q, k, v, mask, kv_lens,
                                  dtypes=_BWD_DTYPES, mixed=False)
    if dout.shape != q.shape or dout.dtype != q.dtype \
            or dout.device != q.device or not dout.is_contiguous():
        raise ValueError(f"{what}: dout must be a contiguous tensor of q's "
                         "shape, dtype and device")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, h, sq) or t.dtype != torch.float32 \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous float32 "
                             f"[{b}, {h}, {sq}] on q's device")
    m_ptr, msb, msh, msq, msk = _mask_args(mask, sk)
    head = (_DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            m_ptr, kv_lens.data_ptr() if kv_lens is not None else None)
    return head, (b, sq, sk, h, hkv, msb, msh, msq, msk)


def flash_bwd_dkdv_kernel(q, k, v, dout, lse, delta, scale, causal=False,
                          mask=None, kv_lens=None, dropout_p=0.0,
                          seeds=None):
    """Launch ``flash_bwd_dkdv`` (counterpart of ``_bwd_dkdv_kernel``):
    q/dout [B, Sq, H, D], k/v [B, Sk, Hkv, D], lse/delta f32 [B, H, Sq],
    mask, kv_lens, dropout_p and seeds as for the forward. Returns (dk,
    dv) [B, Sk, Hkv, D] in k's dtype, summed over each KV head's
    query-head group."""
    head, dims = _bwd_args("flash_bwd_dkdv", q, k, v, dout, lse, delta,
                           mask, kv_lens)
    slot = seed_slot(dropout_p, seeds, q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = load("flash_bwd", _BWD_SIGNATURES)
    err = lib.flash_bwd_dkdv(*head, dk.data_ptr(), dv.data_ptr(), *dims,
                             float(scale), int(bool(causal)),
                             *_dropout_args(dropout_p, slot),
                             stream_ptr(q.device))
    check(err, "flash_bwd_dkdv")
    count_launch("flash_bwd_dkdv", q.dtype)
    count_route("flash_bwd_dkdv", bwd_route(q.dtype, q.shape[-1], dropout_p))
    return dk, dv


def flash_bwd_dq_kernel(q, k, v, dout, lse, delta, scale, causal=False,
                        mask=None, kv_lens=None, dropout_p=0.0, seeds=None):
    """Launch ``flash_bwd_dq`` (counterpart of ``_bwd_dq_kernel``); inputs
    as for ``flash_bwd_dkdv_kernel``. Returns dq [B, Sq, H, D]."""
    head, dims = _bwd_args("flash_bwd_dq", q, k, v, dout, lse, delta, mask,
                           kv_lens)
    slot = seed_slot(dropout_p, seeds, q.device)
    dq = torch.empty_like(q)
    lib = load("flash_bwd", _BWD_SIGNATURES)
    err = lib.flash_bwd_dq(*head, dq.data_ptr(), *dims, float(scale),
                           int(bool(causal)), *_dropout_args(dropout_p, slot),
                           stream_ptr(q.device))
    check(err, "flash_bwd_dq")
    count_launch("flash_bwd_dq", q.dtype)
    count_route("flash_bwd_dq", bwd_route(q.dtype, q.shape[-1], dropout_p))
    return dq


def flash_attention_bwd_kernel(q, k, v, out, lse, dout, scale, causal=False,
                               mask=None, kv_lens=None, dropout_p=0.0,
                               seeds=None):
    """The backward on the card: delta = rowsum(dO * O) as a torch op,
    then both kernels. Returns (dq, dk, dv)."""
    delta = bwd_delta(out, dout)
    drop = dict(dropout_p=dropout_p,
                seeds=seed_slot(dropout_p, seeds, q.device))
    dk, dv = flash_bwd_dkdv_kernel(q, k, v, dout, lse, delta, scale, causal,
                                   mask, kv_lens, **drop)
    dq = flash_bwd_dq_kernel(q, k, v, dout, lse, delta, scale, causal, mask,
                             kv_lens, **drop)
    return dq, dk, dv


def _flash_fwd_cpu(q, k, v, mask, kv_lens, scale, causal):
    out, lse = flash_attention_plain(q, k, v, scale, causal, mask, kv_lens,
                                     return_lse=True)
    return out.contiguous(), lse.contiguous()


def _flash_fwd_cuda(q, k, v, mask, kv_lens, scale, causal):
    return flash_attention_kernel(q, k, v, scale, causal, mask, kv_lens)


def _flash_fwd_fake(q, k, v, mask, kv_lens, scale, causal):
    b, sq, h, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, h, sq), dtype=torch.float32)


define_op("flash_fwd(Tensor q, Tensor k, Tensor v, Tensor? mask, "
          "Tensor? kv_lens, float scale, bool causal) -> (Tensor, Tensor)",
          cpu=_flash_fwd_cpu, cuda=_flash_fwd_cuda,
          fake=_flash_fwd_fake)


def _flash_bwd_fake(q, k, v, out, lse, dout, mask, kv_lens, scale, causal):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


# the backward as one op too: a fake trace (``jit.TrainStep``'s
# ``cost_analysis`` / ``memory_analysis``) sees the pair as one call of
# known shape and products
define_op("flash_bwd(Tensor q, Tensor k, Tensor v, Tensor out, Tensor lse, "
          "Tensor dout, Tensor? mask, Tensor? kv_lens, float scale, "
          "bool causal) -> (Tensor, Tensor, Tensor)",
          cpu=lambda q, k, v, o, lse, do, m, kl, sc, c:
          flash_attention_bwd_plain(q, k, v, o, lse, do, sc, c, m, kl),
          cuda=lambda q, k, v, o, lse, do, m, kl, sc, c:
          flash_attention_bwd_kernel(q, k, v, o, lse, do, sc, c, m, kl),
          fake=_flash_bwd_fake)


def _products(q, k):
    """Multiply-adds of one [Sq, Sk] x D product over every (batch,
    query head): B * H * Sq * Sk * D."""
    b, sq, h, d = q
    return b * h * sq * k[1] * d


# FLOPs of the two ops (``torch.utils.flop_counter``), 2 a multiply-add,
# every product in full (no causal skip): the forward's Q K^T and P V;
# the backward's five (S recomputed, dP = dO V^T, dV = P^T dO, dQ = dS K,
# dK = dS^T Q), as torch counts SDPA's backward
@register_flop_formula(torch.ops.paddle_tpu_torch.flash_fwd)
def _flash_fwd_flops(q, k, *args, **kwargs):
    return 2 * 2 * _products(q, k)


@register_flop_formula(torch.ops.paddle_tpu_torch.flash_bwd)
def _flash_bwd_flops(q, k, *args, **kwargs):
    return 5 * 2 * _products(q, k)


class _FlashAttention(torch.autograd.Function):
    """Counterpart of the reference's ``_flash_core`` custom_vjp (and its
    varlen and masked cores): forward and backward take the kernels for
    CUDA tensors and the plain versions for CPU tensors. The mask gets
    no gradient, as in the reference."""

    @staticmethod
    def forward(ctx, q, k, v, mask, kv_lens, scale, causal, dropout_p,
                seeds):
        drop = dict(dropout_p=dropout_p, seeds=seeds)
        if is_fake(q):
            # a trace without data (dropout changes no shape or product)
            out, lse = torch.ops.paddle_tpu_torch.flash_fwd(
                q, k, v, mask, kv_lens, float(scale), bool(causal))
        elif q.device.type == "cpu":
            out, lse = flash_attention_plain(q, k, v, scale, causal, mask,
                                             kv_lens, return_lse=True, **drop)
        else:
            out, lse = flash_attention_kernel(q, k, v, scale, causal, mask,
                                              kv_lens, **drop)
        ctx.save_for_backward(q, k, v, out, lse, mask, kv_lens)
        ctx.scale, ctx.causal, ctx.drop = scale, causal, drop
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, mask, kv_lens = ctx.saved_tensors
        if is_fake(q):
            dq, dk, dv = torch.ops.paddle_tpu_torch.flash_bwd(
                q, k, v, out, lse, dout.contiguous(), mask, kv_lens,
                float(ctx.scale), bool(ctx.causal))
            return dq, dk, dv, None, None, None, None, None, None
        bwd = flash_attention_bwd_plain if q.device.type == "cpu" \
            else flash_attention_bwd_kernel
        dq, dk, dv = bwd(q, k, v, out, lse, dout.contiguous(), ctx.scale,
                         ctx.causal, mask, kv_lens, **ctx.drop)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention_bshd(query, key, value, attn_mask=None, dropout_p=0.0,
                         is_causal=False, training=True, scale=None,
                         kv_lens=None):
    """``paddle.nn.functional.scaled_dot_product_attention`` semantics on
    [B, S, H, D] tensors (GQA: key/value may carry fewer heads). A CPU
    query takes the plain versions; a CUDA query launches the kernels or
    raises. Differentiable in query, key and value when grad is enabled;
    a mask that requires grad raises (the reference sends it to XLA).
    With ``training`` and ``dropout_p`` in (0, 1), the call draws its two
    dropout seeds from ``framework.random`` into a device slot (the
    reference's kernel-path pattern); ``training=False`` runs without
    dropout. Under ``amp`` the query, key and value are cast as for the
    reference's "flash_attention" op."""
    query, key, value = cast_inputs("flash_attention", query, key, value)
    p = float(dropout_p) if training else 0.0
    if not 0.0 <= p < 1.0:
        raise ValueError(f"dropout_p={dropout_p} is not in [0, 1)")
    seeds = _random.dropout_seed_slot(query.device) if p else None
    b, sq, h, d = query.shape
    sk = key.shape[1]
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    if torch.is_grad_enabled() and attn_mask is not None \
            and attn_mask.requires_grad:
        raise NotImplementedError(
            "a mask that requires grad is not supported: the flash "
            "backward gives masks no gradient")
    mask = additive_mask(attn_mask, b, h, sq, sk)
    if kv_lens is not None:
        kv_lens = torch.as_tensor(kv_lens, dtype=torch.int32,
                                  device=query.device)
    if query.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: unsupported device {query.device}")
    q, k, v = query.contiguous(), key.contiguous(), value.contiguous()
    if p or (torch.is_grad_enabled()
             and (q.requires_grad or k.requires_grad or v.requires_grad)):
        return _FlashAttention.apply(q, k, v, mask, kv_lens, sc,
                                     bool(is_causal), p, seeds)
    return torch.ops.paddle_tpu_torch.flash_fwd(q, k, v, mask, kv_lens,
                                                float(sc), bool(is_causal))[0]
