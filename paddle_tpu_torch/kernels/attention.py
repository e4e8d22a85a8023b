"""Flash-attention forward: the CUDA kernel ``csrc/flash_fwd.cu``, its
plain PyTorch version, and the ``[B, S, H, D]`` entry
``flash_attention_bshd`` (counterpart of ``paddle_tpu/kernels/
attention.py`` ``_fwd_kernel`` / ``_flash_fwd_pallas`` /
``flash_attention_jax`` / ``flash_attention_bshd``).

Forward only, dropout off: the serving path runs neither the backward
kernels nor in-kernel dropout; both come with the training slice.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ._build import NEG_INF, check, count_launch, load, stream_ptr

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {"flash_fwd": [
    _I, _I, _P, _P, _P, _P, _P, _P, _P,     # dtype, head_dim, pointers
    _I, _I, _I, _I, _I,                     # B, Sq, Sk, H, Hkv
    _LL, _LL, _LL, _LL,                     # mask strides
    ctypes.c_float, _I, _P]}                # scale, causal, stream


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


def flash_attention_plain(q, k, v, scale, causal=False, mask=None,
                          kv_lens=None):
    """Reference math (``_gen_reference`` with dropout off): q [B, Sq, H,
    D], k/v [B, Sk, Hkv, D], mask additive f32 broadcastable to
    [B, H, Sq, Sk], kv_lens [B] ints. Scores in f32; P is cast to V's
    dtype before the P.V product, accumulated in f32."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        s = s + mask.float()
    dev = q.device
    if causal:
        qi = torch.arange(sq, device=dev)[:, None]
        ki = torch.arange(sk, device=dev)[None, :]
        s = torch.where(qi >= ki, s, NEG_INF)
    if kv_lens is not None:
        keep = torch.arange(sk, device=dev)[None, :] < kv_lens.to(dev)[:, None]
        s = torch.where(keep[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def flash_attention_kernel(q, k, v, scale, causal=False, mask=None,
                           kv_lens=None):
    """Launch ``csrc/flash_fwd.cu`` on CUDA tensors. q [B, Sq, H, D], k/v
    [B, Sk, Hkv, D] (contiguous, one dtype of float32/bfloat16, D 64 or
    128, H % Hkv == 0); mask additive f32 [Bm, Hm, Sq|1, Sk|1] or None;
    kv_lens int32 [B] or None. Returns (out [B, Sq, H, D], lse [B, H, Sq]
    f32)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_fwd: want q [B, Sq, H, D], k = v [B, Sk, "
                         f"Hkv, D]; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or h % hkv:
        raise ValueError(f"flash_fwd: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree (batch, head_dim, or "
                         "H not a multiple of Hkv)")
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash_fwd: head_dim {d} not in {_HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_fwd: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                        "the kernel takes one of float32, bfloat16")
    tensors = [q, k, v]
    if mask is not None:
        if mask.dtype != torch.float32 or mask.dim() != 4:
            raise TypeError("flash_fwd: mask must be a 4-D float32 tensor")
        tensors.append(mask)
    if kv_lens is not None:
        if kv_lens.dtype != torch.int32 or kv_lens.shape != (b,) \
                or not kv_lens.is_contiguous():
            raise TypeError("flash_fwd: kv_lens must be contiguous int32 [B]")
        tensors.append(kv_lens)
    for t in tensors:
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError("flash_fwd: every input must be on q's CUDA "
                             "device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_fwd: q, k, v must be contiguous")
    if b * h > 65535:
        raise ValueError(f"flash_fwd: B*H = {b * h} exceeds the grid limit")
    msb = msh = msq = msk = 0
    if mask is not None:
        mask = mask.expand(mask.shape[0], mask.shape[1], mask.shape[2], sk)
        msq, msk = mask.stride(2), mask.stride(3)
        msb = mask.stride(0) if mask.shape[0] > 1 else 0
        msh = mask.stride(1) if mask.shape[1] > 1 else 0
        if mask.shape[2] == 1:
            msq = 0
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = load("flash_fwd", _SIGNATURES)
    err = lib.flash_fwd(
        _DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        mask.data_ptr() if mask is not None else None,
        kv_lens.data_ptr() if kv_lens is not None else None,
        out.data_ptr(), lse.data_ptr(), b, sq, sk, h, hkv,
        msb, msh, msq, msk, float(scale), int(bool(causal)),
        stream_ptr(q.device))
    check(err, "flash_fwd")
    count_launch("flash_fwd")
    return out, lse


def flash_attention_bshd(query, key, value, attn_mask=None, dropout_p=0.0,
                         is_causal=False, training=True, scale=None,
                         kv_lens=None):
    """``paddle.nn.functional.scaled_dot_product_attention`` semantics on
    [B, S, H, D] tensors (GQA: key/value may carry fewer heads). A CPU
    query takes the plain version; a CUDA query launches the kernel or
    raises."""
    if dropout_p > 0.0 and training:
        raise NotImplementedError(
            "attention dropout is not ported yet (training slice)")
    b, sq, h, d = query.shape
    sk = key.shape[1]
    sc = scale if scale is not None else 1.0 / math.sqrt(d)
    mask = additive_mask(attn_mask, b, h, sq, sk)
    if kv_lens is not None:
        kv_lens = torch.as_tensor(kv_lens, dtype=torch.int32,
                                  device=query.device)
    if query.device.type == "cpu":
        return flash_attention_plain(query, key, value, sc, is_causal, mask,
                                     kv_lens)
    if query.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {query.device}")
    return flash_attention_kernel(
        query.contiguous(), key.contiguous(), value.contiguous(), sc,
        is_causal, mask, kv_lens)[0]
