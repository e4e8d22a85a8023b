"""Paged-KV decode attention: the CUDA kernel ``csrc/paged_decode.cu``,
its plain PyTorch version, and the ``paged_attention`` entry
(counterpart of ``paddle_tpu/kernels/paged_attention.py``
``_paged_kernel`` / ``_paged_attention_pallas`` / ``paged_attention``).

The Pallas gate's limits (H == Hkv, D % 128, H % 8) are TPU tiling
artefacts and are not carried over: the kernel takes any GQA ratio and
head_dim 64 or 128.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ._build import NEG_INF, check, count_launch, load, stream_ptr

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"paged_decode": [
    _I, _I, _P, _P, _P, _P, _P, _P,         # dtype, head_dim, pointers
    _I, _I, _I, _I, _I, _I,                 # B, H, Hkv, page, pps, pages
    ctypes.c_float, _P]}                    # scale, stream


def paged_attention_plain(q, k_pages, v_pages, block_tables, context_lens,
                          scale):
    """Reference math (``_paged_attention_xla``): q [B, H, D]; pages
    [P, page, Hkv, D]; tables [B, pps]; context_lens [B] -> [B, H, D].
    Rows with context_lens == 0 come out as zeros, as the kernel (and
    the Pallas kernel) writes them; the XLA reference instead averages
    V uniformly there, a row the serving path never produces."""
    b, h, d = q.shape
    hkv = k_pages.shape[2]
    bt = block_tables.long().clamp(0, k_pages.shape[0] - 1)
    k = k_pages[bt].reshape(b, -1, hkv, d)           # [B, L, Hkv, D]
    v = v_pages[bt].reshape(b, -1, hkv, d)
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    s = torch.einsum("bhd,bkhd->bhk", q.float(), k.float()) * scale
    cl = context_lens.to(q.device).long()
    valid = torch.arange(k.shape[1], device=q.device)[None, :] < cl[:, None]
    s = torch.where(valid[:, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhk,bkhd->bhd", p.to(v.dtype).float(), v.float())
    out = torch.where((cl > 0)[:, None, None], out, 0.0)
    return out.to(q.dtype)


def paged_attention_kernel(q, k_pages, v_pages, block_tables, context_lens,
                           scale):
    """Launch ``csrc/paged_decode.cu`` on CUDA tensors: q [B, H, D],
    pages [P, page, Hkv, D] (one dtype of float32/bfloat16, D 64 or 128,
    H % Hkv == 0), block_tables int32 [B, pps], context_lens int32 [B]."""
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"paged_decode: want q [B, H, D], pages [P, page, "
                         f"Hkv, D]; got {tuple(q.shape)}, "
                         f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    b, h, d = q.shape
    num_pages, page, hkv, dk = k_pages.shape
    if dk != d or h % hkv:
        raise ValueError(f"paged_decode: q {tuple(q.shape)} and pages "
                         f"{tuple(k_pages.shape)} disagree")
    if d not in _HEAD_DIMS:
        raise ValueError(f"paged_decode: head_dim {d} not in {_HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODE or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"paged_decode: dtypes {q.dtype}/{k_pages.dtype}/"
                        f"{v_pages.dtype}; the kernel takes one of float32, "
                        "bfloat16")
    if block_tables.dtype != torch.int32 or block_tables.dim() != 2 \
            or block_tables.shape[0] != b:
        raise TypeError("paged_decode: block_tables must be int32 [B, pps]")
    if context_lens.dtype != torch.int32 or context_lens.shape != (b,):
        raise TypeError("paged_decode: context_lens must be int32 [B]")
    tensors = (q, k_pages, v_pages, block_tables, context_lens)
    for t in tensors:
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError("paged_decode: every input must be on q's "
                             "CUDA device")
        if not t.is_contiguous():
            raise ValueError("paged_decode: inputs must be contiguous")
    if b > 65535:
        raise ValueError(f"paged_decode: B = {b} exceeds the grid limit")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_decode: pages must be 16-byte aligned (the "
                         "kernel reads them in 16-byte vectors)")
    out = torch.empty_like(q)
    lib = load("paged_decode", _SIGNATURES)
    err = lib.paged_decode(
        _DTYPE_CODE[q.dtype], d, q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(), block_tables.data_ptr(), context_lens.data_ptr(),
        out.data_ptr(), b, h, hkv, page, block_tables.shape[1], num_pages,
        float(scale), stream_ptr(q.device))
    check(err, "paged_decode")
    count_launch("paged_decode")
    return out


def paged_attention(q, k_pages, v_pages, block_tables, context_lens,
                    scale=None):
    """Single-step decode attention over a paged KV cache: q [B, H, D],
    k_pages/v_pages [num_pages, page_size, n_kv_heads, D], block_tables
    [B, pages_per_seq] page ids, context_lens [B] valid token counts ->
    [B, H, D]. A CPU query takes the plain version; a CUDA query
    launches the kernel or raises."""
    sc = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, block_tables,
                                     context_lens, sc)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    return paged_attention_kernel(
        q.contiguous(), k_pages, v_pages,
        block_tables.to(torch.int32).contiguous(),
        context_lens.to(torch.int32).contiguous(), sc)
