"""Flash attention: the CUDA kernels ``csrc/flash_fwd.cu`` (forward) and
``csrc/flash_bwd.cu`` (backward: dK/dV and dQ), their plain PyTorch
versions, and the ``[B, S, H, D]`` entry ``flash_attention_bshd``
(counterpart of ``paddle_tpu/kernels/attention.py`` ``_fwd_kernel`` /
``_bwd_dkdv_kernel`` / ``_bwd_dq_kernel`` / ``_flash_bwd_pallas`` /
``_flash_core`` / ``flash_attention_bshd``).

``flash_attention_bshd`` goes through ``_FlashAttention``, an autograd
Function that saves ``(q, k, v, out, lse)`` and recomputes the
probabilities from ``lse`` in the backward, as the reference's
custom_vjp does; without grad it records nothing. Dropout is not ported
yet (it raises).
"""
from __future__ import annotations

import ctypes
import math

import torch

from ._build import NEG_INF, check, count_launch, load, stream_ptr

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_DIMS = [_I, _I, _I, _I, _I,                # B, Sq, Sk, H, Hkv
         _LL, _LL, _LL, _LL,                # mask strides
         ctypes.c_float, _I, _P]            # scale, causal, stream
_SIGNATURES = {"flash_fwd": [
    _I, _I, _P, _P, _P, _P, _P, _P, _P,     # dtype, head_dim, pointers
    *_DIMS]}
_BWD_SIGNATURES = {
    # dtype, head_dim, q, k, v, dout, lse, delta, mask, kv_lens, dk, dv
    "flash_bwd_dkdv": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                       *_DIMS],
    # dtype, head_dim, q, k, v, dout, lse, delta, mask, kv_lens, dq
    "flash_bwd_dq": [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, *_DIMS]}


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
                          kv_lens=None, return_lse=False):
    """Reference math (``_gen_reference`` with dropout off): q [B, Sq, H,
    D], k/v [B, Sk, Hkv, D], mask additive f32 broadcastable to
    [B, H, Sq, Sk], kv_lens [B] ints. Scores in f32; P is cast to V's
    dtype before the P.V product, accumulated in f32. With
    ``return_lse``, also the f32 log-sum-exp [B, H, Sq] of the masked
    scores, as the kernel returns it."""
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
                              mask=None, kv_lens=None):
    """The backward recomputed from ``lse`` (the reference's XLA path,
    ``_flash_bwd``), in f32 plain torch ops; masked entries give exactly
    zero, as in the kernels. GQA dK/dV are summed over each KV head's
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
    ds = p * (dp - bwd_delta(out, dout)[..., None])
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


def _check(what, q, k, v, mask, kv_lens):
    """Validate kernel inputs (see ``flash_attention_kernel``); returns
    (B, Sq, H, D, Sk, Hkv)."""
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
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"{what}: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                        "the kernel takes one of float32, bfloat16")
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
                           kv_lens=None):
    """Launch ``csrc/flash_fwd.cu`` on CUDA tensors. q [B, Sq, H, D], k/v
    [B, Sk, Hkv, D] (contiguous, one dtype of float32/bfloat16, D 64 or
    128, H % Hkv == 0); mask additive f32 [Bm, Hm, Sq|1, Sk|1] or None;
    kv_lens int32 [B] or None. Returns (out [B, Sq, H, D], lse [B, H, Sq]
    f32)."""
    b, sq, h, d, sk, hkv = _check("flash_fwd", q, k, v, mask, kv_lens)
    m_ptr, *strides = _mask_args(mask, sk)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    lib = load("flash_fwd", _SIGNATURES)
    err = lib.flash_fwd(
        _DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        m_ptr, kv_lens.data_ptr() if kv_lens is not None else None,
        out.data_ptr(), lse.data_ptr(), b, sq, sk, h, hkv, *strides,
        float(scale), int(bool(causal)), stream_ptr(q.device))
    check(err, "flash_fwd")
    count_launch("flash_fwd")
    return out, lse


def _bwd_args(what, q, k, v, dout, lse, delta, mask, kv_lens):
    b, sq, h, d, sk, hkv = _check(what, q, k, v, mask, kv_lens)
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
                          mask=None, kv_lens=None):
    """Launch ``flash_bwd_dkdv`` (counterpart of ``_bwd_dkdv_kernel``):
    q/dout [B, Sq, H, D], k/v [B, Sk, Hkv, D], lse/delta f32 [B, H, Sq],
    mask and kv_lens as for the forward. Returns (dk, dv) [B, Sk, Hkv, D]
    in k's dtype, summed over each KV head's query-head group."""
    head, dims = _bwd_args("flash_bwd_dkdv", q, k, v, dout, lse, delta,
                           mask, kv_lens)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = load("flash_bwd", _BWD_SIGNATURES)
    err = lib.flash_bwd_dkdv(*head, dk.data_ptr(), dv.data_ptr(), *dims,
                             float(scale), int(bool(causal)),
                             stream_ptr(q.device))
    check(err, "flash_bwd_dkdv")
    count_launch("flash_bwd_dkdv")
    return dk, dv


def flash_bwd_dq_kernel(q, k, v, dout, lse, delta, scale, causal=False,
                        mask=None, kv_lens=None):
    """Launch ``flash_bwd_dq`` (counterpart of ``_bwd_dq_kernel``); inputs
    as for ``flash_bwd_dkdv_kernel``. Returns dq [B, Sq, H, D]."""
    head, dims = _bwd_args("flash_bwd_dq", q, k, v, dout, lse, delta, mask,
                           kv_lens)
    dq = torch.empty_like(q)
    lib = load("flash_bwd", _BWD_SIGNATURES)
    err = lib.flash_bwd_dq(*head, dq.data_ptr(), *dims, float(scale),
                           int(bool(causal)), stream_ptr(q.device))
    check(err, "flash_bwd_dq")
    count_launch("flash_bwd_dq")
    return dq


def flash_attention_bwd_kernel(q, k, v, out, lse, dout, scale, causal=False,
                               mask=None, kv_lens=None):
    """The backward on the card: delta = rowsum(dO * O) as a torch op,
    then both kernels. Returns (dq, dk, dv)."""
    delta = bwd_delta(out, dout)
    dk, dv = flash_bwd_dkdv_kernel(q, k, v, dout, lse, delta, scale, causal,
                                   mask, kv_lens)
    dq = flash_bwd_dq_kernel(q, k, v, dout, lse, delta, scale, causal, mask,
                             kv_lens)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Counterpart of the reference's ``_flash_core`` custom_vjp (and its
    varlen and masked cores): forward and backward take the kernels for
    CUDA tensors and the plain versions for CPU tensors. The mask gets
    no gradient, as in the reference."""

    @staticmethod
    def forward(ctx, q, k, v, mask, kv_lens, scale, causal):
        if q.device.type == "cpu":
            out, lse = flash_attention_plain(q, k, v, scale, causal, mask,
                                             kv_lens, return_lse=True)
        else:
            out, lse = flash_attention_kernel(q, k, v, scale, causal, mask,
                                              kv_lens)
        ctx.save_for_backward(q, k, v, out, lse, mask, kv_lens)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, mask, kv_lens = ctx.saved_tensors
        bwd = flash_attention_bwd_plain if q.device.type == "cpu" \
            else flash_attention_bwd_kernel
        dq, dk, dv = bwd(q, k, v, out, lse, dout.contiguous(), ctx.scale,
                         ctx.causal, mask, kv_lens)
        return dq, dk, dv, None, None, None, None


def flash_attention_bshd(query, key, value, attn_mask=None, dropout_p=0.0,
                         is_causal=False, training=True, scale=None,
                         kv_lens=None):
    """``paddle.nn.functional.scaled_dot_product_attention`` semantics on
    [B, S, H, D] tensors (GQA: key/value may carry fewer heads). A CPU
    query takes the plain versions; a CUDA query launches the kernels or
    raises. Differentiable in query, key and value when grad is enabled;
    a mask that requires grad raises (the reference sends it to XLA)."""
    if dropout_p > 0.0 and training:
        raise NotImplementedError(
            "attention dropout is not ported yet (the _fmix32 counter hash)")
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
    return _FlashAttention.apply(
        query.contiguous(), key.contiguous(), value.contiguous(), mask,
        kv_lens, sc, bool(is_causal))
