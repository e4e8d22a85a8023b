"""RMSNorm: a Triton forward kernel, its plain PyTorch version, the
analytic backward and the ``fused_rms_norm`` entry (counterpart of
``paddle_tpu/kernels/norm.py`` ``_rms_kernel`` / ``_rms_pallas`` /
``_rms_core`` / ``_rms_fwd`` / ``_rms_bwd``).

``y = x * rsqrt(mean(x^2) + eps) * w``: statistics in f32, output in
``x.dtype``. The backward is ``_rms_bwd``'s formula in plain torch ops
on every device: the reference computes it in XLA, not in a Pallas
kernel.
"""
from __future__ import annotations

import torch

from ._build import count_launch

_DTYPES = (torch.float32, torch.bfloat16)


def rms_norm_plain(x2d: torch.Tensor, w: torch.Tensor, eps: float):
    """Reference math (``_rms_fwd``'s non-Pallas branch): f32 (or wider)
    statistics, result cast back to ``x.dtype``."""
    cdt = torch.promote_types(x2d.dtype, torch.float32)
    xf = x2d.to(cdt)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.to(cdt)).to(x2d.dtype)


def rms_norm_kernel(x2d: torch.Tensor, w: torch.Tensor, eps: float):
    """Launch the Triton RMSNorm kernel on CUDA tensors x [N, D], w [D]."""
    if x2d.dim() != 2 or w.shape != (x2d.shape[1],):
        raise ValueError(f"rms_norm: want x [N, D] and w [D], got "
                         f"{tuple(x2d.shape)} and {tuple(w.shape)}")
    if x2d.dtype not in _DTYPES or w.dtype not in _DTYPES:
        raise TypeError(f"rms_norm: unsupported dtypes {x2d.dtype}, "
                        f"{w.dtype} (kernel takes float32/bfloat16)")
    if not (x2d.is_contiguous() and w.is_contiguous()):
        raise ValueError("rms_norm: x and w must be contiguous")
    if w.device != x2d.device:
        raise ValueError("rms_norm: x and w on different devices")
    from ._rms_triton import launch
    n, d = x2d.shape
    y = torch.empty_like(x2d)
    if n:
        launch(x2d, w, y, float(eps))
        count_launch("rms_norm")
    return y


def rms_norm_bwd(x2d, w, g2d, eps):
    """``_rms_bwd``: (dx, dw) for x [N, D], w [D] and the output's
    gradient g [N, D]; f32 statistics, ``dw`` summed over rows in f32 and
    then cast to ``w.dtype``."""
    cdt = torch.promote_types(x2d.dtype, torch.float32)
    xf, gf, wf = x2d.to(cdt), g2d.to(cdt), w.to(cdt)
    inv = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    xhat = xf * inv
    gw = (gf * xhat).sum(dim=0).to(w.dtype)
    gx_hat = gf * wf
    gx = inv * (gx_hat - xhat * (gx_hat * xhat).mean(dim=-1, keepdim=True))
    return gx.to(x2d.dtype), gw


class _RMSNorm(torch.autograd.Function):
    """Counterpart of the reference's ``_rms_core`` custom_vjp."""

    @staticmethod
    def forward(ctx, x2d, w, eps):
        ctx.save_for_backward(x2d, w)
        ctx.eps = eps
        if x2d.device.type == "cpu":
            return rms_norm_plain(x2d, w, eps)
        return rms_norm_kernel(x2d, w, eps)

    @staticmethod
    def backward(ctx, g):
        x2d, w = ctx.saved_tensors
        gx, gw = rms_norm_bwd(x2d, w, g, ctx.eps)
        return gx, gw, None


def fused_rms_norm(x: torch.Tensor, weight: torch.Tensor, eps=1e-6):
    """RMSNorm over the last axis of ``x``. A CPU tensor takes the plain
    version; a CUDA tensor launches the Triton kernel or raises.
    Differentiable in ``x`` and ``weight`` when grad is enabled."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_rms_norm: unsupported device {x.device}")
    if x.device.type == "cuda":
        x2 = x2.contiguous()
    return _RMSNorm.apply(x2, weight, eps).reshape(shape)
