"""RMSNorm and LayerNorm: Triton forward kernels, their plain PyTorch
versions, the analytic backwards and the ``fused_rms_norm`` /
``fused_layer_norm`` entries (counterpart of
``paddle_tpu/kernels/norm.py`` ``_rms_kernel`` / ``_rms_pallas`` /
``_rms_core`` / ``_rms_fwd`` / ``_rms_bwd`` and ``_ln_kernel`` /
``_ln_pallas`` / ``_ln_core`` / ``_ln_fwd`` / ``_ln_bwd``).

``y = x * rsqrt(mean(x^2) + eps) * w`` and
``y = (x - mean) * rsqrt(var + eps) * w + b``: statistics in f32, output
in ``x.dtype``. The backwards are ``_rms_bwd``'s and ``_ln_bwd``'s
formulas in plain torch ops on every device: the reference computes
them in XLA, not in a Pallas kernel.

Both forwards are also ``torch.library`` custom ops,
``paddle_tpu_torch::rms_norm`` and ``paddle_tpu_torch::layer_norm``
(``_ops.define_op``), so that ``torch.export`` captures a forward that
launches them: the CPU implementation is the plain version, the CUDA one
the kernel wrapper (which counts its launch), the fake one gives the
shape. A call that needs no gradient goes through the op; one that does
goes through the autograd Function, as before.
"""
from __future__ import annotations

import torch

from ._build import count_launch
from ._ops import define_op

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _check_rows(what, x2d, *vecs):
    """Validate kernel inputs: x [N, D] and vectors [D], one CUDA device,
    contiguous, float32/bfloat16/float16."""
    d = x2d.shape[-1] if x2d.dim() == 2 else None
    if d is None or any(v.shape != (d,) for v in vecs):
        raise ValueError(f"{what}: want x [N, D] and vectors [D], got "
                         f"{tuple(x2d.shape)} and "
                         f"{[tuple(v.shape) for v in vecs]}")
    if x2d.dtype not in _DTYPES or any(v.dtype not in _DTYPES for v in vecs):
        raise TypeError(f"{what}: unsupported dtypes {x2d.dtype}, "
                        f"{[v.dtype for v in vecs]} (kernel takes "
                        "float32/bfloat16/float16)")
    if not all(t.is_contiguous() for t in (x2d, *vecs)):
        raise ValueError(f"{what}: inputs must be contiguous")
    if x2d.device.type != "cuda" or any(v.device != x2d.device
                                        for v in vecs):
        raise ValueError(f"{what}: every input must be on x's CUDA device")


def rms_norm_plain(x2d: torch.Tensor, w: torch.Tensor, eps: float):
    """Reference math (``_rms_fwd``'s non-Pallas branch): f32 (or wider)
    statistics, result cast back to ``x.dtype``."""
    cdt = torch.promote_types(x2d.dtype, torch.float32)
    xf = x2d.to(cdt)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.to(cdt)).to(x2d.dtype)


def rms_norm_kernel(x2d: torch.Tensor, w: torch.Tensor, eps: float):
    """Launch the Triton RMSNorm kernel on CUDA tensors x [N, D], w [D]."""
    _check_rows("rms_norm", x2d, w)
    from ._rms_triton import launch
    n, d = x2d.shape
    y = torch.empty_like(x2d)
    if n:
        launch(x2d, w, y, float(eps))
        count_launch("rms_norm", x2d.dtype)
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


define_op("rms_norm(Tensor x, Tensor w, float eps) -> Tensor",
          cpu=rms_norm_plain, cuda=rms_norm_kernel,
          fake=lambda x, w, eps: torch.empty_like(x))


def _needs_grad(*ts):
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def fused_rms_norm(x: torch.Tensor, weight: torch.Tensor, eps=1e-6):
    """RMSNorm over the last axis of ``x``. A CPU tensor takes the plain
    version; a CUDA tensor launches the Triton kernel or raises.
    Differentiable in ``x`` and ``weight`` when grad is enabled; without
    grad it runs as the custom op ``paddle_tpu_torch::rms_norm``."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_rms_norm: unsupported device {x.device}")
    if x.device.type == "cuda":
        x2 = x2.contiguous()
    if _needs_grad(x2, weight):
        return _RMSNorm.apply(x2, weight, eps).reshape(shape)
    return torch.ops.paddle_tpu_torch.rms_norm(x2, weight,
                                               float(eps)).reshape(shape)


# ------------------------------------------------------------ LayerNorm --

def layer_norm_plain(x2d, w, b, eps):
    """Reference math (``_ln_fwd``'s non-Pallas branch): f32 (or wider)
    statistics, result cast back to ``x.dtype``."""
    cdt = torch.promote_types(x2d.dtype, torch.float32)
    xf = x2d.to(cdt)
    xc = xf - xf.mean(dim=-1, keepdim=True)
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return (xc * torch.rsqrt(var + eps) * w.to(cdt)
            + b.to(cdt)).to(x2d.dtype)


def layer_norm_kernel(x2d, w, b, eps):
    """Launch the Triton LayerNorm kernel on CUDA tensors x [N, D],
    w [D], b [D]."""
    _check_rows("layer_norm", x2d, w, b)
    from ._ln_triton import launch
    y = torch.empty_like(x2d)
    if x2d.shape[0]:
        launch(x2d, w, b, y, float(eps))
        count_launch("layer_norm", x2d.dtype)
    return y


def layer_norm_bwd(x2d, w, b, g2d, eps):
    """``_ln_bwd``: (dx, dw, db) for x [N, D], w and b [D] and the
    output's gradient g [N, D]; f32 statistics, ``dw`` and ``db`` summed
    over rows in f32 and then cast to the vectors' dtypes."""
    cdt = torch.promote_types(x2d.dtype, torch.float32)
    xf, gf, wf = x2d.to(cdt), g2d.to(cdt), w.to(cdt)
    xc = xf - xf.mean(dim=-1, keepdim=True)
    inv = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    xhat = xc * inv
    gw = (gf * xhat).sum(dim=0).to(w.dtype)
    gb = gf.sum(dim=0).to(b.dtype)
    gx_hat = gf * wf
    gx = inv * (gx_hat - gx_hat.mean(dim=-1, keepdim=True)
                - xhat * (gx_hat * xhat).mean(dim=-1, keepdim=True))
    return gx.to(x2d.dtype), gw, gb


class _LayerNorm(torch.autograd.Function):
    """Counterpart of the reference's ``_ln_core`` custom_vjp."""

    @staticmethod
    def forward(ctx, x2d, w, b, eps):
        ctx.save_for_backward(x2d, w, b)
        ctx.eps = eps
        if x2d.device.type == "cpu":
            return layer_norm_plain(x2d, w, b, eps)
        return layer_norm_kernel(x2d, w, b, eps)

    @staticmethod
    def backward(ctx, g):
        x2d, w, b = ctx.saved_tensors
        gx, gw, gb = layer_norm_bwd(x2d, w, b, g, ctx.eps)
        return gx, gw, gb, None


define_op("layer_norm(Tensor x, Tensor w, Tensor b, float eps) -> Tensor",
          cpu=layer_norm_plain, cuda=layer_norm_kernel,
          fake=lambda x, w, b, eps: torch.empty_like(x))


def fused_layer_norm(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, eps=1e-5):
    """LayerNorm over the last axis of ``x`` with ``weight`` and ``bias``.
    A CPU tensor takes the plain version; a CUDA tensor launches the
    Triton kernel or raises. Differentiable in all three when grad is
    enabled; without grad it runs as the custom op
    ``paddle_tpu_torch::layer_norm``."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_layer_norm: unsupported device {x.device}")
    if x.device.type == "cuda":
        x2 = x2.contiguous()
    if _needs_grad(x2, weight, bias):
        return _LayerNorm.apply(x2, weight, bias, eps).reshape(shape)
    return torch.ops.paddle_tpu_torch.layer_norm(
        x2, weight, bias, float(eps)).reshape(shape)
