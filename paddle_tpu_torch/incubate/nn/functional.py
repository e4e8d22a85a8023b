"""Counterpart of ``paddle_tpu/incubate/nn/functional.py`` (what the
Llama serving and BERT/ERNIE fine-tuning paths use)."""
import torch
import torch.nn.functional as F

from ...amp import cast_inputs
from ...kernels.norm import fused_layer_norm as _fused_layer_norm


def swiglu(x, y=None, name=None):
    """``silu(x) * y``; with ``y`` None, ``x`` is split in half on its last
    axis. Plain tensor ops, as in the reference."""
    x, y = cast_inputs("swiglu", x, y)
    if y is None:
        x, y = torch.chunk(x, 2, dim=-1)
    return F.silu(x) * y


def fused_layer_norm(x, scale, bias, epsilon=1e-5, begin_norm_axis=1):
    """LayerNorm over the last axis with ``scale`` and ``bias`` through the
    LayerNorm kernel (the reference's own entry to ``_ln_kernel``).
    ``begin_norm_axis`` is taken and, as in the reference, not read: the
    last axis is normalized whatever it says."""
    x, scale, bias = cast_inputs("layer_norm", x, scale, bias)
    return _fused_layer_norm(x, scale, bias, epsilon)
