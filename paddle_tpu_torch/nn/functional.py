"""Counterpart of ``paddle_tpu/nn/functional.py`` (only what the Llama
serving and pretraining and the BERT/ERNIE fine-tuning paths use).

Where the reference names an op for its dispatcher (``linear``,
``embedding``, ``dropout``, ``gelu``, ``relu``, ``layer_norm``,
``cross_entropy``), the function casts its inputs as ``amp`` says for
that name (``amp.cast_inputs``); ``tanh`` is unnamed there and never
cast."""
import math

import torch
import torch.nn.functional as F

from ..amp import cast_inputs
from ..framework import random as _random
from ..kernels.attention import flash_attention_bshd
from ..kernels.norm import fused_layer_norm


def tanh(x, name=None):
    return torch.tanh(x)


def relu(x, name=None):
    (x,) = cast_inputs("relu", x)
    return torch.relu(x)


def gelu(x, approximate=False, name=None):
    """GELU, exact (erf) by default as ``jax.nn.gelu(approximate=False)``;
    ``approximate=True`` is the tanh form."""
    (x,) = cast_inputs("gelu", x)
    return F.gelu(x, approximate="tanh" if approximate else "none")


def linear(x, weight, bias=None, name=None):
    """Paddle semantics: ``weight`` is [in_features, out_features] (the
    transpose of ``torch.nn.functional.linear``'s), ``y = x @ W + b``."""
    x, weight, bias = cast_inputs("linear", x, weight, bias)
    y = torch.matmul(x, weight)
    return y if bias is None else y + bias


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows of ``weight`` [V, D] at the integer ids ``x``; positions whose
    id is ``padding_idx`` give zeros (and pass no gradient), as in the
    reference. ``sparse`` gradients are not ported."""
    if sparse:
        raise NotImplementedError("embedding: sparse gradients are not "
                                  "ported")
    (weight,) = cast_inputs("embedding", weight)
    out = F.embedding(x, weight)
    if padding_idx is not None:
        out = torch.where((x == padding_idx)[..., None], 0.0, out)
    return out


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """``paddle.nn.functional.dropout``: in training, each element (or,
    with ``axis``, each slice along the named axes, broadcast over the
    others) is kept with probability 1 - p, the mask drawn by
    ``torch.bernoulli`` on ``x``'s device from ``framework.random``'s
    generator of that device. ``upscale_in_train``
    divides the kept values by 1 - p; ``downscale_in_infer`` leaves them
    and multiplies by 1 - p at inference. The reference draws with
    ``jax.random``: the two give other masks from one seed."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout: unknown mode {mode!r}")
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"dropout: p={p} is not in [0, 1]")
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1 - p)
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    (x,) = cast_inputs("dropout", x)   # only where the reference names it
    shape = list(x.shape)
    if axis is not None:
        axes = axis if isinstance(axis, (list, tuple)) else [axis]
        keep_axes = {a % len(shape) for a in axes}
        shape = [s if i in keep_axes else 1 for i, s in enumerate(shape)]
    g = _random.dropout_generator(x.device)
    probs = torch.full(shape, 1.0 - p, dtype=torch.float32, device=x.device)
    m = torch.bernoulli(probs, generator=g).to(x.dtype)
    if mode == "upscale_in_train":
        return x * m / (1.0 - p)
    return x * m


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-05,
               name=None):
    """LayerNorm over the trailing ``normalized_shape`` axes, always
    through ``fused_layer_norm`` (the Triton kernel on CUDA, its plain
    version on the CPU): the trailing axes are flattened into one row,
    and a missing ``weight`` or ``bias`` is ones or zeros. Statistics are
    f32; the reference computes them in ``x``'s dtype (equal at f32)."""
    if isinstance(normalized_shape, int):
        normalized_shape = [normalized_shape]
    normalized_shape = [int(s) for s in normalized_shape]
    x, weight, bias = cast_inputs("layer_norm", x, weight, bias)
    lead = x.dim() - len(normalized_shape)
    if lead < 0 or list(x.shape[lead:]) != normalized_shape:
        raise ValueError(f"layer_norm: normalized_shape {normalized_shape} "
                         f"is not the end of x's shape {list(x.shape)}")
    d = math.prod(normalized_shape)
    w = (torch.ones(d, dtype=x.dtype, device=x.device) if weight is None
         else weight.reshape(d))
    b = (torch.zeros(d, dtype=x.dtype, device=x.device) if bias is None
         else bias.reshape(d))
    out = fused_layer_norm(x.reshape(*x.shape[:lead], d), w, b, epsilon)
    return out.reshape(x.shape)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """``paddle.nn.functional.scaled_dot_product_attention`` on the
    [B, S, H, D] (flash) layout, through the flash-attention kernels;
    with ``training`` and ``dropout_p`` > 0, the kernels' counter-hash
    attention dropout."""
    return flash_attention_bshd(query, key, value, attn_mask=attn_mask,
                                dropout_p=dropout_p, is_causal=is_causal,
                                training=training)


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """``paddle.nn.functional.cross_entropy`` with hard integer labels
    over the last axis. The log-softmax runs in the logits' dtype, as the
    reference's ``jax.nn.log_softmax(logits)`` does; rows labelled
    ``ignore_index`` give 0 and leave the mean's denominator; a label
    outside [0, C) gives NaN (the upstream kernel refuses it). Soft
    labels, class weights, label smoothing and ``use_softmax=False`` are
    not ported."""
    if soft_label or weight is not None or label_smoothing or \
            not use_softmax or axis not in (-1, input.dim() - 1):
        raise NotImplementedError(
            "cross_entropy: only hard labels over the last axis, without "
            "weight or label smoothing, are ported")
    if label.dtype.is_floating_point:
        raise TypeError("cross_entropy: hard labels must be integers")
    (input,) = cast_inputs("cross_entropy", input)
    if label.dim() == input.dim():
        label = label.squeeze(-1)
    n = input.shape[-1]
    logp = torch.log_softmax(input, dim=-1)
    valid = label != ignore_index
    safe = torch.where(valid & (label >= 0) & (label < n), label, 0)
    nll = -logp.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    oob = valid & ((label < 0) | (label >= n))
    nll = torch.where(oob, float("nan"), nll)
    loss = torch.where(valid, nll, 0.0)
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if reduction != "mean":
        raise ValueError(f"cross_entropy: unknown reduction {reduction!r}")
    # mean over the non-ignored rows; the all-ignored case gives 0
    den = valid.to(loss.dtype).sum()
    return loss.sum() / torch.clamp(den, min=1e-12)
