"""Counterpart of ``paddle_tpu/nn/functional.py`` (what the Llama
serving and pretraining, the BERT/ERNIE fine-tuning and the ResNet
training paths use).

Where the reference names an op for its dispatcher (``linear``,
``embedding``, ``dropout``, ``gelu``, ``relu``, ``layer_norm``,
``cross_entropy``, ``conv``, ``batch_norm``, ``softmax``, ``max_pool``,
``avg_pool``), the function casts its inputs as ``amp`` says for that
name (``amp.cast_inputs``); ``tanh``, ``log_softmax``, the adaptive
pools and ``flatten`` are unnamed there and never cast.

Convolution, BatchNorm and pooling are not Pallas kernels in the
reference (``jax.lax.conv_general_dilated``, plain ``jnp`` and
``reduce_window``): here they are ``torch.nn.functional``'s, with the
reference's padding, layout and count rules.
"""
import math

import torch
import torch.nn.functional as F

from ..amp import cast_inputs
from ..framework import dtype as dtypes
from ..framework import random as _random
from ..kernels.attention import flash_attention_bshd
from ..kernels.norm import fused_layer_norm
from ..ops.manipulation import flatten  # noqa: F401  (nn.functional.flatten)


def tanh(x, name=None):
    return torch.tanh(x)


def relu(x, name=None):
    (x,) = cast_inputs("relu", x)
    return torch.relu(x)


def relu_(x, name=None):
    """``relu`` written into ``x`` (the reference's in-place update)."""
    return x.relu_()


def relu6(x, name=None):
    """``min(max(x, 0), 6)``."""
    return torch.clamp(x, 0.0, 6.0)


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    """``clip(slope x + offset, 0, 1)``: the reference's default slope is
    0.1666667, not 1/6 (torch's ``hardsigmoid``)."""
    return torch.clamp(slope * x + offset, 0.0, 1.0)


def hardswish(x, name=None):
    """``x clip(x + 3, 0, 6) / 6``."""
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def silu(x, name=None):
    """``x sigmoid(x)``; under ``amp`` cast as the reference's "silu"."""
    (x,) = cast_inputs("silu", x)
    return F.silu(x)


swish = silu


def softmax(x, axis=-1, dtype=None, name=None):
    """Softmax over ``axis``, in ``dtype`` when it is given (the input is
    cast first, as the reference casts it)."""
    (x,) = cast_inputs("softmax", x)
    if dtype is not None:
        x = x.to(dtypes.convert_dtype(dtype))
    return torch.softmax(x, dim=axis)


def log_softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        x = x.to(dtypes.convert_dtype(dtype))
    return torch.log_softmax(x, dim=axis)


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
    """``paddle.nn.functional.cross_entropy``, the reference's rules:

    - ``use_softmax``: log-softmax over ``axis`` in the logits' dtype;
      else ``input`` holds probabilities, whose log (floored at 1e-30)
      is taken;
    - soft labels (``soft_label``, or floating labels of the logits'
      rank): ``-sum(q log p)``, ``q`` smoothed by ``label_smoothing``, and
      with ``weight`` times ``sum(q w)``;
    - hard integer labels: the picked log-probability, or with
      ``label_smoothing`` ``ls`` the smoothed one-hot's sum
      ``(1 - ls) log p_y + ls / C sum_c log p_c``; ``weight`` scales a row
      by ``(1 - ls) w_y + ls / C sum_c w_c``. Rows labelled
      ``ignore_index`` give 0; a label outside [0, C) gives NaN (the
      upstream kernel refuses it);
    - ``mean`` over hard labels divides by the non-ignored rows' weight
      (their count without ``weight``; 0 when all are ignored), over soft
      labels by the number of rows."""
    input, label, weight = cast_inputs("cross_entropy", input, label,
                                       weight)
    nd = input.dim()
    ax = axis % nd
    n = input.shape[ax]
    if use_softmax:
        logp = torch.log_softmax(input, dim=ax)
    else:
        logp = torch.log(torch.clamp(input, min=1e-30))
    if soft_label or (label.dim() == nd and label.dtype.is_floating_point):
        tgt = label
        if label_smoothing > 0.0:
            tgt = tgt * (1 - label_smoothing) + label_smoothing / n
        loss = -(tgt * logp).sum(ax)
        if weight is not None:
            w = weight.reshape([-1 if i == ax else 1 for i in range(nd)])
            loss = loss * (tgt * w).sum(ax)
        return _reduce(loss, reduction)
    if label.dtype.is_floating_point:
        raise TypeError("cross_entropy: hard labels must be integers")
    if label.dim() == nd:
        label = label.squeeze(ax)
    valid = label != ignore_index
    safe = torch.where(valid & (label >= 0) & (label < n), label, 0)
    nll = -logp.gather(ax, safe.unsqueeze(ax)).squeeze(ax)
    if label_smoothing > 0.0:
        nll = (1 - label_smoothing) * nll \
            - (label_smoothing / n) * logp.sum(ax)
    wi = None
    if weight is not None:
        wi = weight[safe]
        if label_smoothing > 0.0:
            wi = (1 - label_smoothing) * wi \
                + (label_smoothing / n) * weight.sum()
        nll = nll * wi
    oob = valid & ((label < 0) | (label >= n))
    nll = torch.where(oob, float("nan"), nll)
    loss = torch.where(valid, nll, 0.0)
    if reduction != "mean":
        return _reduce(loss, reduction)
    # mean over the non-ignored rows (their weight); the all-ignored case
    # gives 0
    den = valid.to(loss.dtype).sum() if wi is None \
        else torch.where(valid, wi, 0.0).sum()
    return loss.sum() / torch.clamp(den, min=1e-12)


def _reduce(loss, reduction):
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if reduction == "mean":
        return loss.mean()
    raise ValueError(f"unknown reduction {reduction!r}")


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """Per-row ``cross_entropy`` kept as a size-1 ``axis``; with
    ``return_softmax`` also the softmax. ``numeric_stable_mode`` is taken
    and, as in the reference, not read."""
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis).unsqueeze(axis)
    if return_softmax:
        return loss, softmax(logits, axis=axis)
    return loss


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    """Negative log-likelihood of log-probabilities ``input`` (classes on
    axis 1, or 0 for one row) at integer ``label``; ``mean`` divides by
    the non-ignored rows' weight (their count, at least 1, without
    ``weight``)."""
    cls = 1 if input.dim() > 1 else 0
    valid = label != ignore_index
    safe = torch.where(valid, label, 0)
    if input.dim() == label.dim() + 1:
        picked = -input.gather(cls, safe.unsqueeze(cls)).squeeze(cls)
    else:
        picked = -input.gather(cls, safe)
    if weight is not None:
        picked = picked * weight[safe]
    loss = torch.where(valid, picked, 0.0)
    if reduction != "mean":
        return _reduce(loss, reduction)
    if weight is not None:
        return loss.sum() / torch.where(valid, weight[safe], 0.0).sum()
    return loss.sum() / torch.clamp(valid.sum(), min=1)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    """``label * (1 - epsilon) + epsilon / C`` over the last axis;
    ``prior_dist`` is taken and, as in the reference, not read."""
    return label * (1 - epsilon) + epsilon / label.shape[-1]


# ------------------------------------------------------------ convolution --
def _ntuple(v, n):
    if isinstance(v, (list, tuple)):
        return tuple(int(i) for i in v)
    return (int(v),) * n


def _to_nchw(x, data_format):
    return x.permute(0, 3, 1, 2) if data_format == "NHWC" else x


def _from_nchw(x, data_format):
    return x.permute(0, 2, 3, 1) if data_format == "NHWC" else x


def _conv_pads(padding, x_sp, k_sp, stride, dilation):
    """The reference's padding forms as one (low, high) pair per spatial
    axis: ``"SAME"`` / ``"VALID"`` (XLA's rule, on the dilated kernel), an
    int, one int per axis, a flat [lo0, hi0, lo1, hi1, ...] list, or one
    pair per axis."""
    n = len(x_sp)
    if isinstance(padding, str):
        pad = padding.upper()
        if pad == "VALID":
            return [(0, 0)] * n
        if pad != "SAME":
            raise ValueError(f"unknown padding {padding!r}")
        out = []
        for size, k, s, d in zip(x_sp, k_sp, stride, dilation):
            o = -(-size // s)
            total = max((o - 1) * s + (k - 1) * d + 1 - size, 0)
            out.append((total // 2, total - total // 2))
        return out
    if isinstance(padding, (list, tuple)) and len(padding) == 2 * n:
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(n)]
    if isinstance(padding, (list, tuple)) and len(padding) == n and \
            isinstance(padding[0], (list, tuple)):
        return [tuple(int(q) for q in p) for p in padding]
    return [(p, p) for p in _ntuple(padding, n)]


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    """2-D convolution, ``weight`` [out, in / groups, kh, kw] (the same
    layout in both packages), ``data_format`` "NCHW" or "NHWC". Unequal
    low and high padding pads ``x`` first."""
    x, weight, bias = cast_inputs("conv", x, weight, bias)
    x = _to_nchw(x, data_format)
    stride, dilation = _ntuple(stride, 2), _ntuple(dilation, 2)
    pads = _conv_pads(padding, x.shape[2:], weight.shape[2:], stride,
                      dilation)
    if all(lo == hi for lo, hi in pads):
        out = F.conv2d(x, weight, bias, stride, [lo for lo, _ in pads],
                       dilation, groups)
    else:
        x = F.pad(x, [v for lo_hi in reversed(pads) for v in lo_hi])
        out = F.conv2d(x, weight, bias, stride, 0, dilation, groups)
    return _from_nchw(out, data_format)


# ---------------------------------------------------------------- norms --
def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-05,
               data_format="NCHW", use_global_stats=None, name=None):
    """BatchNorm over every axis but the channel one (axis 1 for an "NC*"
    ``data_format``, else the last). With ``training`` (and no
    ``use_global_stats``, which overrides it) it normalises by the
    batch's mean and biased variance and updates the running stats in
    place, the reference's ``r = m r + (1 - m) b`` (torch's momentum is
    ``1 - m``), the variance with the unbiased factor ``n / (n - 1)``;
    otherwise by the running stats. Under ``amp`` every input is f32 (the
    reference's black list)."""
    x, weight, bias = cast_inputs("batch_norm", x, weight, bias)
    channel_last = not data_format.startswith("NC") and x.dim() > 2
    if channel_last:
        x = x.movedim(-1, 1)
    use_batch = training and not use_global_stats
    if not use_batch:
        (running_mean, running_var) = cast_inputs(
            "batch_norm", running_mean, running_var)
    out = F.batch_norm(x, running_mean, running_var, weight, bias,
                       training=use_batch, momentum=1.0 - momentum,
                       eps=epsilon)
    return out.movedim(1, -1) if channel_last else out


# -------------------------------------------------------------- pooling --
def _window(kernel_size, stride, padding):
    """Kernel, stride (the kernel's when None) and padding as pairs."""
    return (_ntuple(kernel_size, 2),
            _ntuple(kernel_size if stride is None else stride, 2),
            _ntuple(padding, 2))


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    """Max over each window (padding counts as -inf); ``ceil_mode`` keeps
    a last partial window unless it would start in the padding (the
    reference's rule and torch's). ``return_mask`` also gives each
    output's flat index within its input plane (NCHW only, as there)."""
    if return_mask and data_format != "NCHW":
        raise ValueError("return_mask requires NCHW data_format")
    (x,) = cast_inputs("max_pool", x)
    ks, st, pd = _window(kernel_size, stride, padding)
    if return_mask:
        return F.max_pool2d(x, ks, st, pd, 1, ceil_mode, True)
    return _from_nchw(F.max_pool2d(_to_nchw(x, data_format), ks, st, pd, 1,
                                   ceil_mode), data_format)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    """Mean over each window: over its cells inside the input
    (``exclusive``), or over its cells inside the padded input (the
    ceil-mode overhang past the padding never counts: torch's
    ``count_include_pad``). ``divisor_override`` is taken and, as in the
    reference, not read."""
    (x,) = cast_inputs("avg_pool", x)
    ks, st, pd = _window(kernel_size, stride, padding)
    return _from_nchw(F.avg_pool2d(_to_nchw(x, data_format), ks, st, pd,
                                   ceil_mode, count_include_pad=not exclusive),
                      data_format)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    """Mean over bins [floor(i n / o), ceil((i + 1) n / o)) per axis."""
    return _from_nchw(F.adaptive_avg_pool2d(_to_nchw(x, data_format),
                                            output_size), data_format)


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    """Max over the same bins, NCHW. ``return_mask`` is taken and, as in
    the reference, not read: the output alone comes back."""
    return F.adaptive_max_pool2d(x, output_size)
