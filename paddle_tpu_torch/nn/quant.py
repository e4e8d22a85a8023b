"""Weight-only quantization for serving (counterpart of
``paddle_tpu/nn/quant.py``): ``weight_quantize``, ``weight_dequantize``,
``weight_only_linear`` and ``llm_int8_linear``.

The functions take Paddle's ``[in, out]`` weight layout, as the API does;
``torch.nn.Linear`` holds ``[out, in]``, so a caller transposes. Scales
are absmax per output channel (``group_size=-1``, scale ``[out]``) or per
``(group_size`` rows of the in dim, output channel) (scale
``[in // g, out]``). int4 packs two nibbles per int8 byte along the in
dim (row ``2i`` low, row ``2i + 1`` high); an odd in dim gets one zero
pad row. ``weight_only_linear`` is a dequantize followed by a plain
product, as the reference leaves it to XLA (no Pallas kernel).
"""
from __future__ import annotations

import torch

__all__ = ["weight_quantize", "weight_dequantize", "weight_only_linear",
           "llm_int8_linear"]

_ALGOS = ("weight_only_int8", "weight_only_int4", "llm.int8")
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _check_algo(algo):
    if algo not in _ALGOS:
        raise ValueError(f"unsupported quant algo {algo!r}")


def _group_check(n_in, group_size):
    if group_size == -1:
        return
    if group_size < 2 or group_size % 2 or n_in % group_size:
        raise ValueError(
            f"group_size {group_size} must be even and divide the in "
            f"dim {n_in} (use -1 for per-channel scales)")


def _out_dtype(dt):
    return _DTYPES[dt] if isinstance(dt, str) else dt


def weight_quantize(x, algo="weight_only_int8", group_size=-1):
    """Absmax quantization of an ``[in, out]`` weight; returns (codes
    int8, scale f32). Codes are ``[in, out]`` for int8 and
    ``[ceil(in / 2), out]`` for int4, on the weight's device; the
    arithmetic is the reference's numpy f32 (IEEE division, rounding half
    to even), so the codes equal its bit for bit."""
    _check_algo(algo)
    w = torch.as_tensor(x).detach().to(torch.float32)
    _group_check(w.shape[0], group_size)
    if group_size == -1:
        absmax = torch.clamp(w.abs().amax(dim=0), min=1e-8)     # [out]
        row_max = absmax
    else:
        g = group_size
        wg = w.reshape(w.shape[0] // g, g, w.shape[1])
        absmax = torch.clamp(wg.abs().amax(dim=1), min=1e-8)   # [in//g, out]
        row_max = absmax.repeat_interleave(g, dim=0)           # [in, out]
    if algo == "weight_only_int4":
        q = torch.clamp(torch.round(w / row_max * 7.0), -8, 7).to(torch.int8)
        if q.shape[0] % 2:
            q = torch.cat([q, torch.zeros((1, q.shape[1]), dtype=torch.int8,
                                          device=q.device)])
        lo = q[0::2] & 0x0F
        hi = (q[1::2] & 0x0F) << 4
        return lo | hi, absmax / 7.0
    q = torch.clamp(torch.round(w / row_max * 127.0), -127, 127)
    return q.to(torch.int8), absmax / 127.0


def _unpack_int4(packed, in_features=None):
    """Nibble pairs to int8 rows; ``in_features`` strips the pad row an
    odd in dim got."""
    u = packed.view(torch.uint8)
    lo = (u & 0x0F).to(torch.int8)
    lo = torch.where(lo >= 8, lo - 16, lo)                     # sign-extend
    hi = ((u >> 4) & 0x0F).to(torch.int8)
    hi = torch.where(hi >= 8, hi - 16, hi)
    out = torch.stack([lo, hi], dim=1).reshape(packed.shape[0] * 2,
                                               packed.shape[1])
    return out if in_features is None else out[:in_features]


def weight_dequantize(x, scale, algo="weight_only_int8",
                      out_dtype="float32", group_size=-1):
    """Inverse of ``weight_quantize``: ``codes * scale`` in f32, cast to
    ``out_dtype``. int4 comes back with the pad row of an odd in dim
    (slice ``[:in]``; ``weight_only_linear`` strips it)."""
    _check_algo(algo)
    q, s = torch.as_tensor(x), torch.as_tensor(scale)
    if group_size != -1:
        _group_check(s.shape[0] * group_size, group_size)
    w = _unpack_int4(q) if algo == "weight_only_int4" else q
    if group_size != -1:
        if s.shape[0] * group_size != w.shape[0]:
            raise ValueError(
                f"group_size {group_size} x {s.shape[0]} scale groups covers "
                f"{s.shape[0] * group_size} rows, but the weight has "
                f"{w.shape[0]}: pass the group_size used at quantization")
        s = s.repeat_interleave(group_size, dim=0)
    return (w.to(torch.float32) * s.to(w.device)).to(_out_dtype(out_dtype))


def weight_only_linear(x, weight, bias=None, weight_scale=None,
                       weight_dtype="int8", group_size=-1, name=None):
    """``y = x @ dequant(weight) + bias`` with ``weight`` the codes
    ``[in, out]`` (int4: ``[ceil(in / 2), out]``) and ``weight_scale``
    ``[out]`` or ``[in // g, out]``."""
    if weight_scale is None:
        raise ValueError("weight_only_linear requires weight_scale")
    in_features = int(x.shape[-1])
    _group_check(in_features, group_size)
    w = _unpack_int4(weight, in_features) if weight_dtype == "int4" \
        else weight
    s = weight_scale
    if group_size != -1:
        s = s.repeat_interleave(group_size, dim=0)
    w = (w.to(torch.float32) * s).to(x.dtype)
    y = torch.matmul(x, w)
    return y if bias is None else y + bias


def llm_int8_linear(x, weight, bias=None, weight_scale=None,
                    threshold=6.0, name=None):
    """``paddle.nn.quant.llm_int8_linear``: the reference computes it as
    the int8 weight-only product (no outlier decomposition); so does the
    port."""
    return weight_only_linear(x, weight, bias=bias, weight_scale=weight_scale,
                              weight_dtype="int8")
