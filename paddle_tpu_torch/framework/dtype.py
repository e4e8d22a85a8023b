"""Paddle's dtype names (counterpart of ``paddle_tpu/framework/dtype.py``):
``paddle.float32`` and the rest are the torch dtypes of the same name;
``bool`` is ``torch.bool`` (exported at the top level as ``bool``). As in
the reference, the default dtype (float32 unless ``set_default_dtype``
says otherwise) is what ``to_tensor`` gives Python floats; it is the
port's own setting and leaves torch's ``get_default_dtype`` alone.
"""
from __future__ import annotations

import numpy as np
import torch

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128
float8_e4m3fn = torch.float8_e4m3fn
float8_e5m2 = torch.float8_e5m2

_STR_TO_DTYPE = {
    "bool": bool_, "uint8": uint8, "int8": int8, "int16": int16,
    "int32": int32, "int64": int64, "float16": float16,
    "bfloat16": bfloat16, "float32": float32, "float64": float64,
    "complex64": complex64, "complex128": complex128,
    "float8_e4m3fn": float8_e4m3fn, "float8_e5m2": float8_e5m2,
    # paddle's aliases
    "fp16": float16, "bf16": bfloat16, "fp32": float32, "fp64": float64,
}
_DEFAULT_CHOICES = (float16, bfloat16, float32, float64)

_default_dtype = float32


def set_default_dtype(d):
    """``paddle.set_default_dtype``: float16, bfloat16, float32 or float64;
    any other raises ``TypeError``."""
    global _default_dtype
    d = convert_dtype(d)
    if d not in _DEFAULT_CHOICES:
        raise TypeError("set_default_dtype only supports float16/bfloat16/"
                        f"float32/float64, got {d}")
    _default_dtype = d


def get_default_dtype():
    return _default_dtype


def is_dtype(x) -> bool:
    """Whether ``x`` names a dtype (a torch dtype or one of the names)."""
    return isinstance(x, torch.dtype) or (isinstance(x, str)
                                          and x in _STR_TO_DTYPE)


def convert_dtype(dtype):
    """A torch dtype from a name, a torch or numpy dtype, or ``bool`` /
    ``int`` / ``float`` (``float``: the default dtype); None stays None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        try:
            return _STR_TO_DTYPE[dtype.rsplit(".", 1)[-1]]
        except KeyError:
            raise ValueError(f"unknown dtype {dtype!r}") from None
    if dtype is bool:
        return bool_
    if dtype is int:
        return int64
    if dtype is float:
        return _default_dtype
    return convert_dtype(np.dtype(dtype).name)


def finfo(dtype):
    return torch.finfo(convert_dtype(dtype))


def iinfo(dtype):
    return torch.iinfo(convert_dtype(dtype))
