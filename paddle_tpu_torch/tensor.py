"""``paddle.to_tensor`` and ``paddle.create_parameter`` (counterpart of
``paddle_tpu/tensor.py`` ``to_tensor`` and the reference's top-level
``create_parameter``). The port's tensor is ``torch.Tensor``; the
reference's ``Tensor`` methods wait for the port of ``ops``.
"""
from __future__ import annotations

import numpy as np
import torch

from .framework import dtype as dtypes
from .framework import resolve_device


def _contains_np(data) -> bool:
    if isinstance(data, np.ndarray):
        return True
    if isinstance(data, (list, tuple)):
        return any(_contains_np(x) for x in data)
    return False


def _host_tensor(arr, d):
    if d == torch.bfloat16 or arr.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own: go through float32
        return torch.from_numpy(np.asarray(arr, np.float32)).to(d)
    return torch.from_numpy(np.array(arr, copy=True)).to(d)


def to_tensor(data, dtype=None, place=None, stop_gradient=True):
    """A new tensor holding ``data``, with the reference's dtype rules:
    Python floats take the default dtype (float32), Python ints int64,
    numpy arrays and tensors keep theirs unless ``dtype`` is given. It
    lies on ``place``, else on ``set_device``'s choice, else on the CUDA
    device (raising without one). ``requires_grad`` is ``not
    stop_gradient`` for a floating or complex tensor."""
    d = dtypes.convert_dtype(dtype)
    dev = resolve_device(place)
    if isinstance(data, torch.Tensor):
        t = data.detach().to(device=dev, dtype=d or data.dtype, copy=True)
    else:
        arr = np.asarray(data)
        if d is None:
            native = isinstance(data, np.ndarray) or (
                isinstance(data, (list, tuple)) and _contains_np(data))
            if arr.dtype == np.float64 and not native:
                d = dtypes.get_default_dtype()
            elif arr.dtype in (np.int32, np.int64) and \
                    not isinstance(data, np.ndarray):
                d = dtypes.int64
            else:
                d = dtypes.convert_dtype(arr.dtype)
        t = _host_tensor(arr, d).to(dev)
    if not stop_gradient and (t.is_floating_point() or t.is_complex()):
        t.requires_grad_(True)
    return t


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None, *, device=None):
    """``paddle.create_parameter``: a parameter drawn as a layer's
    ``create_parameter`` draws it (on ``device``, else torch's default
    device, as the port's layers), named ``name``."""
    from .nn.initializer import create_parameter as create
    p = create(shape, attr, dtypes.convert_dtype(dtype), is_bias,
               default_initializer, device=device)
    if p is not None and name is not None:
        p.name = name
    return p
