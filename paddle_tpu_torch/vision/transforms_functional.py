"""``paddle.vision.transforms.functional`` (counterpart of
``paddle_tpu/vision/transforms_functional.py``): the functional forms of
the transforms.

numpy and PIL images are HWC, as in ``transforms``. A ``torch.Tensor``
image is CHW (the upstream tensor contract): it is transposed to HWC,
transformed on the host, and comes back as a CHW tensor on the device
it came from; a tensor that is not 3-D raises rather than being
transformed along the wrong axes.
``erase`` works on a CHW tensor in its own layout, with a (C, h, w)
value.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import transforms as _T
from .transforms import to_tensor_fn as to_tensor  # noqa: F401


def _wrap_chw(fn):
    @functools.wraps(fn)
    def wrapped(img, *args, **kwargs):
        if isinstance(img, torch.Tensor):
            arr = img.detach().cpu().numpy()
            if arr.ndim != 3:
                raise ValueError(
                    f"{fn.__name__}: Tensor images must be 3-D CHW, got "
                    f"shape {tuple(arr.shape)} (apply per image for "
                    "batches)")
            out = fn(arr.transpose(1, 2, 0), *args, **kwargs)
            if isinstance(out, np.ndarray) and out.ndim == 3:
                out = out.transpose(2, 0, 1)
            return torch.from_numpy(np.ascontiguousarray(out)).to(img.device)
        return fn(img, *args, **kwargs)
    return wrapped


resize = _wrap_chw(_T.resize)
hflip = _wrap_chw(_T.hflip)
vflip = _wrap_chw(_T.vflip)
adjust_brightness = _wrap_chw(_T.adjust_brightness)
adjust_contrast = _wrap_chw(_T.adjust_contrast)
adjust_saturation = _wrap_chw(_T.adjust_saturation)
adjust_hue = _wrap_chw(_T.adjust_hue)
to_grayscale = _wrap_chw(_T.to_grayscale)
crop = _wrap_chw(_T.crop)
center_crop = _wrap_chw(_T.center_crop)
pad = _wrap_chw(_T.pad)
affine = _wrap_chw(_T.affine)
rotate = _wrap_chw(_T.rotate)
perspective = _wrap_chw(_T.perspective)


def erase(img, i, j, h, w, v, inplace=False):
    """Rows ``i:i+h`` and columns ``j:j+w`` set to ``v``: of a CHW tensor
    in its own layout (``v`` broadcast as (C, h, w); ``inplace`` writes
    into ``img``), else of an HWC image."""
    if isinstance(img, torch.Tensor):
        out = img if inplace else img.clone()
        val = v if isinstance(v, torch.Tensor) else torch.as_tensor(
            np.asarray(v), dtype=img.dtype)
        out[..., i:i + h, j:j + w] = val.to(img.device)
        return out
    return _T.erase(img, i, j, h, w, v, inplace)


# Normalize takes Tensor inputs and data_format itself
normalize = _T.normalize


__all__ = ["normalize", "resize", "hflip", "vflip", "adjust_brightness",
           "adjust_contrast", "adjust_saturation", "adjust_hue",
           "to_grayscale", "crop", "center_crop", "pad", "erase",
           "affine", "rotate", "perspective", "to_tensor"]
