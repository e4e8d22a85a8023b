"""``paddle.vision.transforms`` (counterpart of
``paddle_tpu/vision/transforms.py``): every transform class and function
of the reference, on HWC numpy images (a PIL image is read as one), with
the same draws from Python's ``random`` (and, for ``RandomErasing``'s
"random" value, numpy's) in the same order, so that a seeded run draws
what the reference draws. ``ToTensor`` gives a CPU ``torch.Tensor``;
``Normalize`` takes one too, computes on the host and gives one back on
the tensor's device. A numpy image never touches a device, so the
transforms run alike in the main process and in the DataLoader's
workers.

``Resize`` is numpy's copy of the reference's ``jax.image.resize``
(``_resize_hw``): half-pixel centres, one weight matrix per resized axis
and two products in f32, with a triangle kernel (bilinear) or Keys'
cubic with a = -0.5 (bicubic; torch's bicubic uses -0.75), each widened
by the scale when it shrinks (antialiasing), and nearest as
``floor((i + 0.5) in / out)``; uint8 images go back by the truncating
``astype``. ``tests/test_torch_transforms.py`` holds it to the reference.
"""
from __future__ import annotations

import random as pyrandom

import numpy as np
import torch


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class BaseTransform:
    def __init__(self, keys=None):
        self.keys = keys

    def __call__(self, img):
        return self._apply_image(img)


def _img_hw(img):
    return img.shape[0], img.shape[1]


class Resize(BaseTransform):
    def __init__(self, size, interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = size
        self.interpolation = interpolation

    def _apply_image(self, img):
        arr = np.asarray(img)
        h, w = _img_hw(arr)
        if isinstance(self.size, int):
            if h < w:
                oh, ow = self.size, int(self.size * w / h)
            else:
                oh, ow = int(self.size * h / w), self.size
        else:
            oh, ow = self.size
        out = _resize_hw(arr.astype(np.float32), oh, ow, self.interpolation)
        return out.astype(arr.dtype)


def _triangle(x):
    return np.maximum(np.float32(0), 1 - np.abs(x))


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.
    out = np.where(x >= 1., ((-0.5 * x + 2.5) * x - 4.) * x + 2., out)
    return np.where(x >= 2., np.float32(0), out).astype(np.float32)


def _weight_mat(n_in, n_out, kernel):
    """[n_in, n_out] f32 weights of ``jax.image.scale_and_translate`` at
    scale n_out / n_in, no translation, antialiased."""
    inv_scale = np.float32(1.0 / (n_out / n_in))   # f64, then f32: as jax
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample_f = ((np.arange(n_out, dtype=np.float32) + np.float32(0.5))
                * inv_scale - np.float32(0.5))
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=np.float32)[:, None]
               ) / kernel_scale
    weights = kernel(x.astype(np.float32))
    total = weights.sum(axis=0, keepdims=True, dtype=np.float32)
    weights = np.where(np.abs(total) > 1000. * float(np.finfo(np.float32).eps),
                       weights / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], weights, 0).astype(np.float32)


def _resize_hw(arr, oh, ow, interpolation):
    """f32 ``arr`` [H, W, ...] resized to [oh, ow, ...] as the reference's
    ``jax.image.resize`` resizes it; an axis whose size stays is left
    alone."""
    h, w = arr.shape[:2]
    if interpolation == "nearest":
        for axis, (n_in, n_out) in enumerate(((h, oh), (w, ow))):
            if n_in != n_out:
                idx = np.floor(((np.arange(n_out, dtype=np.float32) + 0.5)
                                * n_in / n_out).astype(np.float32))
                arr = np.take(arr, idx.astype(np.int32), axis=axis)
        return arr
    kernel = {"bilinear": _triangle, "bicubic": _keys_cubic}[interpolation]
    if h != oh:
        arr = np.tensordot(_weight_mat(h, oh, kernel), arr, axes=([0], [0]))
    if w != ow:
        arr = np.moveaxis(np.tensordot(arr, _weight_mat(w, ow, kernel),
                                       axes=([1], [0])), -1, 1)
    return np.ascontiguousarray(arr, dtype=np.float32)


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False, fill=0,
                 padding_mode="constant", keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.padding = padding

    def _apply_image(self, img):
        arr = np.asarray(img)
        if self.padding:
            p = self.padding if isinstance(self.padding, (list, tuple)) \
                else [self.padding] * 4
            arr = np.pad(arr, ((p[1], p[3]), (p[0], p[2]))
                         + ((0, 0),) * (arr.ndim - 2))
        h, w = _img_hw(arr)
        th, tw = self.size
        i = pyrandom.randint(0, max(h - th, 0))
        j = pyrandom.randint(0, max(w - tw, 0))
        return arr[i:i + th, j:j + tw]


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def _apply_image(self, img):
        arr = np.asarray(img)
        h, w = _img_hw(arr)
        th, tw = self.size
        i = max((h - th) // 2, 0)
        j = max((w - tw) // 2, 0)
        return arr[i:i + th, j:j + tw]


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        if pyrandom.random() < self.prob:
            return np.asarray(img)[:, ::-1].copy()
        return np.asarray(img)


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None):
        super().__init__(keys)
        self.prob = prob

    def _apply_image(self, img):
        if pyrandom.random() < self.prob:
            return np.asarray(img)[::-1].copy()
        return np.asarray(img)


class RandomResizedCrop(BaseTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation="bilinear", keys=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.ratio = ratio
        self._resize = Resize(self.size, interpolation)

    def _apply_image(self, img):
        arr = np.asarray(img)
        h, w = _img_hw(arr)
        area = h * w
        for _ in range(10):
            target_area = area * pyrandom.uniform(*self.scale)
            ar = pyrandom.uniform(*self.ratio)
            tw = int(round(np.sqrt(target_area * ar)))
            th = int(round(np.sqrt(target_area / ar)))
            if 0 < tw <= w and 0 < th <= h:
                i = pyrandom.randint(0, h - th)
                j = pyrandom.randint(0, w - tw)
                crop = arr[i:i + th, j:j + tw]
                return self._resize(crop)
        return self._resize(CenterCrop(min(h, w))(arr))


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format="CHW", to_rgb=False,
                 keys=None):
        super().__init__(keys)
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.data_format = data_format

    def _apply_image(self, img):
        was_tensor = isinstance(img, torch.Tensor)
        arr = np.asarray(img.detach().cpu().numpy() if was_tensor else img,
                         np.float32)
        if self.data_format == "CHW":
            m = self.mean.reshape(-1, 1, 1)
            s = self.std.reshape(-1, 1, 1)
        else:
            m = self.mean
            s = self.std
        out = (arr - m) / s
        if was_tensor:
            return torch.from_numpy(out.astype(np.float32)).to(img.device)
        return out


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1), keys=None):
        super().__init__(keys)
        self.order = order

    def _apply_image(self, img):
        arr = np.asarray(img)
        if arr.ndim == 2:
            arr = arr[..., None]
        return arr.transpose(self.order)


class ToTensor(BaseTransform):
    def __init__(self, data_format="CHW", keys=None):
        super().__init__(keys)
        self.data_format = data_format

    def _apply_image(self, img):
        arr = np.asarray(img)
        if arr.ndim == 2:
            arr = arr[..., None]
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32) / 255.0
        if self.data_format == "CHW":
            arr = arr.transpose(2, 0, 1)
        return torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))


class BrightnessTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        arr = np.asarray(img, np.float32)
        alpha = 1 + pyrandom.uniform(-self.value, self.value)
        return np.clip(arr * alpha, 0, 255).astype(np.asarray(img).dtype)


class ColorJitter(BaseTransform):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 keys=None):
        super().__init__(keys)
        self._brightness = brightness
        self._contrast = contrast
        self._saturation = saturation
        self._hue = hue

    def _apply_image(self, img):
        # forward references — the photometric transforms are defined
        # below in this module; apply in random order (reference
        # behavior)
        ts = [BrightnessTransform(self._brightness),
              ContrastTransform(self._contrast),
              SaturationTransform(self._saturation),
              HueTransform(self._hue)]
        pyrandom.shuffle(ts)
        for t in ts:
            img = t(img)
        return img


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode="constant", keys=None):
        super().__init__(keys)
        if isinstance(padding, int):
            padding = [padding] * 4
        self.padding = padding
        self.fill = fill

    def _apply_image(self, img):
        arr = np.asarray(img)
        p = self.padding
        width = ((p[1], p[3]), (p[0], p[2])) + ((0, 0),) * (arr.ndim - 2)
        return np.pad(arr, width, constant_values=self.fill)


def normalize(img, mean, std, data_format="CHW", to_rgb=False):
    return Normalize(mean, std, data_format)(img)


def to_tensor_fn(img, data_format="CHW"):
    return ToTensor(data_format)(img)


def resize(img, size, interpolation="bilinear"):
    return Resize(size, interpolation)(img)


def hflip(img):
    return np.asarray(img)[:, ::-1].copy()


def vflip(img):
    return np.asarray(img)[::-1].copy()


# --------------------------------------------------------------------------
# photometric functional ops (parity: python/paddle/vision/transforms/
# functional.py — host-side numpy preprocessing, HWC uint8/float)
# --------------------------------------------------------------------------

def _blend(a, b, alpha):
    out = np.asarray(a, np.float32) * alpha + np.asarray(b, np.float32) \
        * (1 - alpha)
    # value range follows the dtype: float images live in [0, 1],
    # integer images in [0, 255] (r5 fuzz find — float inputs were
    # clipped at 255, i.e. never)
    hi = 255 if np.issubdtype(np.asarray(a).dtype, np.integer) else 1.0
    return np.clip(out, 0, hi).astype(np.asarray(a).dtype)


def adjust_brightness(img, brightness_factor):
    return _blend(img, np.zeros_like(np.asarray(img)), brightness_factor)


def adjust_contrast(img, contrast_factor):
    arr = np.asarray(img, np.float32)
    mean = to_grayscale(arr).mean()
    return _blend(img, np.full_like(arr, mean), contrast_factor)


def adjust_saturation(img, saturation_factor):
    gray = to_grayscale(np.asarray(img), num_output_channels=3)
    return _blend(img, gray, saturation_factor)


def adjust_hue(img, hue_factor):
    """hue_factor in [-0.5, 0.5] — rotate the hue channel in HSV."""
    if not -0.5 <= hue_factor <= 0.5:
        raise ValueError("hue_factor must be in [-0.5, 0.5]")
    arr = np.asarray(img, np.float32) / 255.0
    r, g, b = arr[..., 0], arr[..., 1], arr[..., 2]
    maxc = arr[..., :3].max(-1)
    minc = arr[..., :3].min(-1)
    v = maxc
    d = maxc - minc
    s = np.where(maxc > 0, d / np.maximum(maxc, 1e-12), 0)
    dz = np.maximum(d, 1e-12)
    rc, gc, bc = (maxc - r) / dz, (maxc - g) / dz, (maxc - b) / dz
    h = np.where(maxc == r, bc - gc,
                 np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = (h / 6.0) % 1.0
    h = np.where(d == 0, 0.0, h)
    h = (h + hue_factor) % 1.0
    # hsv -> rgb
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = i.astype(np.int32) % 6
    r2 = np.choose(i, [v, q, p, p, t, v])
    g2 = np.choose(i, [t, v, v, q, p, p])
    b2 = np.choose(i, [p, p, t, v, v, q])
    out = np.stack([r2, g2, b2], axis=-1) * 255.0
    return np.clip(out, 0, 255).astype(np.asarray(img).dtype)


def to_grayscale(img, num_output_channels=1):
    arr = np.asarray(img, np.float32)
    gray = (arr[..., 0] * 0.299 + arr[..., 1] * 0.587
            + arr[..., 2] * 0.114)
    gray = gray[..., None]
    if num_output_channels == 3:
        gray = np.repeat(gray, 3, axis=-1)
    return gray.astype(np.asarray(img).dtype)


def crop(img, top, left, height, width):
    return np.asarray(img)[top:top + height, left:left + width].copy()


def center_crop(img, output_size):
    h, w = _img_hw(img)
    oh, ow = ((output_size, output_size) if isinstance(output_size, int)
              else tuple(output_size))
    # round(), not floor: the upstream/torchvision origin convention
    # (differs for odd margins — r5 fuzz find)
    return crop(img, int(round((h - oh) / 2.0)),
                int(round((w - ow) / 2.0)), oh, ow)


def pad(img, padding, fill=0, padding_mode="constant"):
    return Pad(padding, fill, padding_mode)(img)


def erase(img, i, j, h, w, v, inplace=False):
    """Parity: paddle.vision.transforms.erase."""
    arr = np.asarray(img) if inplace else np.asarray(img).copy()
    arr[i:i + h, j:j + w] = v
    return arr


def _inverse_warp(img, inv_matrix, fill=0):
    """Apply a 3x3 inverse affine/projective map with bilinear sampling
    (HWC numpy; the host-side twin of ops/_sampling.py)."""
    arr = np.asarray(img, np.float32)
    h, w = arr.shape[:2]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    ones = np.ones_like(xs)
    coords = np.stack([xs, ys, ones], axis=-1) @ np.asarray(
        inv_matrix, np.float32).T
    cx = coords[..., 0] / np.maximum(coords[..., 2], 1e-9)
    cy = coords[..., 1] / np.maximum(coords[..., 2], 1e-9)
    x0, y0 = np.floor(cx).astype(int), np.floor(cy).astype(int)
    valid = (cx >= -1) & (cx <= w) & (cy >= -1) & (cy <= h)

    def g(yi, xi):
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        out = arr[np.clip(yi, 0, h - 1), np.clip(xi, 0, w - 1)]
        return np.where(inside[..., None], out, fill)

    wx, wy = cx - x0, cy - y0
    out = (g(y0, x0) * ((1 - wy) * (1 - wx))[..., None]
           + g(y0, x0 + 1) * ((1 - wy) * wx)[..., None]
           + g(y0 + 1, x0) * (wy * (1 - wx))[..., None]
           + g(y0 + 1, x0 + 1) * (wy * wx)[..., None])
    out = np.where(valid[..., None], out, fill)
    return np.clip(out, 0, 255).astype(np.asarray(img).dtype)


def _affine_inv(center, angle, translate, scale, shear):
    cx, cy = center
    rot = np.deg2rad(angle)
    sx, sy = (np.deg2rad(s) for s in (shear if isinstance(
        shear, (list, tuple)) else (shear, 0.0)))
    # forward: T(translate) C R(angle, shear) S C^-1 ; invert analytically
    a = np.cos(rot - sy) / max(np.cos(sy), 1e-9)
    b = -np.cos(rot - sy) * np.tan(sx) / max(np.cos(sy), 1e-9) \
        - np.sin(rot)
    c = np.sin(rot - sy) / max(np.cos(sy), 1e-9)
    d = -np.sin(rot - sy) * np.tan(sx) / max(np.cos(sy), 1e-9) \
        + np.cos(rot)
    fwd = np.array([[a * scale, b * scale, 0.0],
                    [c * scale, d * scale, 0.0],
                    [0.0, 0.0, 1.0]], np.float32)
    pre = np.array([[1, 0, cx + translate[0]], [0, 1, cy + translate[1]],
                    [0, 0, 1]], np.float32)
    post = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1]], np.float32)
    m = pre @ fwd @ post
    return np.linalg.inv(m)


def affine(img, angle=0.0, translate=(0, 0), scale=1.0, shear=(0.0, 0.0),
           interpolation="bilinear", fill=0, center=None):
    h, w = _img_hw(img)
    ctr = center if center is not None else ((w - 1) / 2, (h - 1) / 2)
    return _inverse_warp(img, _affine_inv(ctr, angle, translate, scale,
                                          shear), fill)


def rotate(img, angle, interpolation="bilinear", expand=False, center=None,
           fill=0):
    return affine(img, angle=angle, fill=fill, center=center)


def perspective(img, startpoints, endpoints, interpolation="bilinear",
                fill=0):
    """Projective warp mapping startpoints -> endpoints (4 corners)."""
    a = []
    bvec = []
    for (x, y), (u, v) in zip(endpoints, startpoints):
        a.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        a.append([0, 0, 0, x, y, 1, -v * x, -v * y])
        bvec.extend([u, v])
    coeff = np.linalg.solve(np.asarray(a, np.float64),
                            np.asarray(bvec, np.float64))
    inv = np.append(coeff, 1.0).reshape(3, 3)
    return _inverse_warp(img, inv, fill)


# --------------------------------------------------------------------------
# photometric / geometric transform classes
# --------------------------------------------------------------------------

class ContrastTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        return adjust_contrast(
            img, 1 + pyrandom.uniform(-self.value, self.value))


class SaturationTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        return adjust_saturation(
            img, 1 + pyrandom.uniform(-self.value, self.value))


class HueTransform(BaseTransform):
    def __init__(self, value, keys=None):
        super().__init__(keys)
        self.value = value

    def _apply_image(self, img):
        if self.value == 0:
            return img
        return adjust_hue(img, pyrandom.uniform(-self.value, self.value))


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1, keys=None):
        super().__init__(keys)
        self.n = num_output_channels

    def _apply_image(self, img):
        return to_grayscale(img, self.n)


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation="nearest", expand=False,
                 center=None, fill=0, keys=None):
        super().__init__(keys)
        self.degrees = ((-degrees, degrees)
                        if isinstance(degrees, (int, float)) else degrees)
        self.center, self.fill = center, fill

    def _apply_image(self, img):
        return rotate(img, pyrandom.uniform(*self.degrees),
                      center=self.center, fill=self.fill)


class RandomErasing(BaseTransform):
    """Parity: paddle.vision.transforms.RandomErasing (Zhong et al.)."""

    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value=0, inplace=False, keys=None):
        super().__init__(keys)
        self.prob, self.scale, self.ratio = prob, scale, ratio
        self.value, self.inplace = value, inplace

    def _apply_image(self, img):
        if pyrandom.random() > self.prob:
            return img
        arr = np.asarray(img)
        h, w = arr.shape[:2]
        area = h * w
        for _ in range(10):
            target = pyrandom.uniform(*self.scale) * area
            ar = pyrandom.uniform(*self.ratio)
            eh = int(round(np.sqrt(target * ar)))
            ew = int(round(np.sqrt(target / ar)))
            if eh < h and ew < w:
                i = pyrandom.randint(0, h - eh)
                j = pyrandom.randint(0, w - ew)
                v = (np.random.randn(eh, ew, *arr.shape[2:])
                     if self.value == "random" else self.value)
                return erase(arr, i, j, eh, ew, v, self.inplace)
        return img


class RandomAffine(BaseTransform):
    def __init__(self, degrees, translate=None, scale=None, shear=None,
                 interpolation="nearest", fill=0, center=None, keys=None):
        super().__init__(keys)
        self.degrees = ((-degrees, degrees)
                        if isinstance(degrees, (int, float)) else degrees)
        self.translate, self.scale_rng = translate, scale
        self.shear, self.fill, self.center = shear, fill, center

    def _apply_image(self, img):
        h, w = _img_hw(img)
        angle = pyrandom.uniform(*self.degrees)
        tx = ty = 0
        if self.translate is not None:
            tx = pyrandom.uniform(-self.translate[0], self.translate[0]) * w
            ty = pyrandom.uniform(-self.translate[1], self.translate[1]) * h
        sc = (pyrandom.uniform(*self.scale_rng)
              if self.scale_rng is not None else 1.0)
        sh = (0.0, 0.0)
        if self.shear is not None:
            srange = ((-self.shear, self.shear)
                      if isinstance(self.shear, (int, float))
                      else self.shear)
            sh = (pyrandom.uniform(*srange[:2]), 0.0)
        return affine(img, angle=angle, translate=(tx, ty), scale=sc,
                      shear=sh, fill=self.fill, center=self.center)


class RandomPerspective(BaseTransform):
    def __init__(self, prob=0.5, distortion_scale=0.5,
                 interpolation="nearest", fill=0, keys=None):
        super().__init__(keys)
        self.prob = prob
        self.d = distortion_scale
        self.fill = fill

    def _apply_image(self, img):
        if pyrandom.random() > self.prob:
            return img
        h, w = _img_hw(img)
        dx, dy = self.d * w / 2, self.d * h / 2
        start = [(0, 0), (w - 1, 0), (w - 1, h - 1), (0, h - 1)]
        end = [(pyrandom.uniform(0, dx), pyrandom.uniform(0, dy)),
               (w - 1 - pyrandom.uniform(0, dx), pyrandom.uniform(0, dy)),
               (w - 1 - pyrandom.uniform(0, dx),
                h - 1 - pyrandom.uniform(0, dy)),
               (pyrandom.uniform(0, dx), h - 1 - pyrandom.uniform(0, dy))]
        return perspective(img, start, end, fill=self.fill)


# ``transforms.functional`` is a submodule upstream; transforms_functional
# imports back from this module, which is safe here because every
# functional def is above this line. Registered in sys.modules, every
# upstream import form works (``import ...transforms.functional as F``,
# ``from ...transforms.functional import resize``).
import sys as _sys  # noqa: E402
from . import transforms_functional as functional  # noqa: E402
_sys.modules[__name__ + ".functional"] = functional
