"""Shape and layout ops of ``paddle_tpu/ops/manipulation.py`` that the
vision models call: ``concat``, ``flatten``, ``reshape``, ``transpose``
and ``split``, with the reference's signatures and meaning. ``split``'s
int ``num_or_sections`` is the number of equal parts, which must divide
the axis (torch's int is a part's size); a list gives each part's size,
one of them -1 for the rest. The other ops wait for the rest of
``ops``.
"""
from __future__ import annotations

import torch

__all__ = ["concat", "flatten", "reshape", "split", "transpose"]


def _int(v):
    return int(v.item()) if isinstance(v, torch.Tensor) else int(v)


def _static_shape(shape):
    if isinstance(shape, torch.Tensor):
        return tuple(int(s) for s in shape.tolist())
    return tuple(_int(s) for s in shape)


def reshape(x, shape, name=None):
    return x.reshape(_static_shape(shape))


def transpose(x, perm=None, name=None):
    if perm is None:
        perm = list(reversed(range(x.dim())))
    return x.permute(*[int(p) for p in perm])


def concat(x, axis=0, name=None):
    return torch.cat(list(x), dim=_int(axis))


def split(x, num_or_sections, axis=0, name=None):
    """A tuple of parts of ``x`` along ``axis``."""
    ax = _int(axis)
    dim = x.shape[ax]
    if isinstance(num_or_sections, int):
        if dim % num_or_sections:
            raise ValueError(
                f"paddle.split: axis {ax} (size {dim}) is not divisible "
                f"by num_or_sections={num_or_sections}; pass a sections "
                "list for uneven splits")
        secs = [dim // num_or_sections] * num_or_sections
    else:
        secs = [_int(s) for s in num_or_sections]
        if -1 in secs:
            secs[secs.index(-1)] = dim - sum(s for s in secs if s != -1)
    return tuple(torch.split(x, secs, dim=ax))


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    """Axes ``start_axis`` to ``stop_axis`` merged into one."""
    if x.dim() == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis % x.dim(), stop_axis % x.dim())
