"""``paddle.save`` / ``paddle.load`` (counterpart of
``paddle_tpu/framework_io.py``): pickles of nested state (dicts, lists,
tuples) whose tensors travel as the port's own ``TensorPayload`` (a numpy
array, bf16 as its uint16 bits, and a dtype tag), so the files hold no
torch object.

``load`` also reads the plain dict-of-numpy pickles that ``jit.save``
writes (``.pdiparams``, the reference's format, which either package
writes): every array becomes a tensor, and the names in ``bf16_keys``
(the ``.pdmodel``'s list) are read back from their uint16 bits. The
reference's own ``paddle.save`` files pickle ITS payload class and are
not read here.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

_PROTOCOL = 4


class TensorPayload:
    """A tensor as pickled data: ``array`` (bf16 as uint16 bits) and
    ``dtype_name``."""
    __slots__ = ("array", "dtype_name")

    def __init__(self, t: torch.Tensor):
        self.dtype_name = str(t.dtype).replace("torch.", "")
        self.array = bf16_to_bits(t).copy()

    def restore(self) -> torch.Tensor:
        t = torch.from_numpy(np.array(self.array, copy=True))
        return t.view(torch.bfloat16) if self.dtype_name == "bfloat16" \
            else t


def bf16_to_bits(t: torch.Tensor) -> np.ndarray:
    """A tensor as a numpy array, bf16 as its uint16 bits (numpy has no
    bfloat16)."""
    t = t.detach().cpu().contiguous()
    return (t.view(torch.uint16) if t.dtype == torch.bfloat16
            else t).numpy()


def _pack(obj):
    if isinstance(obj, torch.Tensor):
        return TensorPayload(obj)
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pack(v) for v in obj)
    return obj


def _out(t, return_numpy):
    if not return_numpy:
        return t
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _unpack(obj, return_numpy, bf16, key=None):
    if isinstance(obj, TensorPayload):
        return _out(obj.restore(), return_numpy)
    if isinstance(obj, np.ndarray):
        t = torch.from_numpy(np.array(obj, copy=True))
        return _out(t.view(torch.bfloat16) if key in bf16 else t,
                    return_numpy)
    if isinstance(obj, dict):
        return {k: _unpack(v, return_numpy, bf16, k) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unpack(v, return_numpy, bf16) for v in obj)
    return obj


def save(obj, path, protocol=_PROTOCOL, **configs):
    """paddle.save: ``obj`` (nested dicts, lists and tuples of tensors and
    plain values) pickled with every tensor as a ``TensorPayload``."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_pack(obj), f, protocol=protocol)


def holds_payloads(obj) -> bool:
    """Whether a loaded pickle came from ``save`` (tensors as
    ``TensorPayload``) rather than ``jit.save`` (plain numpy arrays)."""
    if isinstance(obj, TensorPayload):
        return True
    if isinstance(obj, dict):
        return any(holds_payloads(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return any(holds_payloads(v) for v in obj)
    return False


def load_raw(path):
    """The pickled object of ``path`` as it is (payloads not restored)."""
    with open(path, "rb") as f:
        return pickle.load(f)


def load(path, return_numpy=False, bf16_keys=(), **configs):
    """paddle.load: the nested state of ``path`` with tensors restored
    (numpy arrays with ``return_numpy``, bf16 as f32 there). A plain
    dict-of-numpy pickle (``.pdiparams``) loads too, the arrays named in
    ``bf16_keys`` read from their uint16 bits."""
    return restore(load_raw(path), return_numpy, bf16_keys)


def restore(obj, return_numpy=False, bf16_keys=()):
    """``load``'s second half, on an object from ``load_raw``."""
    return _unpack(obj, return_numpy, set(bf16_keys))
