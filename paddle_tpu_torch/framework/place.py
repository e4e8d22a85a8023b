"""Device selection (counterpart of ``paddle_tpu/framework/place.py``):
``set_device`` / ``get_device``, ``CPUPlace`` and ``CUDAPlace``.

``set_device`` takes ``"gpu"``, ``"gpu:N"``, ``"cuda"``, ``"cuda:N"`` or
``"cpu"`` (or a place) and is process-wide: ``framework.resolve_device``
reads it first, so a model or tensor built without a device lands there.
The reference's TPU names raise. Unlike the reference, which falls back
to the CPU when no accelerator is present, ``get_device()`` without a
``set_device`` choice names the current CUDA device and raises when there
is none, as ``resolve_device`` does.
"""
from __future__ import annotations

import torch

_KINDS = ("cpu", "gpu", "cuda")


class Place:
    """A device handle: ``kind`` ("cpu" or "gpu") and ``device_id``."""

    _kind = "undefined"

    def __init__(self, device_id=0):
        self._device_id = int(device_id)

    def get_device_id(self):
        return self._device_id

    @property
    def torch_device(self) -> torch.device:
        return torch.device("cpu") if self._kind == "cpu" \
            else torch.device("cuda", self._device_id)

    def __eq__(self, other):
        return (isinstance(other, Place) and self._kind == other._kind
                and self._device_id == other._device_id)

    def __hash__(self):
        return hash((self._kind, self._device_id))

    def __repr__(self):
        return "Place(cpu)" if self._kind == "cpu" \
            else f"Place(gpu:{self._device_id})"


class CPUPlace(Place):
    _kind = "cpu"


class CUDAPlace(Place):
    _kind = "gpu"


_current = None


def _parse_place(device) -> Place:
    if isinstance(device, Place):
        return device
    if isinstance(device, torch.device):
        device = str(device)
    kind, _, idx = str(device).lower().partition(":")
    if kind not in _KINDS:
        raise ValueError(
            f"unknown device {device!r}: this package runs on "
            "'gpu' / 'gpu:N' (or 'cuda' / 'cuda:N') and 'cpu'")
    if kind == "cpu":
        return CPUPlace(int(idx or 0))
    return CUDAPlace(int(idx) if idx else torch.cuda.current_device()
                     if torch.cuda.is_available() else 0)


def set_device(device) -> Place:
    """``paddle.set_device``: the device later models and tensors take when
    none is named; returns its place."""
    global _current
    _current = _parse_place(device)
    return _current


def current_place():
    """``set_device``'s choice, or None."""
    return _current


def get_device() -> str:
    """``"cpu"`` or ``"gpu:N"``: ``set_device``'s choice, else the current
    CUDA device; raises when neither is there."""
    from . import resolve_device
    dev = resolve_device(None)
    return "cpu" if dev.type == "cpu" else f"gpu:{dev.index}"


def to_torch_device(device) -> torch.device:
    """A torch device from a torch device, a place or a name (``gpu`` is
    ``cuda``)."""
    if isinstance(device, Place):
        return device.torch_device
    if isinstance(device, str) and device.lower().startswith("gpu"):
        return _parse_place(device).torch_device
    return torch.device(device)
