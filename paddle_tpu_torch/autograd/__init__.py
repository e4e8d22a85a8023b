"""Grad mode (counterpart of ``paddle_tpu/autograd/grad_mode.py``):
``no_grad``, ``enable_grad``, ``is_grad_enabled`` and
``set_grad_enabled``, which are torch's grad mode under the reference's
names. ``no_grad()`` and ``enable_grad()`` work as context managers and
as decorators; ``set_grad_enabled(mode)`` sets the mode at once and, as a
context manager, puts the old one back on exit.
"""
import torch


class no_grad(torch.no_grad):
    """``paddle.no_grad``: no autograd graph inside."""

    def __init__(self):
        super().__init__()


class enable_grad(torch.enable_grad):
    """``paddle.enable_grad``: autograd on inside (e.g. within a
    ``no_grad``)."""

    def __init__(self):
        super().__init__()


def is_grad_enabled():
    return torch.is_grad_enabled()


def set_grad_enabled(mode):
    return torch.set_grad_enabled(mode)


__all__ = ["enable_grad", "is_grad_enabled", "no_grad", "set_grad_enabled"]
