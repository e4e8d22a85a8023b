"""Counterpart of ``paddle_tpu/optimizer`` (SGD, Momentum, Adam, AdamW,
the fused multi-tensor step, and the LR schedules of ``optimizer.lr``)."""
from . import lr  # noqa: F401
from .optimizer import SGD, Adam, AdamW, Momentum, Optimizer

__all__ = ["Adam", "AdamW", "Momentum", "Optimizer", "SGD", "lr"]
