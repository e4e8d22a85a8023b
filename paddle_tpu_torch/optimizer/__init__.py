"""Counterpart of ``paddle_tpu/optimizer`` (Adam, AdamW and the cosine
LR schedule so far)."""
from . import lr  # noqa: F401
from .optimizer import Adam, AdamW, Optimizer

__all__ = ["Adam", "AdamW", "Optimizer", "lr"]
