"""Counterpart of ``paddle_tpu/optimizer`` (Adam, AdamW and the cosine,
polynomial and linear-warmup LR schedules so far)."""
from . import lr  # noqa: F401
from .optimizer import Adam, AdamW, Optimizer

__all__ = ["Adam", "AdamW", "Optimizer", "lr"]
