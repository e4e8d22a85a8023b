"""Counterpart of ``paddle_tpu/jit`` (the train step so far)."""
from .bridge import TrainStep

__all__ = ["TrainStep"]
