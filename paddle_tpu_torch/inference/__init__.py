"""Counterpart of ``paddle_tpu/inference``: continuous batching and its
AOT engine (``aot``)."""
from .predictor import ContinuousBatchingPredictor
from . import aot

__all__ = ["ContinuousBatchingPredictor", "aot"]
