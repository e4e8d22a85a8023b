"""Counterpart of ``paddle_tpu/inference``: continuous batching and its
AOT engine (``aot``)."""
from .predictor import ContinuousBatchingPredictor, DecodeWedgedError
from . import aot

__all__ = ["ContinuousBatchingPredictor", "DecodeWedgedError", "aot"]
