"""Counterpart of ``paddle_tpu/inference`` (greedy continuous batching)."""
from .predictor import ContinuousBatchingPredictor

__all__ = ["ContinuousBatchingPredictor"]
