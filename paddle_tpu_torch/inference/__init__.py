"""Counterpart of ``paddle_tpu/inference``: the Paddle Inference API
(``Config``, ``create_predictor``, ``Predictor``), the batched and
speculative LLM predictors, continuous batching and its AOT engine
(``aot``)."""
from .api import (Config, PlaceType, PrecisionType, Predictor,
                  convert_to_mixed_precision, create_predictor)
from .llm import LLMPredictor, SpeculativePredictor
from .predictor import ContinuousBatchingPredictor, DecodeWedgedError
from . import aot

__all__ = ["Config", "ContinuousBatchingPredictor", "DecodeWedgedError",
           "LLMPredictor", "PlaceType", "PrecisionType", "Predictor",
           "SpeculativePredictor", "aot", "convert_to_mixed_precision",
           "create_predictor"]
