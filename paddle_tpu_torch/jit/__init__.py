"""Counterpart of ``paddle_tpu/jit``: the train step (``bridge``) and
``save`` / ``load`` / ``InputSpec`` (``api``)."""
from .api import AOTLayer, InputSpec, TranslatedLayer, load, save
from .bridge import TrainStep

__all__ = ["AOTLayer", "InputSpec", "TrainStep", "TranslatedLayer", "load",
           "save"]
