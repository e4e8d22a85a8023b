"""High-level API (counterpart of ``paddle_tpu/hapi``): ``Model``,
``summary``, ``callbacks`` and ``flops``."""
from . import callbacks
from .flops import flops
from .model import Model, summary

__all__ = ["Model", "callbacks", "flops", "summary"]
