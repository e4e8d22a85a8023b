"""Counterpart of ``paddle_tpu/nn`` (only what the Llama serving and
pretraining paths use)."""
from . import functional  # noqa: F401
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue"]
