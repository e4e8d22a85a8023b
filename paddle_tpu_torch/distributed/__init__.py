"""Counterpart of ``paddle_tpu/distributed`` (verified checkpointing so
far)."""
from .checkpoint import VerifiedCheckpointer

__all__ = ["VerifiedCheckpointer"]
