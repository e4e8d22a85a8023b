"""Counterpart of ``paddle_tpu/distributed/fleet`` (activation recompute
so far)."""
from .recompute import recompute, recompute_hybrid, recompute_sequential

__all__ = ["recompute", "recompute_sequential", "recompute_hybrid"]
