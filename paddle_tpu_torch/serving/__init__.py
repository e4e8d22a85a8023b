"""The serving front end (counterpart of ``paddle_tpu/serving/``).

- :mod:`scheduler`: priority tiers with weighted deficit-round-robin
  fair queueing over the bounded admission queue, and the
  priority-aware shed policy (expired entries evicted before any shed,
  the lowest tier shed first, no tier shed below its weight share).
- :mod:`streaming`: token streams (``generate_stream`` /
  ``serve_stream`` yield tokens as decode ticks complete) with
  consumer-driven cancellation.

The reference's replica pool (``Router``, ``Replica``,
``RequestHandle``), its autoscale signals and its pool controller wait
for later slices of the port, with the observability registry they
read.
"""
from .scheduler import (  # noqa: F401
    DEFAULT_TIER, FifoQueue, WeightedFairScheduler, stage_cost,
)
from .streaming import (  # noqa: F401
    ServeRequest, StreamEvent, TokenStream,
)
from ..generation.sampling import SamplingParams  # noqa: F401

__all__ = [
    "FifoQueue", "WeightedFairScheduler", "DEFAULT_TIER", "stage_cost",
    "ServeRequest", "StreamEvent", "TokenStream", "SamplingParams",
]
