"""The serving front end (counterpart of ``paddle_tpu/serving/``).

- :mod:`scheduler`: priority tiers with weighted deficit-round-robin
  fair queueing over the bounded admission queue, and the
  priority-aware shed policy (expired entries evicted before any shed,
  the lowest tier shed first, no tier shed below its weight share).
- :mod:`streaming`: token streams (``generate_stream`` /
  ``serve_stream`` yield tokens as decode ticks complete) with
  consumer-driven cancellation.
- :mod:`router`: a replica pool fronting N predictors on one device,
  one worker thread each, routing by prefix-cache affinity with
  least-loaded fallback, per-replica health (re-admission once,
  ejection), and disaggregated prefill / decode with the KV page-span
  handoff.
- :mod:`autoscale`: the ``serving.autoscale.*`` signal view computed
  from the observability registry (and a live Router).
- :mod:`controller`: the SLO-driven ``PoolController`` that scales out,
  scales in, shifts fair-queueing weights and sheds tiers.

Quickstart::

    from paddle_tpu_torch.serving import Router

    router = Router([model, model], roles=["prefill", "decode"],
                    device="cuda", max_batch_size=4, page_size=16,
                    max_seq_len=512)
    h = router.submit(prompt, max_new_tokens=64)
    for ev in h.stream(timeout=60):   # tokens as they decode
        print(ev.token)
    router.shutdown()
"""
from .scheduler import (  # noqa: F401
    DEFAULT_TIER, FifoQueue, WeightedFairScheduler, stage_cost,
)
from .streaming import (  # noqa: F401
    ServeRequest, StreamEvent, TokenStream,
)
from ..generation.sampling import SamplingParams  # noqa: F401
from .router import (  # noqa: F401
    Replica, Router, RequestHandle,
)
from .autoscale import (  # noqa: F401
    autoscale_signals, publish_autoscale,
)
from .controller import (  # noqa: F401
    ControllerConfig, PoolController,
)

__all__ = [
    "FifoQueue", "WeightedFairScheduler", "DEFAULT_TIER", "stage_cost",
    "ServeRequest", "StreamEvent", "TokenStream", "SamplingParams",
    "Replica", "Router", "RequestHandle", "autoscale_signals",
    "publish_autoscale", "ControllerConfig", "PoolController",
]
