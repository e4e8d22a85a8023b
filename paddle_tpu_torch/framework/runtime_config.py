"""Serving defaults the continuous-batching predictor reads.

Counterpart of ``paddle_tpu/framework/runtime_config.py`` ``RuntimeConfig``
(serving geometry fields only); the values equal the reference defaults.
"""
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class RuntimeConfig:
    max_batch_size: int = 4
    page_size: int = 16
    num_pages: Optional[int] = None        # None: B * pages_per_seq
    max_seq_len: int = 512
    # admission prompt-length buckets; () = power-of-two auto bucketing
    prompt_buckets: Tuple[int, ...] = ()
