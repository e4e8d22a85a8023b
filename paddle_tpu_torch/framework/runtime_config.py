"""Serving defaults the continuous-batching predictor reads.

Counterpart of ``paddle_tpu/framework/runtime_config.py`` ``RuntimeConfig``
(the serving fields the port runs); the values and the validation equal
the reference's.
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
    prefill_chunk_tokens: int = 0          # 0 = monolithic prefill
    # speculative decoding: max drafted tokens per verify step (the
    # verify span is spec_draft_tokens + 1 wide); 0 = off
    spec_draft_tokens: int = 0
    # prompt-lookup drafting: longest suffix n-gram matched against the
    # request's own prompt + generation history
    spec_ngram_max: int = 3
    # on-device sampling: the decode and verify steps take per-request
    # temperature / top-k / top-p / seed operands; off = greedy only
    sampling_enabled: bool = False

    def __post_init__(self):
        if self.page_size <= 0 or self.max_batch_size <= 0 \
                or self.max_seq_len <= 0:
            raise ValueError("geometry fields must be positive")
        if self.spec_draft_tokens < 0 or self.spec_ngram_max < 1:
            raise ValueError(
                "spec_draft_tokens must be >= 0 and spec_ngram_max "
                f">= 1, got {self.spec_draft_tokens!r}/"
                f"{self.spec_ngram_max!r}")
