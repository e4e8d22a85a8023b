"""Counterpart of ``paddle_tpu/generation`` (the paged KV cache of serving
and the greedy speculative-decoding helpers)."""
from .kv_cache import (PagedCacheEntry, PagedKVCache, PagedKVPool,
                       PrefixCache, paged_cache_mixed_update_attend,
                       paged_cache_update_attend, prefix_page_keys,
                       span_index)
from .sampling import propose_ngram_drafts, verify_spans_greedy

__all__ = ["PagedCacheEntry", "PagedKVCache", "PagedKVPool", "PrefixCache",
           "paged_cache_mixed_update_attend", "paged_cache_update_attend",
           "prefix_page_keys", "propose_ngram_drafts", "span_index",
           "verify_spans_greedy"]
