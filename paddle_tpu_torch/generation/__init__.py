"""Counterpart of ``paddle_tpu/generation`` (the paged KV cache of serving)."""
from .kv_cache import (PagedCacheEntry, PagedKVCache, PagedKVPool,
                       PrefixCache, paged_cache_update_attend,
                       prefix_page_keys)

__all__ = ["PagedCacheEntry", "PagedKVCache", "PagedKVPool", "PrefixCache",
           "paged_cache_update_attend", "prefix_page_keys"]
