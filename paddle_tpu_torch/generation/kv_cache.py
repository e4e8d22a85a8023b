"""KV caches (counterpart of ``paddle_tpu/generation/kv_cache.py``): the
static cache of ``generate()`` (``StaticCacheEntry``, ``StaticKVCache``,
``static_cache_update``: one preallocated [B, max_len, n_kv_heads,
head_dim] buffer per layer, written in place at a position), and for
serving the refcounted page pool, the prefix cache over page-aligned
prompt prefixes, and the step contracts ``paged_cache_update_attend``
(one decode token per slot) and ``paged_cache_mixed_update_attend`` (a
span of tokens per slot).

Unlike the functional JAX version, the pool's page tensors are updated
IN PLACE on the device: the decode step's K/V write, the prefill
scatters, the mixed step's span writes and copy-on-write all mutate
``PagedKVPool.k[i]`` / ``PagedKVPool.v[i]``. Every write and every read of a page runs on the
device's current stream, so a write is always ordered before the
attention that reads it.
"""
from __future__ import annotations

from typing import List, NamedTuple

import torch

from ..observability import metrics as _obsm
from ..kernels.paged_attention import (paged_attention,
                                       paged_attention_ragged,
                                       paged_attention_ragged_varq,
                                       paged_attention_varq)


class StaticCacheEntry(NamedTuple):
    """One layer's static cache: ``k`` and ``v`` [batch, max_len,
    n_kv_heads, head_dim] and ``pos`` (an int), the slot where this
    step's keys and values are written."""
    k: torch.Tensor
    v: torch.Tensor
    pos: int


class StaticKVCache:
    """A list of per-layer ``StaticCacheEntry``, passed as
    ``past_key_values``."""

    def __init__(self, entries: List[StaticCacheEntry]):
        self.entries = entries

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __iter__(self):
        return iter(self.entries)


def static_cache_update(entry: StaticCacheEntry, k, v):
    """Write K/V [B, s, H, D] into the cache at ``entry.pos`` IN PLACE
    (the reference's ``lax.dynamic_update_slice`` returns a new buffer;
    here the preallocated one is overwritten, on the current stream
    before any read of it). Returns (k cache, v cache, entry)."""
    s = k.shape[1]
    pos = int(entry.pos)
    entry.k[:, pos:pos + s].copy_(k)
    entry.v[:, pos:pos + s].copy_(v)
    return entry.k, entry.v, entry


_KV_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "float16": torch.float16}


def kv_dtype_name(dtype) -> str:
    """The pool dtype's name ("float32", "bfloat16" or "float16") from
    a name or a torch dtype; raises on another."""
    name = str(dtype).rsplit(".", 1)[-1]
    if name not in _KV_DTYPES:
        raise ValueError(f"KV pages take one of {sorted(_KV_DTYPES)}, got "
                         f"{dtype!r}")
    return name


class PagedKVPool:
    """Host-side page allocator over device-resident paged K/V tensors
    (one [num_pages, page_size, n_kv_heads, head_dim] tensor per layer
    for K and for V). The free list and reference counts live on the
    host, the page contents on the device.

    ``alloc`` hands out pages at refcount 1, ``retain``/``release``
    adjust the count, and a page returns to the free list only at zero.
    ``copy_into`` is the write half of copy-on-write. An optional
    ``reclaimer`` (the PrefixCache) drops cached-but-unused pages when
    ``alloc`` runs short; ``free_count`` counts them as available.

    ``dtype`` is the pages' dtype, a name as the reference takes it
    ("float32", "bfloat16", "float16") or a torch dtype; ``.dtype`` keeps
    the name. Every write into the pages casts to it.
    """

    def __init__(self, n_layers, num_pages, page_size, n_kv_heads,
                 head_dim, dtype="float32", device="cpu"):
        self.page_size = int(page_size)
        self.num_pages = int(num_pages)
        self.n_kv_heads = int(n_kv_heads)
        self.head_dim = int(head_dim)
        self.dtype = kv_dtype_name(dtype)
        shape = (self.num_pages, self.page_size, self.n_kv_heads,
                 self.head_dim)
        tdt = _KV_DTYPES[self.dtype]
        self.k = [torch.zeros(shape, dtype=tdt, device=device)
                  for _ in range(n_layers)]
        self.v = [torch.zeros(shape, dtype=tdt, device=device)
                  for _ in range(n_layers)]
        self._free = list(range(self.num_pages))
        self._refs = {}
        self.reclaimer = None

    @property
    def free_count(self):
        extra = (self.reclaimer.reclaimable_count(self)
                 if self.reclaimer is not None else 0)
        return len(self._free) + extra

    def alloc(self, n):
        """n page ids (each at refcount 1), or None when the pool cannot
        satisfy the request even after reclaiming cached pages."""
        if n > len(self._free) and self.reclaimer is not None:
            self.reclaimer.reclaim(self, n - len(self._free))
        if n > len(self._free):
            return None
        got, self._free = self._free[:n], self._free[n:]
        for p in got:
            self._refs[p] = 1
        return got

    def retain(self, ids):
        for p in ids:
            self._refs[p] = self._refs.get(p, 0) + 1

    def release(self, ids):
        for p in ids:
            c = self._refs.get(p, 1) - 1
            if c <= 0:
                self._refs.pop(p, None)
                self._free.append(p)
            else:
                self._refs[p] = c

    def ref_count(self, pid):
        return self._refs.get(pid, 0)

    def copy_into(self, src, dst):
        """Device-side page copy across all layers (no host round-trip):
        one page of traffic per layer."""
        for k in self.k:
            k[dst].copy_(k[src])
        for v in self.v:
            v[dst].copy_(v[src])

    def write(self, layer, page, off, k, v):
        """Write K/V rows into layer ``layer``'s pages at (``page``,
        ``off``), cast to the pool's dtype (indexed assignment refuses a
        source of another dtype)."""
        kp, vp = self.k[layer], self.v[layer]
        kp[page, off] = k.to(kp.dtype)
        vp[page, off] = v.to(vp.dtype)


def prefix_page_keys(prompt, page_size):
    """One hashable key per FULL page of ``prompt`` (a trailing sub-page
    chunk is a partial, not a key). The PrefixCache trie edges are
    exactly these keys."""
    page = int(page_size)
    return tuple(tuple(prompt[m:m + page])
                 for m in range(0, len(prompt) - page + 1, page))


class _PrefixNode:
    __slots__ = ("page", "next_token", "last_use", "children", "partials")

    def __init__(self, page=None, next_token=None, last_use=0):
        self.page = page
        self.next_token = next_token
        self.last_use = last_use
        self.children = {}   # full page-size token tuple -> _PrefixNode
        self.partials = {}   # sub-page token tuple -> [page, next_token, use]


class PrefixCache:
    """Hash-trie over page-aligned prompt prefixes: each edge is one KV
    page worth of token ids, each node holds the page caching that
    prefix's K/V and the greedy token after it. Nodes also keep
    *partial* trailing chunks (< page_size tokens); a request extending
    one copies the page first (copy-on-write at the divergence page).

    The trie holds one pool reference per cached page; pages whose only
    reference is the trie are reclaimed LRU leaf-first under allocation
    pressure and count as free in the pool.
    """

    def __init__(self, page_size):
        self.page = int(page_size)
        self._root = _PrefixNode()
        self._clock = 0

    def _bump(self):
        self._clock += 1
        return self._clock

    def lookup(self, prompt):
        """Longest cached page-aligned prefix of ``prompt``: (pages,
        covered, partial, next_token). ``pages`` cover the first
        ``covered`` tokens; ``partial`` is (page_id, n_tokens) for a
        shared sub-page chunk extending them (copy it before appending);
        ``next_token`` is the cached greedy continuation when the whole
        prompt is covered, else None."""
        node = self._root
        pages = []
        m = 0
        n = len(prompt)
        for key in prefix_page_keys(prompt, self.page):
            child = node.children.get(key)
            if child is None:
                break
            child.last_use = self._bump()
            pages.append(child.page)
            m += self.page
            node = child
        next_token = node.next_token if (m == n and m > 0) else None
        partial = None
        if m < n:
            rem = tuple(prompt[m:])
            best = None
            for toks, rec in node.partials.items():
                if (len(toks) <= len(rem) and rem[:len(toks)] == toks
                        and (best is None or len(toks) > len(best[0]))):
                    best = (toks, rec)
            if best is not None:
                toks, rec = best
                rec[2] = self._bump()
                partial = (rec[0], len(toks))
                if m + len(toks) == n and rec[1] is not None:
                    next_token = rec[1]
        return pages, m, partial, next_token

    def insert(self, prompt, page_ids, next_tokens, pool):
        """Record a freshly prefilled prompt: ``page_ids`` hold its K/V in
        order, ``next_tokens[i]`` is the greedy token after position i
        (None where unknown). Existing nodes are left untouched; new
        nodes retain their page in the pool."""
        node = self._root
        m, i, n = 0, 0, len(prompt)
        for chunk in prefix_page_keys(prompt, self.page):
            child = node.children.get(chunk)
            if child is None:
                nt = next_tokens[m + self.page - 1] if next_tokens else None
                child = _PrefixNode(page_ids[i], nt, self._bump())
                pool.retain([page_ids[i]])
                node.children[chunk] = child
            m += self.page
            i += 1
            node = child
        if m < n:
            rem = tuple(prompt[m:])
            if rem not in node.partials:
                nt = next_tokens[n - 1] if next_tokens else None
                node.partials[rem] = [page_ids[i], nt, self._bump()]
                pool.retain([page_ids[i]])

    def _droppable(self, pool):
        """(last_use, kind, parent, key) for every entry whose page the
        pool would actually free (the trie holds the only reference)."""
        out = []

        def walk(node):
            for toks, rec in node.partials.items():
                if pool.ref_count(rec[0]) == 1:
                    out.append((rec[2], "partial", node, toks))
            for chunk, child in node.children.items():
                if (not child.children and not child.partials
                        and pool.ref_count(child.page) == 1):
                    out.append((child.last_use, "leaf", node, chunk))
                else:
                    walk(child)

        walk(self._root)
        return out

    def reclaimable_count(self, pool):
        """Pages the trie holds that no request uses (slightly optimistic
        for a ref-1 interior node above a pinned descendant; exact once
        the pool is idle)."""
        count = 0

        def walk(node):
            nonlocal count
            for rec in node.partials.values():
                if pool.ref_count(rec[0]) == 1:
                    count += 1
            for child in node.children.values():
                if pool.ref_count(child.page) == 1:
                    count += 1
                walk(child)

        walk(self._root)
        return count

    def reclaim(self, pool, need):
        """Drop least-recently-used unpinned leaves until ``need`` pages
        were freed or nothing droppable remains. Returns pages freed
        (counted in ``serving.page_evictions``: cached-but-idle pages
        dropped under allocation pressure)."""
        freed = 0
        while freed < need:
            cands = self._droppable(pool)
            if not cands:
                break
            cands.sort(key=lambda c: c[0])
            for _, kind, parent, key in cands[:max(need - freed, 1)]:
                if kind == "partial":
                    rec = parent.partials.pop(key)
                    pool.release([rec[0]])
                else:
                    child = parent.children.pop(key)
                    pool.release([child.page])
                freed += 1
                if freed >= need:
                    break
        if freed:
            _obsm.counter("serving.page_evictions").inc(freed)
        return freed

    def clear(self, pool):
        """Release every cached page."""

        def walk(node):
            for rec in node.partials.values():
                pool.release([rec[0]])
            for child in node.children.values():
                walk(child)
                pool.release([child.page])

        walk(self._root)
        self._root = _PrefixNode()


class DecodeIndex(NamedTuple):
    """Where one decode step writes and how far it attends, per slot: the
    same in every layer, so ``decode_index`` computes it once per step.
    ``write_page`` [B] int64 is ``block_table[b, cl // page]``,
    ``write_off`` [B] int64 is ``cl % page`` and ``attend_lens`` [B]
    int32 is ``cl + 1``."""
    write_page: torch.Tensor
    write_off: torch.Tensor
    attend_lens: torch.Tensor


def decode_index(block_table, context_lens, page_size) -> DecodeIndex:
    cl = context_lens.long()
    rows = torch.arange(cl.shape[0], device=cl.device)
    return DecodeIndex(block_table[rows, cl // page_size].long(),
                       cl % page_size, (cl + 1).to(torch.int32))


class SpanIndex(NamedTuple):
    """Where one mixed (span) step writes and how far it attends: the
    same in every layer, so ``span_index`` computes it once per step.
    ``rows`` int64 [4, N] holds, per entry, its slot b, its span index i,
    and its destination page ``block_table[b, (cl + i) // page]`` and row
    ``(cl + i) % page``. Unpadded, N = sum(q_lens) and only the REAL span
    positions (i < q_lens[b]) are listed. Padded to a static N = B * Qb
    (what a captured program needs), every (b, i) is listed in row-major
    order; a padding position carries the flag i = -1 and the trash page,
    row 0, as destination: its write lands on the trash page, and the
    verify rollback, which restores positions with i > accepted[b],
    never restores it. ``kv_lens`` [B] int32 is ``cl + q_lens``."""
    rows: torch.Tensor
    kv_lens: torch.Tensor


def span_index(block_table, context_lens, q_lens, page_size, qb=None,
               trash_page=0) -> SpanIndex:
    """The SpanIndex of a step whose slot b writes q_lens[b] positions
    from context_lens[b] on; with ``qb`` (the span width) padded to
    B * qb entries over ``trash_page``. A padding position never names a
    real page: torch has no "drop" mode, and one past a full table would
    otherwise clamp into the slot's last real page and race this step's
    real K/V there. (Unpadded, selecting the real positions needs the
    lengths on the host: the predictor builds both forms from its host
    arrays.)"""
    cl = context_lens.long()
    ql = q_lens.long()
    n = cl.shape[0]
    dev = cl.device
    if qb is None:
        b = torch.repeat_interleave(torch.arange(n, device=dev), ql)
        start = torch.cumsum(ql, 0) - ql
        i = torch.arange(b.shape[0], device=dev) - start[b]
    else:
        b = torch.arange(n, device=dev).repeat_interleave(int(qb))
        i = torch.arange(int(qb), device=dev).repeat(n)
    pos = cl[b] + i
    pslot = (pos // page_size).clamp(max=block_table.shape[1] - 1)
    page = block_table.long()[b, pslot]
    off = pos % page_size
    if qb is not None:
        real = i < ql[b]
        page = torch.where(real, page, int(trash_page))
        off = torch.where(real, off, 0)
        i = torch.where(real, i, -1)
    return SpanIndex(torch.stack([b, i, page, off]),
                     (cl + ql).to(torch.int32))


class PagedCacheEntry(NamedTuple):
    """Per-layer paged KV cache: ``k_pages``/``v_pages`` [num_pages,
    page_size, n_kv_heads, head_dim]; ``block_table`` [B, pages_per_seq]
    int32 page ids per slot; ``context_lens`` [B] int32 tokens already
    cached per slot (before the token or span being run); ``step`` their
    ``decode_index`` (or, for a span step, ``span_index``), shared by all
    layers.

    ``ragged_meta`` (optional, int32 [6, G]): ragged metadata for the
    POST-write lengths; when present, attention runs the ragged kernels.
    ``q_lens`` (optional, [B] int32): per-slot query SPAN lengths of the
    MIXED prefill+decode step (a prefill chunk, drafted tokens, or 1 for
    a decode token) starting at context_lens[b]; when present, attention
    goes through ``paged_cache_mixed_update_attend``."""
    k_pages: torch.Tensor
    v_pages: torch.Tensor
    block_table: torch.Tensor
    context_lens: torch.Tensor
    step: object
    ragged_meta: torch.Tensor = None
    q_lens: torch.Tensor = None


class PagedKVCache:
    """A list of per-layer PagedCacheEntry, passed as ``past_key_values``."""

    def __init__(self, entries: List[PagedCacheEntry]):
        self.entries = entries

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __iter__(self):
        return iter(self.entries)


def paged_cache_update_attend(entry: PagedCacheEntry, q, k, v, scale=None):
    """Decode-step contract: write this step's K/V (one token per slot)
    into page ``block_table[b, cl // page]`` at row ``cl % page``, then
    attend the query token over ``cl + 1`` cached tokens with the
    paged-decode kernel, or with the ragged kernel when the entry has
    ``ragged_meta``. An entry with ``q_lens`` runs the mixed step
    (``paged_cache_mixed_update_attend``) instead. q [B, 1, H, D]; k/v
    [B, 1, Hkv, D] -> (out [B, 1, H, D], entry). The write is in place;
    inactive slots point at the predictor's trash page."""
    if entry.q_lens is not None:
        return paged_cache_mixed_update_attend(entry, q, k, v, scale)
    kp, vp, bt, _, step, meta, _ = entry
    kp[step.write_page, step.write_off] = k[:, 0].to(kp.dtype)
    vp[step.write_page, step.write_off] = v[:, 0].to(vp.dtype)
    if meta is not None:
        out = paged_attention_ragged(q[:, 0], kp, vp, step.attend_lens,
                                     meta, scale)
    else:
        out = paged_attention(q[:, 0], kp, vp, bt, step.attend_lens, scale)
    return out[:, None], entry


def paged_cache_mixed_update_attend(entry: PagedCacheEntry, q, k, v,
                                    scale=None):
    """Mixed-step contract: slot b carries a span of ``q_lens[b]``
    queries starting at absolute position ``context_lens[b]``. The
    span's K/V is written into the slot's pages (real positions only,
    from ``entry.step``, a ``span_index``), then the span attends
    causally over the pages with the variable-query kernel, through the
    ragged meta when the entry has one, else through the block table.
    q [B, Qb, H, D]; k/v [B, Qb, Hkv, D] -> (out [B, Qb, H, D], entry).
    Padding positions (i >= q_lens[b]) write nothing, or only the trash
    page when the index is padded, and read back zeros."""
    kp, vp, bt, _, step, meta, ql = entry
    src_b, src_i, page, off = step.rows
    kp[page, off] = k[src_b, src_i].to(kp.dtype)
    vp[page, off] = v[src_b, src_i].to(vp.dtype)
    if meta is not None:
        out = paged_attention_ragged_varq(q, kp, vp, step.kv_lens, ql, meta,
                                          scale)
    else:
        out = paged_attention_varq(q, kp, vp, bt, step.kv_lens, ql, scale)
    return out, entry
