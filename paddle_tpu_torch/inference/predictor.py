"""Continuous-batching greedy serving (counterpart of
``paddle_tpu/inference/__init__.py`` ``ContinuousBatchingPredictor``,
limited to the greedy ``generate`` path).

The admission / decode / resolve loop, the prompt bucketing, the prefix
cache with copy-on-write and the stats keys follow the reference, so
both predictors form the same batches and emit the same greedy tokens.
Three device programs carry it, as in the reference:

- ``_raw_prefill``: batched, bucketed, left-padded prefill; the greedy
  token for every position and the K/V scatter into the paged pool;
- ``_raw_suffix_prefill``: a prefix-cache partial hit runs only the
  prompt suffix against the cached pages;
- ``_raw_decode_step``: the paged K/V write, paged attention and argmax
  for every slot.

Decode steps are double-buffered as in the reference: step t+1 is
dispatched (chaining step t's device-resident token) before step t's
token is fetched. On CUDA the fetch is an asynchronous copy into pinned
host memory behind an event, so waiting for step t never waits for the
step already queued behind it.
"""
from __future__ import annotations

import collections
import math
import time
from typing import List

import numpy as np
import torch

from ..framework import resolve_device
from ..framework.runtime_config import RuntimeConfig
from ..generation.kv_cache import (PagedCacheEntry, PagedKVCache,
                                   PagedKVPool, PrefixCache, decode_index)
from ..kernels import NEG_INF


def _pow2_bucket(n):
    """``LLMPredictor._bucket``: the smallest power of two >= max(n, 8)."""
    b = 8
    while b < n:
        b *= 2
    return b


class ContinuousBatchingPredictor:
    """Greedy continuous batching over a paged KV pool: requests join and
    leave the running batch mid-flight; full prefix-cache hits admit with
    no forward pass, partial hits prefill only the suffix.

    ``device`` defaults to CUDA and must be where the model lives;
    ``device="cpu"`` runs the plain PyTorch path.
    """

    def __init__(self, model, max_batch_size=None, page_size=None,
                 num_pages=None, max_seq_len=None, pad_token_id=0,
                 eos_token_id=None, enable_prefix_cache=True,
                 runtime_config=None, device=None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, predictor "
                             f"device is {self.device}")
        model.eval()
        rc = runtime_config if runtime_config is not None \
            else RuntimeConfig()
        if max_batch_size is None:
            max_batch_size = rc.max_batch_size
        if page_size is None:
            page_size = rc.page_size
        if num_pages is None:
            num_pages = rc.num_pages
        if max_seq_len is None:
            max_seq_len = rc.max_seq_len
        self._rc_buckets = tuple(rc.prompt_buckets)
        self.model = model
        cfg = model.config
        self.B = int(max_batch_size)
        self.page = int(page_size)
        self.max_seq_len = int(max_seq_len)
        self.pages_per_seq = math.ceil(max_seq_len / page_size)
        if num_pages is None:
            num_pages = self.B * self.pages_per_seq
        self.capacity = int(num_pages)
        self.pad_token_id = pad_token_id
        self.eos_token_id = eos_token_id
        head_dim = cfg.hidden_size // cfg.num_attention_heads
        self.pool = PagedKVPool(cfg.num_hidden_layers, num_pages + 1,
                                page_size, cfg.num_key_value_heads,
                                head_dim,
                                dtype=next(model.parameters()).dtype,
                                device=self.device)
        # inactive slots point their block table at a trash page: the
        # decode step writes one K/V row for EVERY slot
        self._trash = self.pool.alloc(1)[0]
        self.prefix_cache = PrefixCache(page_size) if enable_prefix_cache \
            else None
        if self.prefix_cache is not None:
            self.pool.reclaimer = self.prefix_cache
        self.stats = {"prefills": 0, "prefill_batches": 0,
                      "decode_steps": 0, "evictions": 0,
                      "max_in_flight": 0, "prefix_hits": 0,
                      "prefix_partial_hits": 0, "prefix_misses": 0,
                      "pages_reused": 0, "hol_skips": 0}
        self.last_status: List[str] = []
        # seconds from the generate() call to each request's first token
        self.last_ttft_s: List[float] = []

    def _bucket_len(self, n):
        """Admission prompt bucket: the smallest tuned-table entry
        covering n, else power-of-two bucketing."""
        for b in self._rc_buckets:
            if b >= n:
                return b
        return _pow2_bucket(n)

    # ------------------------------------------------------ host <-> device
    def _put(self, arr):
        """Host array -> device tensor, snapshotting it: the host mutates
        tables/ctx in place while a dispatched step may still read them.
        On CUDA the copy is asynchronous from pinned memory, so it never
        waits for the steps already queued."""
        t = torch.from_numpy(arr)
        if self.device.type == "cuda":
            # pin_memory() copies, so the snapshot is taken right here
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.clone()

    def _fetch_async(self, *tensors):
        """Start copying small device tensors to the host; returns a
        callable that waits for exactly those copies and gives numpy."""
        if self.device.type != "cuda":
            return lambda: tuple(t.numpy() for t in tensors)
        outs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in tensors]
        for o, t in zip(outs, tensors):
            o.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))

        def wait():
            ev.synchronize()
            return tuple(o.numpy() for o in outs)
        return wait

    # -------------------------------------------------------- device steps
    @torch.no_grad()
    def _raw_prefill(self, ids, pos, lens, page_rows):
        """Batched prefill: ids/pos [N, bucket] (left-padded), lens [N],
        page_rows [N, ceil(bucket/page)]. Runs the forward with the
        causal+padding mask, takes the greedy token at every position and
        scatters every layer's K/V into the pool (rows with lens == 0 are
        dummies whose writes land on the trash page). Returns next
        tokens [N, bucket] int32."""
        n, bucket = ids.shape
        dev = ids.device
        j = torch.arange(bucket, device=dev)
        key_valid = j[None, :] >= (bucket - lens)[:, None]       # [N, S]
        causal = j[None, :] <= j[:, None]                        # [Sq, Sk]
        ok = key_valid[:, None, :] & causal[None, :, :]
        mask = torch.where(ok, 0.0, NEG_INF).to(torch.float32)[:, None]
        logits, caches = self.model(ids, attn_mask=mask, position_ids=pos,
                                    use_cache=True)
        nexts = logits.argmax(dim=-1).to(torch.int32)
        tokpos = j[None, :] - (bucket - lens)[:, None]
        pidx = torch.clamp(tokpos // self.page, 0, page_rows.shape[1] - 1)
        dst_page = torch.where(key_valid, page_rows.gather(1, pidx),
                               self._trash)
        dst_off = torch.where(key_valid, tokpos % self.page, 0)
        for li, (ka, va) in enumerate(caches):
            self.pool.k[li][dst_page, dst_off] = ka
            self.pool.v[li][dst_page, dst_off] = va
        return nexts

    @torch.no_grad()
    def _raw_suffix_prefill(self, ids, pos, m, slen, past_rows, page_rows):
        """Prefix-cache partial hit: forward only the prompt SUFFIX,
        attending to the cached prefix K/V gathered from its pages. ids/
        pos [1, sb] (left-padded suffix), m = cached prefix length, slen
        = suffix length, past_rows [Wp] page ids covering the prefix
        (trash-padded), page_rows [pages_per_seq] the request's table
        row. Returns next tokens [sb] int32."""
        sb = ids.shape[1]
        page = self.page
        dev = ids.device
        past_len = past_rows.shape[0] * page
        j = torch.arange(sb, device=dev)
        key_valid = j >= sb - slen                                # [sb]
        causal = j[None, :] <= j[:, None]
        suf_ok = key_valid[None, :] & causal                      # [q, k]
        past_ok = (torch.arange(past_len, device=dev) < m)[None, :]
        mask = torch.cat(
            [torch.where(past_ok.expand(sb, past_len), 0.0, NEG_INF),
             torch.where(suf_ok, 0.0, NEG_INF)],
            dim=1).to(torch.float32)[None, None]
        pasts = []
        for kp, vp in zip(self.pool.k, self.pool.v):
            hk, hd = kp.shape[2], kp.shape[3]
            pasts.append((kp[past_rows].reshape(1, past_len, hk, hd),
                          vp[past_rows].reshape(1, past_len, hk, hd)))
        logits, caches = self.model(ids, attn_mask=mask, position_ids=pos,
                                    past_key_values=pasts, use_cache=True)
        nexts = logits[0].argmax(dim=-1).to(torch.int32)
        apos = m + (j - (sb - slen))
        pidx = torch.clamp(apos // page, 0, page_rows.shape[0] - 1)
        dst_page = torch.where(key_valid, page_rows[pidx], self._trash)[None]
        dst_off = torch.where(key_valid, apos % page, 0)[None]
        for li, (ck, cv) in enumerate(caches):
            kp, vp = self.pool.k[li], self.pool.v[li]
            kp[dst_page, dst_off] = ck[:, past_len:]
            vp[dst_page, dst_off] = cv[:, past_len:]
        return nexts

    @torch.no_grad()
    def _raw_decode_step(self, tables, ctx, last_tok):
        """One decode step for all slots: paged K/V write + paged
        attention + greedy argmax + eos detection, all on the device.
        Returns (next_token [B] int32, done [B] bool)."""
        # the write position and attended length are the same in every
        # layer: computed once per step, not once per layer
        step = decode_index(tables, ctx, self.page)
        entries = [PagedCacheEntry(k, v, tables, ctx, step)
                   for k, v in zip(self.pool.k, self.pool.v)]
        logits, _ = self.model(last_tok[:, None].long(),
                               position_ids=ctx[:, None].long(),
                               past_key_values=PagedKVCache(entries),
                               use_cache=True)
        nxt = logits[:, -1].argmax(dim=-1).to(torch.int32)
        if self.eos_token_id is not None:
            done = nxt == self.eos_token_id
        else:
            done = torch.zeros(nxt.shape, dtype=torch.bool, device=nxt.device)
        return nxt, done

    # -------------------------------------------------------------- serve
    def generate(self, prompts, max_new_tokens=32, strict=True):
        """Continuous batching over a list of prompts: List[List[int]] ->
        List[List[int]] (new tokens per prompt, eos stripped, in request
        order). ``max_new_tokens`` is one budget for every request or a
        list of per-request budgets (the reference's ``ServeRequest``
        carries one per request the same way).

        A request that can never be served (prompt + max_new_tokens over
        ``max_seq_len``, or more KV pages than the pool holds) raises
        ValueError up front when ``strict``; otherwise its result is []
        and ``last_status[r]`` names the reason
        ('rejected_over_max_seq_len' / 'rejected_over_pool_capacity';
        'ok' for served requests)."""
        if isinstance(max_new_tokens, int):
            max_new = [max_new_tokens] * len(prompts)
        else:
            max_new = [int(m) for m in max_new_tokens]
            if len(max_new) != len(prompts):
                raise ValueError(f"max_new_tokens has {len(max_new)} "
                                 f"entries for {len(prompts)} prompts")
        if strict:
            for r, p in enumerate(prompts):
                uns = self._unservable(p, max_new[r])
                if uns is not None:
                    raise ValueError(
                        f"request {r} can never be served: {uns[1]}. "
                        "Raise max_seq_len/num_pages, shorten the prompt, "
                        "or pass strict=False to reject it and serve the "
                        "rest.")
        return self._serve([list(p) for p in prompts], max_new)

    def _unservable(self, prompt, max_new):
        """(kind, detail) when the request can never be served on this
        predictor's geometry, else None."""
        L = len(prompt)
        need = -(-(L + max_new) // self.page)
        if L + max_new > self.max_seq_len:
            return ("over_max_seq_len",
                    f"prompt len {L} + max_new_tokens {max_new} "
                    f"exceeds max_seq_len {self.max_seq_len}")
        if need > self.capacity:
            return ("over_pool_capacity",
                    f"needs {need} KV pages but the pool holds "
                    f"{self.capacity}")
        return None

    def _serve(self, prompts, max_new):
        n = len(prompts)
        t_start = time.perf_counter()
        results = [None] * n
        status = ["queued"] * n
        ttft = [None] * n
        self.last_status = status
        self.last_ttft_s = ttft
        queue = collections.deque()
        for r, p in enumerate(prompts):
            uns = self._unservable(p, max_new[r])
            if uns is not None:
                results[r] = []
                status[r] = "rejected_" + uns[0]
            else:
                queue.append(r)

        slot_req = [-1] * self.B                  # -1 = free
        slot_pages = [[] for _ in range(self.B)]
        slot_new = [[] for _ in range(self.B)]
        tables = np.full((self.B, self.pages_per_seq), self._trash, np.int32)
        ctx = np.ones((self.B,), np.int32)        # inactive: 1 dummy token
        last_tok_host = np.zeros((self.B,), np.int32)
        override = np.zeros((self.B,), bool)      # host token beats device

        def evict(b, status_val="ok"):
            r = slot_req[b]
            results[r] = slot_new[b]
            status[r] = status_val
            self.pool.release(slot_pages[b])
            slot_req[b], slot_pages[b], slot_new[b] = -1, [], []
            tables[b, :] = self._trash
            ctx[b] = 1
            self.stats["evictions"] += 1

        def reserve(r):
            """Reserve pages for request r (prefix-cache lookup, retain,
            alloc, copy-on-write): the admission plan, or None when the
            pool cannot satisfy it right now."""
            prompt = prompts[r]
            L = len(prompt)
            need = -(-(L + max_new[r]) // self.page)
            full_pages, covered, partial, cached_next = [], 0, None, None
            if self.prefix_cache is not None:
                full_pages, covered, partial, cached_next = \
                    self.prefix_cache.lookup(prompt)
                if covered + (partial[1] if partial else 0) == L \
                        and cached_next is None:
                    # the whole prompt is cached but its continuation was
                    # never recorded: back off so a real suffix runs
                    if partial is not None:
                        partial = None
                    elif full_pages:
                        covered -= self.page
                        full_pages = full_pages[:-1]
            shared = full_pages + ([partial[0]] if partial else [])
            self.pool.retain(shared)      # pin before alloc may reclaim
            fresh = self.pool.alloc(need - len(full_pages))
            if fresh is None:
                self.pool.release(shared)
                if not shared:
                    return None
                # sharing pins cached pages the request would otherwise
                # reclaim: on a tight pool fall back to a full prefill
                fresh = self.pool.alloc(need)
                if fresh is None:
                    return None
                return {"r": r, "prompt": prompt, "covered": 0,
                        "pages": fresh, "reused": 0, "next": None}
            if partial is not None:
                # copy-on-write at the divergence page
                self.pool.copy_into(partial[0], fresh[0])
                self.pool.release([partial[0]])
                covered += partial[1]
            return {"r": r, "prompt": prompt, "covered": covered,
                    "pages": full_pages + fresh,
                    "reused": len(full_pages) + (1 if partial else 0),
                    "next": cached_next if covered == L else None}

        def place(b, plan, first):
            r = plan["r"]
            L = len(plan["prompt"])
            pages = plan["pages"]
            slot_req[b], slot_pages[b] = r, pages
            tables[b, :] = self._trash
            tables[b, :len(pages)] = pages
            slot_new[b] = [first]
            ctx[b] = L
            last_tok_host[b] = first
            override[b] = True
            status[r] = "running"
            ttft[r] = time.perf_counter() - t_start
            if self.eos_token_id is not None and first == self.eos_token_id:
                slot_new[b] = []          # eos is stripped
                evict(b)
            elif max_new[r] <= 1:
                evict(b)                  # budget met at admission

        def admission_round():
            """Fill every free slot with the first admissible queued
            requests (a request waiting for pages does not block later
            ones), then run the round's prefills: full hits need none,
            partial hits a suffix prefill, misses batch per bucket."""
            free = [b for b in range(self.B) if slot_req[b] < 0]
            if not free or not queue:
                return False
            plans, skipped, seq = [], [], []
            budget = len(queue)
            while len(plans) < len(free) and budget > 0 and queue:
                r = queue.popleft()
                budget -= 1
                plan = reserve(r)
                if plan is None:
                    skipped.append(r)
                    seq.append(False)
                else:
                    plans.append(plan)
                    seq.append(True)
            for r in reversed(skipped):
                queue.appendleft(r)
            if plans and skipped:
                last_pick = max(i for i, s in enumerate(seq) if s)
                self.stats["hol_skips"] += sum(
                    1 for i, s in enumerate(seq) if not s and i < last_pick)
            if not plans:
                return False
            hits = [p for p in plans if p["next"] is not None]
            partials = [p for p in plans
                        if p["next"] is None and p["covered"] > 0]
            misses = [p for p in plans
                      if p["next"] is None and p["covered"] == 0]
            firsts = {}
            for plan in hits:
                firsts[plan["r"]] = int(plan["next"])
                self.stats["prefix_hits"] += 1
                self.stats["pages_reused"] += plan["reused"]
            for plan in partials:
                firsts[plan["r"]] = self._suffix_prefill(plan)
                self.stats["prefix_partial_hits"] += 1
                self.stats["pages_reused"] += plan["reused"]
            by_bucket = {}
            for plan in misses:
                by_bucket.setdefault(self._bucket_len(len(plan["prompt"])),
                                     []).append(plan)
                self.stats["prefix_misses"] += 1
            for bucket, group in sorted(by_bucket.items()):
                firsts.update(self._batch_prefill(bucket, group))
            for b, plan in zip(free, plans):
                place(b, plan, firsts[plan["r"]])
            return True

        inflight = None
        while True:
            while admission_round():
                pass
            active = [b for b in range(self.B) if slot_req[b] >= 0]
            cur = None
            if active:
                self.stats["max_in_flight"] = max(
                    self.stats["max_in_flight"], len(active))
                # a dispatch is useless when every active slot's budget
                # is met once the in-flight step resolves
                pend = {b for b, r in inflight["snap"]
                        if slot_req[b] == r} if inflight else set()
                if any(len(slot_new[b]) + (1 if b in pend else 0)
                       < max_new[slot_req[b]] for b in active):
                    cur = self._dispatch_step(active, slot_req, tables, ctx,
                                              last_tok_host, override,
                                              inflight)
            prev, inflight = inflight, cur
            if prev is not None:
                self._resolve_step(prev, slot_req, slot_new, last_tok_host,
                                   max_new, evict)
            elif cur is None:
                break
        for r, res in enumerate(results):
            if res is None:               # never placed (defensive)
                results[r] = []
                status[r] = "incomplete"
        return results

    # ------------------------------------------------------ admission ops
    def _batch_prefill(self, bucket, group):
        """Batched same-bucket prefill for a round's cache misses; returns
        {request: first token} and records the prompts in the prefix
        cache."""
        n = len(group)
        nb = 1
        while nb < n:
            nb *= 2
        W = -(-bucket // self.page)
        ids = np.full((nb, bucket), self.pad_token_id, np.int64)
        pos = np.zeros((nb, bucket), np.int64)
        lens = np.zeros((nb,), np.int64)
        rows = np.full((nb, W), self._trash, np.int64)
        for i, plan in enumerate(group):
            prompt = plan["prompt"]
            L = len(prompt)
            ids[i, bucket - L:] = prompt
            pos[i, bucket - L:] = np.arange(L)
            lens[i] = L
            rows[i, :min(W, len(plan["pages"]))] = plan["pages"][:W]
        nexts = self._raw_prefill(self._put(ids), self._put(pos),
                                  self._put(lens), self._put(rows))
        # the admission download: every position's greedy token (the
        # prefix cache stores them as cached continuations)
        nexts = nexts.cpu().numpy()
        firsts = {}
        for i, plan in enumerate(group):
            prompt = plan["prompt"]
            L = len(prompt)
            firsts[plan["r"]] = int(nexts[i, -1])
            if self.prefix_cache is not None:
                toks = [int(t) for t in nexts[i, bucket - L:]]
                npages = -(-L // self.page)
                self.prefix_cache.insert(prompt, plan["pages"][:npages],
                                         toks, self.pool)
        self.stats["prefills"] += n
        self.stats["prefill_batches"] += 1
        return firsts

    def _suffix_prefill(self, plan):
        """Partial prefix hit: forward only prompt[covered:] against the
        cached pages; returns the first generated token."""
        prompt, covered = plan["prompt"], plan["covered"]
        L = len(prompt)
        suffix = prompt[covered:]
        sl = len(suffix)
        sb = self._bucket_len(sl)
        wp = -(-covered // self.page)
        wpb = 1
        while wpb < wp:
            wpb *= 2
        ids = np.full((1, sb), self.pad_token_id, np.int64)
        pos = np.zeros((1, sb), np.int64)
        ids[0, sb - sl:] = suffix
        pos[0, sb - sl:] = covered + np.arange(sl)
        past_rows = np.full((wpb,), self._trash, np.int64)
        past_rows[:wp] = plan["pages"][:wp]
        row = np.full((self.pages_per_seq,), self._trash, np.int64)
        row[:len(plan["pages"])] = plan["pages"]
        nexts = self._raw_suffix_prefill(
            self._put(ids), self._put(pos), covered, sl,
            self._put(past_rows), self._put(row))
        nexts = nexts.cpu().numpy()
        first = int(nexts[-1])
        if self.prefix_cache is not None:
            toks = [None] * covered + [int(t) for t in nexts[sb - sl:]]
            npages = -(-L // self.page)
            self.prefix_cache.insert(prompt, plan["pages"][:npages], toks,
                                     self.pool)
        self.stats["prefills"] += 1
        return first

    # --------------------------------------------------------- decode ops
    def _dispatch_step(self, active, slot_req, tables, ctx, last_tok_host,
                       override, inflight):
        """Dispatch one decode step WITHOUT waiting for the previous one:
        continuing slots chain the device-resident token straight back
        in; newly admitted slots inject their host-known first token."""
        t0 = time.perf_counter()
        host_tok = self._put(last_tok_host)
        if inflight is None:
            tok_in = host_tok
        else:
            tok_in = torch.where(self._put(override), host_tok,
                                 inflight["tok"])
        override[:] = False
        nxt, done = self._raw_decode_step(self._put(tables), self._put(ctx),
                                          tok_in)
        fetch = self._fetch_async(nxt, done)
        snap = [(b, slot_req[b]) for b in active]
        ctx[active] += 1
        self.stats["decode_steps"] += 1
        return {"tok": nxt, "fetch": fetch, "snap": snap, "t": t0}

    def _resolve_step(self, step, slot_req, slot_new, last_tok_host, max_new,
                      evict):
        """Sync a previously dispatched step (its successor is already in
        flight) and apply its tokens: append, detect eos / budget, evict.
        Slots recycled since the dispatch are skipped."""
        nxt, done = step["fetch"]()
        for b, r in step["snap"]:
            if slot_req[b] != r:
                continue                  # evicted (and maybe re-admitted)
            if len(slot_new[b]) >= max_new[r]:
                continue                  # token of a post-budget step
            t = int(nxt[b])
            slot_new[b].append(t)
            last_tok_host[b] = t
            if bool(done[b]):             # eos computed on the device
                slot_new[b].pop()         # eos is stripped
                evict(b)
            elif len(slot_new[b]) >= max_new[r]:
                evict(b)
