"""Continuous-batching serving (counterpart of
``paddle_tpu/inference/__init__.py`` ``ContinuousBatchingPredictor``).

The admission / decode / resolve loop, the prompt bucketing, the prefix
cache with copy-on-write, chunked prefill, prompt-lookup speculative
decoding, on-device sampling and the stats keys follow the reference, so
both predictors form the same batches and emit the same tokens, greedy
and sampled. Six device programs carry it, as in the reference:

- ``_raw_prefill``: batched, bucketed, left-padded prefill; the greedy
  token for every position and the K/V scatter into the paged pool;
- ``_raw_suffix_prefill``: a prefix-cache partial hit runs only the
  prompt suffix against the cached pages;
- ``_raw_decode_step``: the paged K/V write, paged attention and argmax
  for every slot;
- ``_raw_decode_sample_step`` (``sampling_enabled``): the same step with
  each slot's token drawn on the device from its own temperature,
  top-k, top-p and seed (``generation.sampling.sample_tokens``); greedy
  slots take the argmax, bitwise the greedy step's token;
- ``_raw_mixed_step``: every slot carries a span (a page-aligned chunk
  of a long prompt, or one decode token) through the variable-query
  kernel, so a long prompt ingests while the other slots decode;
- ``_raw_spec_step``: every slot's committed token plus its drafted
  tokens verify in one span; the accepted prefix is found on the device
  (by rejection sampling for sampled slots) and the rejected positions'
  K/V is restored there.

A sampled request's first token is drawn, not taken from the admission
argmax: the slot backs up one position and replays its last prompt
token through the sampling step (first-token replay). Sampled requests
bypass the prefix cache, and sampled decode slots pause while a mixed
step ingests a chunk (the mixed step takes no sampling operands).

With ``use_ragged`` the decode attention runs over the ragged (slot,
page) work list (``RaggedMetaBuilder``) and the span attention takes its
pages from the same list; without it both read the block table.

Every step goes through ``_jit_call(sig, fn, *args)`` under the
reference's program signatures. Without an engine that is the eager
call. With an AOT engine (``inference.aot``) attached, a signature the
engine holds replays its captured CUDA graph (on a CPU predictor, a
program is the eager function), and a signature it does not hold runs
eagerly once, is captured and is written back into the engine's bundle.
Operands keep static shapes for that: the span index is padded to
B * Qb entries and suffix prefill's prefix and suffix lengths are 0-d
device tensors.

The front end is the reference's: ``generate`` drains
``generate_stream``, whose serve loop is a generator of
``serving.StreamEvent``s; ``serve_stream`` polls an intake for new
requests. Requests queue FIFO or, with tiers, under weighted deficit
round robin (``serving.scheduler``); a bounded queue sheds, deadlines
evict, consumers cancel, and an armed decode watchdog fails the pending
requests with ``DecodeWedgedError`` inside instead of hanging. A weight
change between two serve calls flushes the prefix cache.

Telemetry is the reference's (``observability``): the constructor
registers its ``serving.*`` / ``robustness.*`` series (labelled
``replica=<name>`` when named, and by tier), the serve loop records them
beside ``stats`` at the same events, and every serve call opens a
``serve.generate`` span with one ``serve.request`` span per request
(parented on ``ServeRequest.trace`` when given) and a ``serve.prefill``
span per admission round. A stream event's ``ts`` is its request span's
last event's. A decode-watchdog trip dumps the flight recorder. Every
record is host code around a device step, on values the host already
holds: none sits inside a captured program and none reads the device.

Decode and mixed steps are double-buffered as in the reference: step
t+1 is dispatched (chaining step t's device-resident token) before step
t's token is fetched. On CUDA the fetch is an asynchronous copy into
pinned host memory behind an event, so waiting for step t never waits
for the step already queued behind it. Speculative mode resolves each
step before dispatching the next: the drafter needs the committed
tokens. So does a mixed step on a sampling-enabled predictor: its
resolve moves sampled slots into first-token replay.
"""
from __future__ import annotations

import collections
import math
import sys
import time
from typing import List

import numpy as np
import torch

from ..framework import faults as _faults
from ..framework import graphs as _graphs
from ..framework import resolve_device
from ..framework.runtime_config import RuntimeConfig, check_servable
from ..generation import sampling
from ..generation.sampling import SamplingParams
from ..generation.kv_cache import (PagedCacheEntry, PagedKVCache,
                                   PagedKVPool, PrefixCache, SpanIndex,
                                   decode_index, kv_dtype_name, span_index)
from ..kernels import NEG_INF
from ..kernels.paged_attention import RaggedMetaBuilder
from ..observability import metrics as _obsm
from ..observability import tracing as _obstr
from ..serving.scheduler import (FifoQueue, WeightedFairScheduler,
                                 stage_cost)
from ..serving.streaming import ServeRequest, StreamEvent, TokenStream

# the armed watchdog's wait on a dispatched step: poll the step's event
# back to back for _SPIN_S, then between sleeps of _POLL_S (a graph
# replayed decode tick takes ~10 ms, so a 2 ms sleep would cost up to a
# fifth of the rate)
_SPIN_S = 200e-6
_POLL_S = 20e-6


class DecodeWedgedError(RuntimeError):
    """The decode watchdog tripped: a dispatched step's result did not
    resolve within the deadline. ContinuousBatchingPredictor fails the
    pending requests (last_status 'watchdog') instead of hanging."""


def _pow2_bucket(n):
    """``LLMPredictor._bucket``: the smallest power of two >= max(n, 8)."""
    b = 8
    while b < n:
        b *= 2
    return b


class ContinuousBatchingPredictor:
    """Continuous batching over a paged KV pool: requests join and leave
    the running batch mid-flight; full prefix-cache hits admit with no
    forward pass, partial hits prefill only the suffix.

    ``device`` defaults to CUDA and must be where the model lives;
    ``device="cpu"`` runs the plain PyTorch path.

    ``kv_dtype``: the KV pages' dtype ("float32", "bfloat16", "float16"
    or a torch dtype), by default the weights' dtype. Pages of another
    dtype than the model's are written cast to it and read by the kernels
    as they are (queries in the model's dtype); a prefix-cache suffix
    prefill concatenates the cached pages with the suffix's K/V, promoted
    as the reference's concat promotes.

    ``use_ragged``: decode over the ragged (slot, page) work list;
    "auto" turns it on on CUDA and off on the CPU (the reference's rule
    without its TPU tiling terms). ``prefill_chunk_tokens``: prompts
    longer than this (rounded down to page * 2^k) ingest chunk by chunk
    through the mixed step; 0 disables. ``spec_draft_tokens`` /
    ``spec_ngram_max``: prompt-lookup speculative decoding with up to
    that many drafted tokens per step; 0 disables. ``sampling_enabled``:
    serve sampled requests (``generate(sampling=...)``) through the
    sampling decode and verify steps. Unset values come from
    ``runtime_config`` (default ``RuntimeConfig.from_flags()``).

    ``max_queue`` bounds the admission backlog (None: unbounded) and
    ``shed_policy`` ('newest' / 'oldest') picks what overflow sheds;
    ``decode_watchdog_s`` arms the decode watchdog (None defers to the
    runtime config and ``FLAGS_serve_decode_watchdog_s`` at serve time;
    <= 0 disarms). ``name`` names the predictor (a replica of a pool).
    ``devices`` is the reference's device group of a tensor-parallel
    replica: at ``tp_degree`` 1 it is accepted and unused, as there.

    ``engine``: an ``inference.aot.InferenceEngine`` whose programs serve
    the steps (``aot.warm_start`` builds both); attaching it captures
    every program its bundle holds. ``tp_degree`` must be 1 (one
    device). ``role`` ("unified", "prefill" or "decode"; default the
    runtime config's ``serve_role``) is the replica's disaggregated serve
    role: a prefill replica inserts every finished ingest into the prefix
    cache, chunked prompts included, so ``export_page_span`` finds the
    pages and the first token; a decode replica admits a request whose
    span ``import_page_span`` brought in as a full prefix hit, with no
    prefill forward.
    """

    def __init__(self, model, max_batch_size=None, page_size=None,
                 num_pages=None, max_seq_len=None, pad_token_id=0,
                 eos_token_id=None, kv_dtype=None, use_ragged="auto",
                 enable_prefix_cache=True, max_queue=None, shed_policy=None,
                 decode_watchdog_s=None, name=None, engine=None,
                 prefill_chunk_tokens=None, runtime_config=None,
                 spec_draft_tokens=None, spec_ngram_max=None,
                 sampling_enabled=None, tp_degree=None, devices=None,
                 role=None, *, device=None):
        # serve.cold_start_seconds: construction -> first token
        self._t_ctor = time.perf_counter()
        self._cold_start_pending = True
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, predictor "
                             f"device is {self.device}")
        model.eval()
        self._rc = runtime_config
        rc = runtime_config if runtime_config is not None \
            else RuntimeConfig.from_flags()
        if max_batch_size is None:
            max_batch_size = rc.max_batch_size
        if page_size is None:
            page_size = rc.page_size
        if num_pages is None:
            num_pages = rc.num_pages
        if max_seq_len is None:
            max_seq_len = rc.max_seq_len
        if max_queue is None:
            max_queue = rc.max_queue
        if shed_policy is None:
            shed_policy = rc.shed_policy
        if shed_policy not in ("newest", "oldest"):
            raise ValueError(f"shed_policy must be 'newest' or 'oldest', "
                             f"got {shed_policy!r}")
        self.max_queue = None if max_queue is None else int(max_queue)
        self.shed_policy = shed_policy
        self._watchdog_s = decode_watchdog_s
        self._wd_cur = None
        self.name = name
        # a named predictor is one replica of a pool: every serving.*
        # series and serve.* span carries replica=<name>
        self._mlbl = {"replica": name} if name else {}
        self.tp = int(rc.tp_degree if tp_degree is None else tp_degree)
        # the disaggregated serve role: "prefill" fills KV pages and hands
        # off at the first token, "decode" resumes from an imported KV page
        # span, "unified" does both. It joins the metric labels only when
        # it is not "unified" (a unified fleet's label sets stay as they
        # were)
        self.role = rc.serve_role if role is None else role
        check_servable(self.tp, self.role)
        if self.role != "unified":
            self._mlbl["role"] = self.role
        self.tp_topology = "replicated"
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
        if kv_dtype is None:
            # pages in the weights' dtype (a 16-bit model does not pay
            # f32 page bandwidth), as the reference
            kv_dtype = next(iter(model.parameters())).dtype
        self.kv_dtype = kv_dtype_name(kv_dtype)
        with _graphs.device_gate.shared():   # a replica built mid-serve
            self.pool = PagedKVPool(cfg.num_hidden_layers, num_pages + 1,
                                    page_size, cfg.num_key_value_heads,
                                    head_dim, dtype=self.kv_dtype,
                                    device=self.device)
        # inactive slots point their block table at a trash page: the
        # decode step writes one K/V row for EVERY slot
        self._trash = self.pool.alloc(1)[0]
        self.prefix_cache = PrefixCache(page_size) if enable_prefix_cache \
            else None
        if self.prefix_cache is not None:
            self.pool.reclaimer = self.prefix_cache
        if use_ragged == "auto":
            use_ragged = self.device.type == "cuda"
        self.use_ragged = bool(use_ragged)
        # chunked prefill: the threshold is a latency bound, so it
        # normalizes DOWN to a power-of-two multiple of page_size (min
        # one page); chunk buckets form the set {page * 2^k <= chunk_max}
        if prefill_chunk_tokens is None:
            prefill_chunk_tokens = rc.prefill_chunk_tokens
        chunk = int(prefill_chunk_tokens or 0)
        if chunk > 0:
            b = self.page
            while b * 2 <= chunk:
                b *= 2
            chunk = b
        self._chunk_max = chunk
        if spec_draft_tokens is None:
            spec_draft_tokens = rc.spec_draft_tokens
        if spec_ngram_max is None:
            spec_ngram_max = rc.spec_ngram_max
        self._spec_k = max(0, int(spec_draft_tokens))
        self._ngram_max = max(1, int(spec_ngram_max))
        if sampling_enabled is None:
            sampling_enabled = rc.sampling_enabled
        self.sampling_enabled = bool(sampling_enabled)
        # span positions past the prompt (padding) may run past the RoPE
        # table; their outputs are never used
        self._max_pos = cfg.max_position_embeddings - 1
        self.stats = {"prefills": 0, "prefill_batches": 0,
                      "decode_steps": 0, "evictions": 0,
                      "max_in_flight": 0, "prefix_hits": 0,
                      "prefix_partial_hits": 0, "prefix_misses": 0,
                      "pages_reused": 0, "hol_skips": 0,
                      "deadline_evictions": 0, "shed_requests": 0,
                      "watchdog_trips": 0, "cancelled_requests": 0,
                      "spec_ticks": 0, "spec_proposed": 0,
                      "spec_accepted": 0, "prefill_chunks": 0,
                      "chunked_requests": 0, "mixed_steps": 0}
        # the port's own counts beside the reference's ``stats``: sampled
        # requests admitted, paused sampled slots summed over mixed steps,
        # drafts proposed for sampled slots
        self.sampling_stats = {"sampled_requests": 0, "paused_slots": 0,
                               "sampled_spec_proposed": 0}
        self.last_status: List[str] = []
        # seconds from each request's arrival at the serve loop to its
        # first token (the serving.ttft_seconds observations)
        self.last_ttft_s: List[float] = []
        # the reference's serving telemetry; recording is a no-op under
        # observability.enabled(False)
        self._m_queue = _obsm.gauge("serving.queue_depth")
        self._m_util = _obsm.gauge("serving.page_utilization")
        self._m_flight = _obsm.gauge("serving.in_flight")
        self._m_adm = _obsm.counter("serving.admissions")
        self._m_evt = _obsm.counter("serving.evictions")
        self._m_rej = _obsm.counter("serving.rejected_requests")
        self._m_done = _obsm.counter("serving.completed_requests")
        self._m_steps = _obsm.counter("serving.decode_steps")
        self._m_ttft = _obsm.histogram("serving.ttft_seconds", unit="s")
        self._m_tok = _obsm.histogram("serving.token_latency_seconds",
                                      unit="s")
        self._m_prefill = _obsm.histogram("serving.prefill_seconds",
                                          unit="s")
        self._m_pfx_hit = _obsm.counter("serving.prefix_cache_hits")
        self._m_pfx_miss = _obsm.counter("serving.prefix_cache_misses")
        self._m_pfx_pages = _obsm.counter(
            "serving.prefix_cache_pages_reused")
        self._m_hol = _obsm.counter("serving.hol_skips")
        self._m_deadline = _obsm.counter("robustness.deadline_evictions")
        self._m_shed = _obsm.counter("robustness.shed_requests")
        self._m_wedge = _obsm.counter("robustness.watchdog_trips")
        self._m_tier_q = _obsm.gauge("serving.tier.queue_depth")
        self._m_tier_adm = _obsm.counter("serving.tier.admissions")
        self._m_tier_shed = _obsm.counter("serving.tier.shed_requests")
        self._m_cancel = _obsm.counter("serving.cancelled_requests")
        self._m_spec_prop = _obsm.counter("serving.spec.proposed_tokens")
        self._m_spec_acc = _obsm.counter("serving.spec.accepted_tokens")
        self._m_spec_rate = _obsm.gauge("serve.spec.accept_rate")
        self._m_chunks = _obsm.counter("serving.chunked_prefill.chunks")
        self._m_chunk_reqs = _obsm.counter(
            "serving.chunked_prefill.requests")
        self._m_chunk_tok = _obsm.counter(
            "serving.chunked_prefill.tokens")
        self._m_mixed = _obsm.histogram("serve.mixed_step_seconds",
                                        unit="s")
        # static capacity: a registry-only autoscaler normalizes
        # serving.in_flight by it
        _obsm.gauge("serving.slots").set(self.B, **self._mlbl)
        self._req_seq = 0   # process-unique request ids across calls
        # the weights' identity snapshot (``_ensure_ready``) and the live
        # tiered scheduler (``set_tier_weight``)
        self._w_snap = None
        self._live_sched = None
        self._engine = engine
        if engine is not None:
            engine.attach(self)

    @property
    def runtime_config(self):
        """The effective RuntimeConfig: the constructor's, else a fresh
        flag-sourced one (read at every serve, so the watchdog flag takes
        effect between calls)."""
        if self._rc is not None:
            return self._rc
        return RuntimeConfig.from_flags()

    def _bucket_len(self, n):
        """Admission prompt bucket: the smallest tuned-table entry
        covering n, else power-of-two bucketing."""
        for b in self._rc_buckets:
            if b >= n:
                return b
        return _pow2_bucket(n)

    # ------------------------------------------------------ disaggregation
    def export_page_span(self, prompt):
        """The KV pages covering ``prompt`` as a ``KVPageSpan`` for the
        prefill -> decode handoff, or None when it cannot be exported
        (pages reclaimed, a sampled request, no prefix cache, or the
        first token unknown): the router counts that as an
        ``export_miss`` fallback and dispatches without a span. Pages
        and first token come from the prefix-cache trie. Runs on the
        replica's worker thread between serve-loop ticks."""
        if self.prefix_cache is None or not len(prompt):
            return None
        prompt = list(prompt)
        pages, covered, partial, next_token = \
            self.prefix_cache.lookup(prompt)
        ids = list(pages)
        if partial is not None and covered + partial[1] == len(prompt):
            ids.append(partial[0])
            covered += partial[1]
        if covered != len(prompt) or next_token is None:
            return None
        with _graphs.device_gate.shared():
            return self.pool.export_span(prompt, ids, next_token)

    def import_page_span(self, span):
        """Bring a handoff ``KVPageSpan`` into this replica's pool and
        prefix trie (decode side), reusing resident prefix pages; returns
        the pool's import stats. Raises on a corrupted span (checksum),
        a geometry mismatch (``ValueError``) or a full pool
        (``MemoryError``): the caller then prefills. After an import the
        serve loop admits the request as a full prefix hit, with no
        prefill forward. Runs on the replica's worker thread between
        serve-loop ticks."""
        if self.prefix_cache is None:
            raise ValueError(
                "import_page_span needs the prefix cache "
                "(enable_prefix_cache=True): the imported span reaches "
                "the serve loop through the trie")
        with _graphs.device_gate.shared():
            return self.pool.import_span(span, self.prefix_cache)

    def export_request_span(self, prompt):
        """Deprecated alias of ``export_page_span`` (a KV *page* span; the
        rename keeps request tracing *spans* apart from it)."""
        import warnings
        warnings.warn("export_request_span is renamed export_page_span",
                      DeprecationWarning, stacklevel=2)
        return self.export_page_span(prompt)

    def import_request_span(self, span):
        """Deprecated alias of ``import_page_span``."""
        import warnings
        warnings.warn("import_request_span is renamed import_page_span",
                      DeprecationWarning, stacklevel=2)
        return self.import_page_span(span)

    # ------------------------------------------------------ host <-> device
    def _put(self, arr):
        """Host array -> device tensor, snapshotting it: the host mutates
        tables/ctx in place while a dispatched step may still read them.
        On CUDA the copy is asynchronous from pinned memory, so it never
        waits for the steps already queued. Takes a numpy array or a CPU
        tensor. (A captured program copies it into its static input
        buffer.)"""
        t = torch.as_tensor(arr)
        if self.device.type == "cuda":
            # pin_memory() copies, so the snapshot is taken right here
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.clone()

    def _fetch_async(self, *tensors):
        """Start copying small device tensors to the host; returns a
        ``_Fetch`` that waits for exactly those copies."""
        if self.device.type != "cuda":
            return _Fetch(tensors, None)
        outs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in tensors]
        for o, t in zip(outs, tensors):
            o.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return _Fetch(outs, ev)

    def _await_step(self, step):
        """The watchdog's wait for a dispatched step's fetch. Armed
        (``_wd_cur``), it polls the fetch's event against the deadline
        (never ``synchronize()``) and raises ``DecodeWedgedError`` past
        it; the ``decode_wedge`` fault holds "ready" false for its
        ``sleep=``. On the CPU a step is ready when it returns, so the
        fault alone trips it. Unarmed it returns at once: the fetch then
        blocks on the event."""
        wd = self._wd_cur
        if not wd:
            return
        fa = _faults.check("decode_wedge")
        now = time.perf_counter()
        wedged_until = now + float(fa.params.get("sleep", 2 * wd)) \
            if fa is not None else 0.0
        deadline = now + wd
        spin_until = now + _SPIN_S
        ready = step["fetch"].ready
        while True:
            now = time.perf_counter()
            if now >= wedged_until and ready():
                return
            if now >= deadline:
                raise DecodeWedgedError(
                    f"decode step did not resolve within {wd}s")
            if now >= spin_until:
                time.sleep(min(_POLL_S, wd / 100.0))

    # -------------------------------------------------------- device steps
    def _jit_call(self, sig, fn, *args):
        """Run one device step under its program signature (the
        reference's tuples, so manifest keys agree). Without an engine
        this is ``fn(*args)``. With one, a signature it holds replays its
        program; a signature it lacks is the bucket-miss path
        (``compile_fallback``: eager once, then captured and written
        back)."""
        if self._engine is None:
            return fn(*args)
        prog = self._engine.get(sig)
        if prog is not None:
            return prog(*args)
        return self._engine.compile_fallback(sig, fn, args)

    @staticmethod
    def _meta_sig(meta):
        """The meta part of a decode / mixed / spec signature: the shapes
        of the reference's six [G] meta operands, () without ragged."""
        return () if meta is None else ((int(meta.shape[1]),),) * 6

    @torch.no_grad()
    def _raw_forward(self, ids):
        """The plain model forward (logits [N, S, V]) of ``ids`` [N, S]:
        the builder's ``forward`` programs."""
        return self.model(ids)

    def _idle_program(self, sig):
        """(fn, args) of the step ``sig`` names, on operands that send
        every K/V write to the trash page: every slot idle over it,
        dummy prefill rows, empty suffixes. The engine runs it to warm a
        program up before capturing it, and the builder to capture
        signatures that calibration traffic cannot steer."""
        kind = sig[0]
        B, trash, pad = self.B, self._trash, self.pad_token_id
        put = self._put
        if kind == "prefill":
            (nb, bucket), (_, w) = sig[1], sig[2]
            return self._raw_prefill, (
                put(np.full((nb, bucket), pad, np.int64)),
                put(np.zeros((nb, bucket), np.int64)),
                put(np.zeros((nb,), np.int64)),
                put(np.full((nb, w), trash, np.int64)))
        if kind == "suffix":
            (_, sb), (wpb,) = sig[1], sig[2]
            return self._raw_suffix_prefill, (
                put(np.full((1, sb), pad, np.int64)),
                put(np.zeros((1, sb), np.int64)), put(np.int64(0)),
                put(np.int64(0)), put(np.full((wpb,), trash, np.int64)),
                put(np.full((self.pages_per_seq,), trash, np.int64)))
        if kind == "forward":
            return self._raw_forward, (put(np.full(sig[1], pad, np.int64)),)
        tables = np.full((B, self.pages_per_seq), trash, np.int32)
        ctx = np.ones((B,), np.int32)
        meta = None
        if self.use_ragged:
            mb = RaggedMetaBuilder(B, self.pages_per_seq, self.page, trash)
            for b in range(B):
                mb.clear_slot(b)
            meta = put(mb.stacked())
        samp = tuple(put(a) for a in (
            np.zeros((B,), np.float32), np.zeros((B,), np.int32),
            np.ones((B,), np.float32), np.zeros((B,), np.int32),
            np.zeros((B,), np.int32)))
        head = (put(tables), put(ctx), put(np.zeros((B,), np.int32)))
        if kind in ("decode", "decode_sample"):
            got = (kind, tables.shape, self._meta_sig(meta))
            fn, args = ((self._raw_decode_step, head + (meta,))
                        if kind == "decode" else
                        (self._raw_decode_sample_step, head + (samp, meta)))
        elif kind in ("mixed", "spec"):
            qb = sig[1]
            q_lens = np.ones((B,), np.int32)
            span = (put(np.full((B, qb), pad, np.int64)), put(q_lens))
            args = head[:2] + span + head[2:] + (
                self._span(tables, ctx, q_lens, qb), meta)
            got = (kind, qb, tables.shape, self._meta_sig(meta))
            fn = self._raw_mixed_step
            if kind == "spec":
                fn = self._raw_spec_step
                args += (samp if self.sampling_enabled else None,)
        else:
            raise KeyError(f"no program of kind {kind!r}")
        if got != sig:
            raise ValueError(f"signature {sig} does not fit this predictor "
                             f"(its {kind} program is {got})")
        return fn, args

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
            self.pool.write(li, dst_page, dst_off, ka, va)
        return nexts

    @torch.no_grad()
    def _raw_suffix_prefill(self, ids, pos, m, slen, past_rows, page_rows):
        """Prefix-cache partial hit: forward only the prompt SUFFIX,
        attending to the cached prefix K/V gathered from its pages. ids/
        pos [1, sb] (left-padded suffix), m = cached prefix length, slen
        = suffix length (0-d int device tensors, as the reference traces
        them: a captured program takes them as operands), past_rows [Wp]
        page ids covering the prefix
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
            self.pool.write(li, dst_page, dst_off, ck[:, past_len:],
                            cv[:, past_len:])
        return nexts

    def _done(self, tok):
        if self.eos_token_id is not None:
            return tok == self.eos_token_id
        return torch.zeros(tok.shape, dtype=torch.bool, device=tok.device)

    @torch.no_grad()
    def _raw_decode_step(self, tables, ctx, last_tok, meta=None):
        """One decode step for all slots: paged K/V write + paged
        attention (ragged over ``meta`` [6, G] when given) + greedy
        argmax + eos detection, all on the device. Returns (next_token
        [B] int32, done [B] bool)."""
        # the write position and attended length are the same in every
        # layer: computed once per step, not once per layer
        step = decode_index(tables, ctx, self.page)
        entries = [PagedCacheEntry(k, v, tables, ctx, step, meta)
                   for k, v in zip(self.pool.k, self.pool.v)]
        logits, _ = self.model(last_tok[:, None].long(),
                               position_ids=ctx[:, None].long(),
                               past_key_values=PagedKVCache(entries),
                               use_cache=True)
        nxt = logits[:, -1].argmax(dim=-1).to(torch.int32)
        return nxt, self._done(nxt)

    @torch.no_grad()
    def _raw_decode_sample_step(self, tables, ctx, last_tok, samp,
                                meta=None):
        """The sampling variant of the decode step: the same K/V write and
        paged attention, with the next token from ``sample_tokens``.
        ``samp`` holds the per-slot operands on the device (temperature,
        top-k, top-p, seed and the generated-token counter that keys each
        request's stream); temperature <= 0 slots take the raw argmax,
        bitwise ``_raw_decode_step``'s token. Returns (next_token [B]
        int32, done [B] bool)."""
        step = decode_index(tables, ctx, self.page)
        entries = [PagedCacheEntry(k, v, tables, ctx, step, meta)
                   for k, v in zip(self.pool.k, self.pool.v)]
        logits, _ = self.model(last_tok[:, None].long(),
                               position_ids=ctx[:, None].long(),
                               past_key_values=PagedKVCache(entries),
                               use_cache=True)
        nxt, _ = sampling.sample_tokens(logits[:, -1], *samp,
                                        with_logp=False)
        return nxt, self._done(nxt)

    def _span_forward(self, tables, ctx, span_ids, q_lens, tok_in, span,
                      meta):
        """The forward of a span step: slot b runs span_ids[b] with
        column 0 replaced by tok_in[b] (the decode-chained or host
        token), at positions ctx[b] + i, through the mixed cache
        contract. Returns (logits [B, Qb, V], the span ids run)."""
        qb = span_ids.shape[1]
        ids = span_ids.clone()
        ids[:, 0] = tok_in.to(ids.dtype)
        pos = (ctx[:, None].long()
               + torch.arange(qb, device=ctx.device)[None, :])
        entries = [PagedCacheEntry(k, v, tables, ctx, span, meta, q_lens)
                   for k, v in zip(self.pool.k, self.pool.v)]
        logits, _ = self.model(ids.long(),
                               position_ids=pos.clamp(max=self._max_pos),
                               past_key_values=PagedKVCache(entries),
                               use_cache=True)
        return logits, ids

    @torch.no_grad()
    def _raw_mixed_step(self, tables, ctx, span_ids, q_lens, tok_in, span,
                        meta=None):
        """One MIXED prefill+decode step: every slot carries a span -- a
        prefill chunk of q_lens[b] prompt tokens, or one decode token --
        from absolute position ctx[b] (``span`` is its ``span_index``).
        Returns (next_token [B] int32, the argmax at each slot's LAST
        span position, done [B] bool): for a slot finishing its prompt
        this step it is the request's first generated token; mid-prompt
        slots' outputs are ignored."""
        logits, _ = self._span_forward(tables, ctx, span_ids, q_lens,
                                       tok_in, span, meta)
        qb = span_ids.shape[1]
        last = (q_lens.long() - 1).clamp(0, qb - 1)
        rows = torch.arange(last.shape[0], device=last.device)
        nxt = logits[rows, last].argmax(dim=-1).to(torch.int32)
        return nxt, self._done(nxt)

    @torch.no_grad()
    def _raw_spec_step(self, tables, ctx, span_ids, q_lens, tok_in, span,
                       meta=None, samp=None):
        """One speculative verify step: slot b's span is its committed
        last token (column 0, from tok_in) followed by q_lens[b] - 1
        drafted tokens. The longest accepted draft prefix and the bonus
        token are computed on the device (``verify_spans``: argmax
        compare, or with ``samp`` -- the sampling operands, on a
        sampling-enabled predictor -- rejection sampling for the sampled
        slots), and the REJECTED positions' K/V is rolled back there: the
        span's destinations are read before the forward (the pages are
        updated in place) and written back at span index accepted < i <
        q_lens. Returns (bonus [B] int32, accepted [B] int32)."""
        src_b, src_i, page, off = span.rows
        old_k = [k[page, off] for k in self.pool.k]
        old_v = [v[page, off] for v in self.pool.v]
        logits, ids = self._span_forward(tables, ctx, span_ids, q_lens,
                                         tok_in, span, meta)
        if samp is None:
            accepted, bonus = sampling.verify_spans_greedy(logits, ids,
                                                           q_lens)
        else:
            accepted, bonus = sampling.verify_spans(logits, ids, q_lens,
                                                    *samp)
        # padding entries carry span index -1, so they are never restored:
        # the write-back touches exactly the span's own destinations
        rej = (src_i > accepted.long()[src_b])[:, None, None]
        for pages, old in zip(self.pool.k + self.pool.v, old_k + old_v):
            pages[page, off] = torch.where(rej, old, pages[page, off])
        return bonus, accepted

    # -------------------------------------------------------------- serve
    def generate(self, prompts, max_new_tokens=32, strict=True,
                 deadline_s=None, tiers=None, tier_weights=None,
                 sampling=None):
        """Continuous batching over a list of prompts: List[List[int]] ->
        List[List[int]] (new tokens per prompt, eos stripped, in request
        order): ``generate_stream(...).drain()``. ``max_new_tokens`` is
        one budget for every request or a list of per-request budgets.

        ``sampling``: a ``SamplingParams`` for every request, or a list
        with one per request (None = greedy). A request whose temperature
        is above 0 is sampled, and needs a predictor built with
        ``sampling_enabled=True``.

        A request that can never be served (prompt + max_new_tokens over
        ``max_seq_len``, more KV pages than the pool holds, or sampling on
        a predictor without it) raises ValueError up front when
        ``strict``; otherwise its result is [] and ``last_status[r]``
        names the reason ('rejected_over_max_seq_len' /
        'rejected_over_pool_capacity' / 'rejected_sampling_disabled'; 'ok'
        for served requests).

        Robustness, as in the reference:

        - ``deadline_s`` (scalar or per-request list, seconds from the
          request's arrival): an expired request is evicted, from the
          queue with result [] or mid-decode with its partial tokens, and
          ``last_status[r] == "deadline"``. Expired queued requests are
          evicted before any shed decision.
        - the constructor's ``max_queue`` bounds the admission backlog;
          the excess is shed at entry per ``shed_policy`` ('newest' sheds
          the latest arrivals, 'oldest' the stalest) with ``last_status
          "shed"``. With tiers the lowest-weight tier over its weight
          share of ``max_queue`` sheds first, and a tier within its share
          is never shed (``serving.scheduler``).
        - the decode watchdog (constructor ``decode_watchdog_s``, else
          ``FLAGS_serve_decode_watchdog_s``) fails the pending requests
          with ``last_status "watchdog"`` when a dispatched step does not
          resolve in time, instead of hanging. The pages of a wedged step
          are not reclaimed: rebuild the predictor.

        ``tiers`` (a tier name per request) and ``tier_weights`` ({tier:
        weight}) switch the admission queue to weighted deficit round
        robin: each tier's admission share converges to its weight over
        the sum of the weights."""
        return self.generate_stream(
            prompts, max_new_tokens=max_new_tokens, strict=strict,
            deadline_s=deadline_s, tiers=tiers, tier_weights=tier_weights,
            sampling=sampling).drain()

    def generate_stream(self, prompts, max_new_tokens=32, strict=True,
                        deadline_s=None, tiers=None, tier_weights=None,
                        sampling=None):
        """Streaming ``generate``: the same admission, fairness and
        robustness, but returns a ``serving.TokenStream`` that yields
        ``StreamEvent``s as decode ticks complete: one "token" event per
        tick and request, whose ``span`` holds every token the tick
        committed (a speculative tick commits several), and one "end"
        event per request with its final status. ``results`` and
        ``last_status`` fill in place as requests finish.

        ``stream.cancel(r)`` evicts request r at the next loop iteration
        (pages released, ``last_status[r] == "cancelled"``); closing the
        stream cancels every pending request the same way."""
        n = len(prompts)
        if sampling is None:
            per_sp = [None] * n
        else:
            per_sp = list(sampling) \
                if isinstance(sampling, (list, tuple)) \
                and not isinstance(sampling, SamplingParams) \
                else [sampling] * n
            if len(per_sp) != n:
                raise ValueError(f"sampling has {len(per_sp)} entries for "
                                 f"{n} prompts")
            if strict and not self.sampling_enabled and any(
                    self._wants_sampling(sp) for sp in per_sp):
                raise ValueError(
                    "sampling requested but this predictor was built with "
                    "sampling_enabled=False (pass sampling_enabled=True, "
                    "or strict=False to reject those requests and serve "
                    "the rest)")
        if deadline_s is None:
            per_dl = [None] * n
        else:
            per_req = deadline_s if isinstance(deadline_s, (list, tuple)) \
                else [deadline_s] * n
            if len(per_req) != n:
                raise ValueError(f"deadline_s has {len(per_req)} entries "
                                 f"for {n} prompts")
            per_dl = [None if d is None else float(d) for d in per_req]
        if tiers is not None and len(tiers) != n:
            raise ValueError(f"tiers has {len(tiers)} entries for {n} "
                             "prompts")
        if isinstance(max_new_tokens, int):
            max_new = [max_new_tokens] * n
        else:
            max_new = [int(m) for m in max_new_tokens]
            if len(max_new) != n:
                raise ValueError(f"max_new_tokens has {len(max_new)} "
                                 f"entries for {n} prompts")
        if strict:
            for r, p in enumerate(prompts):
                uns = self._unservable(p, max_new[r])
                if uns is not None:
                    raise ValueError(
                        f"request {r} can never be served: {uns[1]}. "
                        "Raise max_seq_len/num_pages, shorten the prompt, "
                        "or pass strict=False to reject it and serve the "
                        "rest.")
        reqs = [ServeRequest(list(p), max_new[r],
                             tiers[r] if tiers is not None else None,
                             per_dl[r], None, per_sp[r])
                for r, p in enumerate(prompts)]
        results, status, cancel = [None] * n, ["queued"] * n, set()
        gen = self._serve(reqs, None, results, status, cancel,
                          tier_weights)
        return TokenStream(gen, results, status, cancel)

    def serve_stream(self, intake, tier_weights=None):
        """Open-ended continuous serving: ``intake()`` is polled every
        loop iteration and returns a list (possibly empty) of new
        ``serving.ServeRequest``s, or None to close the stream (the loop
        then serves what it holds and ends). Requests join the running
        batch as slots free up. ``intake`` may block briefly while the
        loop is idle. Returns a ``serving.TokenStream``; ``results`` and
        ``last_status`` grow as requests arrive, and every event carries
        its request's ``meta``."""
        results, status, cancel = [], [], set()
        gen = self._serve([], intake, results, status, cancel,
                          tier_weights)
        return TokenStream(gen, results, status, cancel)

    def set_tier_weight(self, tier, weight):
        """Shift the live fair-queueing share of ``tier``. A no-op until
        a tiered serve loop is running."""
        if self._live_sched is not None:
            self._live_sched.set_weight(tier, weight)

    @staticmethod
    def _wants_sampling(sp):
        """True when the request needs the sampling steps: a
        SamplingParams with temperature > 0 (temperature <= 0 is greedy,
        served bit-identically by the argmax steps)."""
        return sp is not None and float(sp.temperature) > 0

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

    def _ensure_ready(self):
        """Flush the prefix cache when a weight changed since the last
        serve: its pages hold K/V computed with the old weights. A
        parameter or buffer that is another object, or whose storage
        (``data_ptr``, a ``p.data =`` rebind) or version counter (an
        in-place ``copy_``) moved, is a change. The first call only
        takes the snapshot."""
        m = self.model
        snap = [(t, t.data_ptr(), t._version)
                for t in (*m.parameters(), *m.buffers())]
        prev, self._w_snap = self._w_snap, snap
        if prev is None or self.prefix_cache is None:
            return
        if len(prev) != len(snap) or any(
                a is not b or pa != pb or va != vb
                for (a, pa, va), (b, pb, vb) in zip(prev, snap)):
            self.prefix_cache.clear(self.pool)

    def _serve(self, initial, intake, results, status, cancel,
               tier_weights):
        """The serve loop, a generator of ``StreamEvent``s.
        ``generate_stream`` seeds ``initial`` with intake None;
        ``serve_stream`` starts empty and polls ``intake``. Admission,
        fairness, shedding, deadlines, cancellation, decode and the
        watchdog live here once."""
        if self._engine is not None:
            self._engine.check_bindings()
        self._ensure_ready()
        rc = self.runtime_config
        wd = self._watchdog_s
        if wd is None:
            wd = float(rc.decode_watchdog_s)
            if not wd and self._rc is not None:
                # 0 in an explicit config means "unset": the flag still
                # arms the watchdog (decode_watchdog_s=0 forces it off)
                wd = float(RuntimeConfig.from_flags().decode_watchdog_s)
        self._wd_cur = wd if wd and wd > 0 else None
        self.last_status = status
        ttft = [None] * len(results)
        self.last_ttft_s = ttft
        mlbl = self._mlbl
        # refreshed every serve: a registry reset() between calls must
        # not leave the autoscaler without the capacity
        _obsm.gauge("serving.slots").set(self.B, **mlbl)
        use_tiers = tier_weights is not None or any(
            r.tier is not None for r in initial)
        q = WeightedFairScheduler(tier_weights,
                                  quantum=float(rc.wfs_quantum)) \
            if use_tiers else FifoQueue()
        self._live_sched = q if use_tiers else None

        # per-request state (grows under dynamic intake)
        prompts, max_new, metas, tier_of = [], [], [], []
        deadlines, arrival, samp_of, req_sp = [], [], [], []
        has_deadlines = False
        out = collections.deque()        # events awaiting the consumer
        closed = intake is None
        tiers_seen = set()

        gen_sp = _obstr.start_span("serve.generate", parent=None,
                                   n_prompts=len(initial),
                                   dynamic=bool(intake), **mlbl)

        def _ts(r):
            # the request span's last event times its stream event; past
            # the span's event cap that event is stale: the wall clock
            evs = getattr(req_sp[r], "events", None)
            if evs and len(evs) < _obstr._MAX_EVENTS:
                return evs[-1]["ts"]
            return time.time()

        def emit(r, kind, token=None, index=0, st=None, span=None):
            if span is None and token is not None:
                span = (token,)
            out.append(StreamEvent(r, kind, token, index, _ts(r), st,
                                   metas[r], tuple(span or ())))

        def tier_lbl(r):
            return {"tier": tier_of[r]} if tier_of[r] is not None else {}

        def add_request(sreq):
            nonlocal has_deadlines
            r = len(prompts)
            p = list(sreq.prompt)
            mn = int(32 if sreq.max_new_tokens is None
                     else sreq.max_new_tokens)
            prompts.append(p)
            max_new.append(mn)
            metas.append(sreq.meta)
            tier_of.append(sreq.tier)
            samp_of.append(sreq.sampling)
            now = time.perf_counter()
            arrival.append(now)
            deadlines.append(None if sreq.deadline_s is None
                             else now + float(sreq.deadline_s))
            has_deadlines = has_deadlines or sreq.deadline_s is not None
            if r >= len(results):
                results.append(None)
                status.append("queued")
            if r >= len(ttft):
                ttft.append(None)
            self._req_seq += 1
            # a ServeRequest carrying a TraceContext parents its span
            # there (the submitter's trace); else it roots under this
            # call's serve.generate span
            req_sp.append(_obstr.start_span(
                "serve.request", parent=(sreq.trace if sreq.trace
                                         is not None else gen_sp),
                request_id=f"req{self._req_seq}", idx=r, prompt_len=len(p),
                **tier_lbl(r), **mlbl))
            uns = self._unservable(p, mn)
            if uns is None and not self.sampling_enabled \
                    and self._wants_sampling(samp_of[r]):
                uns = ("sampling_disabled", "")
            if uns is not None:
                results[r] = []
                status[r] = "rejected_" + uns[0]
                req_sp[r].event("rejected", reason=uns[0])
                req_sp[r].end(status=status[r])
                self._m_rej.inc(reason=uns[0], **mlbl)
                self._m_done.inc(status=status[r], **mlbl)
                emit(r, "end", st=status[r])
                return
            q.push(r, tier=sreq.tier, cost=stage_cost(len(p), mn, None))
            req_sp[r].event("queued")

        def finish_queued(r, st, span_event_kw=None):
            """Terminal outcome of a request that never held a slot."""
            results[r] = []
            status[r] = st
            req_sp[r].event(st, **(span_event_kw or {}))
            req_sp[r].end(status=st)
            self._m_done.inc(status=st, **mlbl)
            emit(r, "end", st=st)

        def expire_queued():
            """Evict deadline-expired queued requests, before any shed
            decision (an expired entry must never shed a live one)."""
            if not has_deadlines:
                return
            now = time.perf_counter()
            for r in q.ids():
                dl = deadlines[r]
                if dl is not None and now >= dl:
                    q.remove(r)
                    self.stats["deadline_evictions"] += 1
                    self._m_deadline.inc(stage="queued", **mlbl)
                    finish_queued(r, "deadline", {"stage": "queued"})

        def shed_overflow():
            """Bounded admission queue: shed the overflow (lowest tier
            first under tiers). The ``serve_flood`` fault inflates the
            apparent depth."""
            if self.max_queue is None:
                return
            flood = 0
            ff = _faults.check("serve_flood")
            if ff is not None and ff.mode == "flood":
                flood = int(ff.params.get("n", self.B))
            while len(q) and len(q) + flood > self.max_queue:
                r = q.pick_shed(self.shed_policy, self.max_queue)
                if r is None:
                    break
                self.stats["shed_requests"] += 1
                self._m_shed.inc(policy=self.shed_policy, **mlbl)
                if tier_of[r] is not None:
                    self._m_tier_shed.inc(tier=tier_of[r], **mlbl)
                finish_queued(r, "shed", {"policy": self.shed_policy})

        for sreq in initial:
            add_request(sreq)
        expire_queued()           # expired entries never count against
        shed_overflow()           # max_queue, and never trigger sheds

        slot_req = [-1] * self.B                  # -1 = free
        slot_pages = [[] for _ in range(self.B)]
        slot_new = [[] for _ in range(self.B)]
        # chunked prefill: the un-ingested prompt tail per slot (a
        # non-empty tail turns the next dispatch into a MIXED step)
        slot_pending = [[] for _ in range(self.B)]
        # prompt + committed tokens: what the prompt-lookup drafter reads
        slot_hist = [[] for _ in range(self.B)]
        tables = np.full((self.B, self.pages_per_seq), self._trash, np.int32)
        ctx = np.ones((self.B,), np.int32)        # inactive: 1 dummy token
        last_tok_host = np.zeros((self.B,), np.int32)
        override = np.zeros((self.B,), bool)      # host token beats device
        builder = RaggedMetaBuilder(self.B, self.pages_per_seq, self.page,
                                    self._trash) if self.use_ragged \
            else None
        spec_mode = self._spec_k > 0
        # sampling: per-slot operand rows (greedy zeros), and the flag of
        # a slot whose first token is still to be drawn (first-token
        # replay: the admission argmax is discarded, the last prompt
        # token runs again through the sampling step)
        s_temp = np.zeros((self.B,), np.float32)
        s_topk = np.zeros((self.B,), np.int32)
        s_topp = np.ones((self.B,), np.float32)
        s_seed = np.zeros((self.B,), np.int32)
        slot_await_first = [False] * self.B

        def set_samp(b, sp):
            if sp is None:
                s_temp[b], s_topk[b], s_topp[b], s_seed[b] = 0, 0, 1, 0
            else:
                s_temp[b] = float(sp.temperature)
                s_topk[b] = int(sp.top_k)
                s_topp[b] = float(sp.top_p)
                s_seed[b] = int(sp.seed)

        def samp_vec(pend):
            """The sampling operands of one dispatch, on the device: the
            per-slot rows and the generated-token counter that keys each
            request's stream. A slot with a step in flight (``pend``)
            counts its pending token; a mixed step, which commits no
            token for its chunk and paused slots, is never in flight
            here (sampling-enabled predictors resolve it first)."""
            ctr = np.fromiter((len(slot_new[b]) + (1 if b in pend else 0)
                               for b in range(self.B)), np.int32, self.B)
            return tuple(self._put(a) for a in (s_temp, s_topk, s_topp,
                                                 s_seed, ctr))

        def evict(b, status_val="ok"):
            r = slot_req[b]
            results[r] = slot_new[b]
            status[r] = status_val
            req_sp[r].event("finish" if status_val == "ok" else status_val,
                            tokens=len(slot_new[b]))
            req_sp[r].end(status=status_val)
            self.pool.release(slot_pages[b])
            slot_req[b], slot_pages[b], slot_new[b] = -1, [], []
            slot_pending[b], slot_hist[b] = [], []
            slot_await_first[b] = False
            set_samp(b, None)
            tables[b, :] = self._trash
            ctx[b] = 1
            if builder is not None:
                builder.clear_slot(b)
            self.stats["evictions"] += 1
            self._m_evt.inc(**mlbl)
            self._m_done.inc(status=status_val, **mlbl)
            emit(r, "end", st=status_val)

        def apply_cancels():
            """Consumer-driven cancellation: queued requests leave the
            queue, running ones are evicted (pages released), both with
            'cancelled'. '*' cancels everything and closes the intake.
            A step already in flight for an evicted slot still writes one
            K/V row into the freed pages; it runs on the same stream
            before the next owner's prefill, and its token is dropped at
            resolve (the slot's request changed)."""
            nonlocal closed
            if not cancel:
                return
            # one atomic copy: TokenStream.cancel adds from other threads
            snap = set(cancel)
            if "*" in snap:
                closed = True
                targets = None
            else:
                targets = {r for r in snap
                           if isinstance(r, int) and r < len(prompts)}
                if not targets:
                    return
            for r in list(q.ids()):
                if targets is None or r in targets:
                    q.remove(r)
                    self.stats["cancelled_requests"] += 1
                    self._m_cancel.inc(stage="queued", **mlbl)
                    finish_queued(r, "cancelled", {"stage": "queued"})
            for b in range(self.B):
                r = slot_req[b]
                if r >= 0 and (targets is None or r in targets):
                    self.stats["cancelled_requests"] += 1
                    self._m_cancel.inc(stage="decoding", **mlbl)
                    evict(b, "cancelled")
            if targets is not None:
                cancel.difference_update(targets)

        def expire_deadlines():
            """Evict every request whose deadline passed: queued ones end
            with [] and running ones with their partial tokens."""
            expire_queued()
            now = time.perf_counter()
            for b in range(self.B):
                r = slot_req[b]
                if r >= 0 and deadlines[r] is not None \
                        and now >= deadlines[r]:
                    self.stats["deadline_evictions"] += 1
                    self._m_deadline.inc(stage="decoding", **mlbl)
                    evict(b, "deadline")

        def reserve(r):
            """Reserve pages for request r (prefix-cache lookup, retain,
            alloc, copy-on-write): the admission plan, or None when the
            pool cannot satisfy it right now. Prompts over the chunk
            threshold ingest through the mixed step and bypass the
            prefix cache (no monolithic prefill computes the
            per-position tokens the trie stores). Sampled requests
            bypass it too, lookup and insertion: their first-token
            replay rewrites position L-1's K/V, which must land in a page
            the request owns alone."""
            prompt = prompts[r]
            L = len(prompt)
            need = -(-(L + max_new[r]) // self.page)
            sampled = self._wants_sampling(samp_of[r])
            chunked = bool(self._chunk_max) and L > self._chunk_max
            full_pages, covered, partial, cached_next = [], 0, None, None
            if self.prefix_cache is not None and not chunked \
                    and not sampled:
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
                        "pages": fresh, "reused": 0, "next": None,
                        "chunked": False, "no_cache": sampled}
            if partial is not None:
                # copy-on-write at the divergence page
                self.pool.copy_into(partial[0], fresh[0])
                self.pool.release([partial[0]])
                covered += partial[1]
            return {"r": r, "prompt": prompt, "covered": covered,
                    "pages": full_pages + fresh,
                    "reused": len(full_pages) + (1 if partial else 0),
                    "next": cached_next if covered == L else None,
                    "chunked": chunked, "no_cache": sampled}

        def note_cold_start():
            # serve.cold_start_seconds, once per predictor: construction
            # to first token, labelled warm (a bundle held programs) or
            # cold. The builder's recording engine is not serving.
            if not self._cold_start_pending:
                return
            self._cold_start_pending = False
            eng = self._engine
            if not (eng is not None and eng.recording):
                _obsm.gauge("serve.cold_start_seconds", unit="s").set(
                    time.perf_counter() - self._t_ctor,
                    mode=("warm" if eng is not None and eng.warm
                          else "cold"), **mlbl)

        def observe_ttft(r):
            ttft[r] = time.perf_counter() - arrival[r]
            self._m_ttft.observe(ttft[r], **tier_lbl(r), **mlbl)

        def place_chunked(b, plan):
            """Install a chunked admission: pages reserved, no forward
            yet -- the prompt ingests chunk by chunk through the mixed
            step. TTFT is recorded when the final chunk resolves."""
            r = plan["r"]
            pages = plan["pages"]
            slot_req[b], slot_pages[b] = r, pages
            slot_new[b] = []
            tables[b, :] = self._trash
            tables[b, :len(pages)] = pages
            ctx[b] = 0
            slot_pending[b] = list(plan["prompt"])
            slot_hist[b] = list(plan["prompt"])
            set_samp(b, samp_of[r])
            override[b] = False
            if builder is not None:
                builder.set_slot(b, tables[b], 1)
            status[r] = "running"
            req_sp[r].event("admitted", slot=b, chunked=True)
            self.stats["chunked_requests"] += 1
            self._m_chunk_reqs.inc(**mlbl)
            self._m_adm.inc(**mlbl)
            if tier_of[r] is not None:
                self._m_tier_adm.inc(tier=tier_of[r], **mlbl)
            if self._wants_sampling(samp_of[r]):
                self.sampling_stats["sampled_requests"] += 1

        def chunk_first_token(b, r, first=None):
            """The step that gives the request its first generated token
            resolved (a final chunk's argmax ``first``, or a sampled
            request's replay draw). On a prefill-role replica the
            finished ingest also goes into the prefix trie (chunked
            prompts bypass it at admission), so the handoff's span export
            finds the pages and the first token."""
            req_sp[r].event("first_token")
            note_cold_start()
            observe_ttft(r)
            if (self.role == "prefill" and first is not None
                    and self.prefix_cache is not None
                    and not self._wants_sampling(samp_of[r])):
                L = len(prompts[r])
                self.prefix_cache.insert(
                    prompts[r], slot_pages[b][:-(-L // self.page)],
                    [None] * (L - 1) + [int(first)], self.pool)

        def sampled_chunk_first(b, r):
            """A sampled request's final chunk resolved: its argmax is
            discarded and the slot moves to first-token replay (see
            ``place``)."""
            ctx[b] -= 1
            last_tok_host[b] = prompts[r][-1]
            override[b] = True
            slot_await_first[b] = True

        def place(b, plan, first):
            """Install an admitted request into slot b. ``first`` is the
            admission argmax; a sampled request discards it: the slot
            backs up one position and replays the last prompt token
            through the sampling step, whose draw the next resolve takes
            as the first token (TTFT lands there)."""
            r = plan["r"]
            L = len(plan["prompt"])
            pages = plan["pages"]
            slot_req[b], slot_pages[b] = r, pages
            tables[b, :] = self._trash
            tables[b, :len(pages)] = pages
            set_samp(b, samp_of[r])
            status[r] = "running"
            if self._wants_sampling(samp_of[r]):
                slot_new[b] = []
                slot_hist[b] = list(plan["prompt"])
                ctx[b] = L - 1
                last_tok_host[b] = plan["prompt"][-1]
                override[b] = True
                slot_await_first[b] = True
                if builder is not None:
                    builder.set_slot(b, tables[b], L)
                req_sp[r].event("admitted", slot=b, sampled=True)
                self._m_adm.inc(**mlbl)
                if tier_of[r] is not None:
                    self._m_tier_adm.inc(tier=tier_of[r], **mlbl)
                self.sampling_stats["sampled_requests"] += 1
                return
            slot_new[b] = [first]
            slot_hist[b] = list(plan["prompt"]) + [first]
            ctx[b] = L
            last_tok_host[b] = first
            override[b] = True
            if builder is not None:
                builder.set_slot(b, tables[b], L + 1)
            req_sp[r].event("admitted", slot=b)
            req_sp[r].event("first_token")
            note_cold_start()
            self._m_adm.inc(**mlbl)
            if tier_of[r] is not None:
                self._m_tier_adm.inc(tier=tier_of[r], **mlbl)
            observe_ttft(r)
            if self.eos_token_id is not None and first == self.eos_token_id:
                slot_new[b] = []          # eos is stripped
                evict(b)
                return
            emit(r, "token", token=first, index=1)
            if max_new[r] <= 1:
                evict(b)                  # budget met at admission

        def admission_round():
            """One pass over the queue in discipline order (FIFO, or
            weighted deficit round robin under tiers): fill every free
            slot with the first admissible requests (a request waiting
            for pages does not block later ones), then run the round's
            prefills: full hits need none, partial hits a suffix prefill,
            misses batch per bucket, and chunked requests wait for the
            mixed step."""
            free = [b for b in range(self.B) if slot_req[b] < 0]
            if not free or not len(q):
                return False
            plans, skipped, seq = [], [], []
            budget = len(q)
            while len(plans) < len(free) and budget > 0:
                r = q.pop()
                if r is None:
                    break
                budget -= 1
                plan = reserve(r)
                if plan is None:
                    skipped.append(r)
                    seq.append(False)
                else:
                    q.consume(r)
                    plans.append(plan)
                    seq.append(True)
            for r in reversed(skipped):
                q.push_front(r)
            if plans and skipped:
                last_pick = max(i for i, s in enumerate(seq) if s)
                n_hol = sum(1 for i, s in enumerate(seq)
                            if not s and i < last_pick)
                if n_hol:
                    self.stats["hol_skips"] += n_hol
                    self._m_hol.inc(n_hol, **mlbl)
            if not plans:
                return False
            t0 = time.perf_counter()
            now_plans = [p for p in plans if not p["chunked"]]
            hits = [p for p in now_plans if p["next"] is not None]
            partials = [p for p in now_plans
                        if p["next"] is None and p["covered"] > 0]
            misses = [p for p in now_plans
                      if p["next"] is None and p["covered"] == 0]
            pf_sp = _obstr.start_span(
                "serve.prefill", parent=gen_sp, n=len(plans),
                hits=len(hits), partial=len(partials), misses=len(misses),
                chunked=len(plans) - len(now_plans))
            for plan in now_plans:
                req_sp[plan["r"]].event("prefill", covered=plan["covered"],
                                        reused=plan["reused"])
            firsts = {}
            for plan in hits:
                firsts[plan["r"]] = int(plan["next"])
                self.stats["prefix_hits"] += 1
                self.stats["pages_reused"] += plan["reused"]
                self._m_pfx_hit.inc(**mlbl)
                self._m_pfx_pages.inc(plan["reused"], **mlbl)
            for plan in partials:
                firsts[plan["r"]] = self._suffix_prefill(plan)
                self.stats["prefix_partial_hits"] += 1
                self.stats["pages_reused"] += plan["reused"]
                self._m_pfx_hit.inc(kind="partial", **mlbl)
                self._m_pfx_pages.inc(plan["reused"], **mlbl)
            by_bucket = {}
            for plan in misses:
                by_bucket.setdefault(self._bucket_len(len(plan["prompt"])),
                                     []).append(plan)
                self.stats["prefix_misses"] += 1
                self._m_pfx_miss.inc(**mlbl)
            for bucket, group in sorted(by_bucket.items()):
                firsts.update(self._batch_prefill(bucket, group))
            if now_plans:
                # the prefills' host time: each one downloads its tokens
                self._m_prefill.observe(time.perf_counter() - t0, **mlbl)
            pf_sp.end()
            for b, plan in zip(free, plans):
                if plan["chunked"]:
                    place_chunked(b, plan)
                else:
                    place(b, plan, firsts[plan["r"]])
            return True

        def on_wedged():
            """The watchdog tripped: fail everything still pending
            instead of hanging. The wedged step's pages are not
            reclaimed (the step may still write them): the predictor
            should be rebuilt. The flight dump carries the wedged
            requests' spans."""
            self.stats["watchdog_trips"] += 1
            self._m_wedge.inc(**mlbl)
            for b in range(self.B):
                r = slot_req[b]
                if r >= 0:
                    results[r] = slot_new[b]
                    status[r] = "watchdog"
                    slot_req[b] = -1
                    req_sp[r].event("watchdog", stage="decoding",
                                    tokens=len(slot_new[b]))
                    req_sp[r].end(status="watchdog")
                    self._m_done.inc(status="watchdog", **mlbl)
                    emit(r, "end", st="watchdog")
            for r in list(q.ids()):
                q.remove(r)
                finish_queued(r, "watchdog", {"stage": "queued"})
            gen_sp.event("decode_wedged")
            gen_sp.end(status="watchdog")
            _obstr.flight_dump(reason="decode_wedged")

        def resolve(step):
            """Resolve a dispatched step; False when the watchdog tripped
            (the pending requests are failed and the loop ends)."""
            try:
                if step.get("spec"):
                    self._resolve_spec_step(
                        step, slot_req, slot_new, slot_hist, last_tok_host,
                        max_new, ctx, override, builder, evict,
                        chunk_first_token, emit, req_sp)
                else:
                    self._resolve_step(
                        step, slot_req, slot_new, last_tok_host, max_new,
                        evict, chunk_first_token, slot_hist,
                        sampled_chunk_first, emit, req_sp)
                return True
            except DecodeWedgedError:
                on_wedged()
                return False

        inflight = None
        evictions_seen = -1
        finished = False
        try:
            while True:
                # device work runs under the device gate's shared side:
                # a CUDA-graph capture on another thread (a warm start,
                # a bucket miss) waits for this iteration to end, and
                # this loop waits while one runs (framework.graphs)
                with _graphs.device_gate.shared():
                    apply_cancels()
                    expire_deadlines()
                    if inflight is not None and (
                            spec_mode or (self.sampling_enabled
                                          and "chunk_mid" in inflight)):
                        # resolve BEFORE dispatching when the next dispatch
                        # needs this step's host state: in speculative mode
                        # the drafter needs the committed tokens in the
                        # histories, and ctx / the ragged meta rewound to the
                        # kept prefix; a mixed step on a sampling-enabled
                        # predictor moves sampled slots into first-token
                        # replay and un-pauses sampled decode slots, and a
                        # dispatch chained in between would take the
                        # discarded argmax or advance ctx past the replay
                        # position
                        prev, inflight = inflight, None
                        if not resolve(prev):
                            break
                    if not closed:
                        batch = intake()
                        if batch is None:
                            closed = True
                        elif batch:
                            for sreq in batch:
                                add_request(sreq)
                            expire_queued()
                            shed_overflow()
                    admitted = False
                    while admission_round():
                        admitted = True
                    active = [b for b in range(self.B) if slot_req[b] >= 0]
                    self._m_queue.set(len(q), **mlbl)
                    self._m_flight.set(len(active), **mlbl)
                    if use_tiers:
                        depths = q.depths()
                        for t_name in tiers_seen - set(depths):
                            self._m_tier_q.set(0, tier=t_name, **mlbl)
                        for t_name, d in depths.items():
                            tiers_seen.add(t_name)
                            self._m_tier_q.set(d, tier=t_name, **mlbl)
                    if admitted or self.stats["evictions"] != evictions_seen:
                        # free_count walks the prefix trie: refresh only when
                        # pages moved, not every decode step
                        evictions_seen = self.stats["evictions"]
                        self._m_util.set((self.capacity - self.pool.free_count)
                                         / max(self.capacity, 1), **mlbl)
                    cur = None
                    if active:
                        self.stats["max_in_flight"] = max(
                            self.stats["max_in_flight"], len(active))
                        # a dispatch is useless when every active slot's
                        # budget is met once the in-flight step resolves
                        pend = {b for b, r in inflight["snap"]
                                if slot_req[b] == r} if inflight else set()
                        useful = any(len(slot_new[b]) + (1 if b in pend else 0)
                                     < max_new[slot_req[b]] for b in active)
                        if any(slot_pending[b] for b in active):
                            # a prompt is mid-ingest: this step runs the
                            # MIXED program -- its chunk advances while the
                            # decode slots take their normal token step.
                            # Sampled decode slots PAUSE (the mixed step has
                            # no sampling operands): they run their committed
                            # token again at the same position, and resume
                            # after the ingest
                            paused = [b for b in active if not slot_pending[b]
                                      and self._wants_sampling(
                                          samp_of[slot_req[b]])]
                            for b in paused:
                                override[b] = True
                            cur = self._dispatch_mixed_step(
                                active, slot_req, slot_pending, tables, ctx,
                                last_tok_host, override, builder, inflight,
                                req_sp, paused)
                        elif useful:
                            if spec_mode:
                                sv = samp_vec(set()) if self.sampling_enabled \
                                    else None
                                cur = self._dispatch_spec_step(
                                    active, slot_req, slot_hist, tables, ctx,
                                    last_tok_host, override, builder, max_new,
                                    slot_new, sv, s_temp)
                            else:
                                sv = samp_vec(pend) if self.sampling_enabled \
                                    else None
                                cur = self._dispatch_step(
                                    active, slot_req, tables, ctx,
                                    last_tok_host, override, builder, inflight,
                                    sv)
                    if cur is not None:
                        # slots awaiting their first sampled token draw it in
                        # this step: they ride the chunk_final first-token
                        # path of the resolver (paused slots keep waiting)
                        firsts = {b for b in active if slot_await_first[b]
                                  and b not in cur.get("chunk_mid", ())}
                        if firsts:
                            cur["chunk_final"] = set(
                                cur.get("chunk_final", ())) | firsts
                            for b in firsts:
                                slot_await_first[b] = False
                        # sampled requests' final chunks: from the argmax
                        # first-token path to first-token replay
                        cfs = {b for b in cur.get("chunk_final", ())
                               if b not in firsts and slot_req[b] >= 0
                               and self._wants_sampling(samp_of[slot_req[b]])}
                        if cfs:
                            cur["chunk_final"] = set(cur["chunk_final"]) - cfs
                            cur["chunk_final_sampled"] = cfs
                    prev, inflight = inflight, cur
                    if prev is not None:
                        if not resolve(prev):
                            break
                    elif cur is None:
                        if closed:
                            break
                        # an idle open stream: intake() is expected to block
                        # briefly itself; this only keeps the loop from
                        # spinning
                        if not out:
                            time.sleep(0.0002)
                while out:
                    yield out.popleft()
            for r, res in enumerate(results):
                if res is None:           # never placed (defensive)
                    results[r] = []
                    if status[r] in ("queued", "running"):
                        status[r] = "incomplete"
                        self._m_done.inc(status="incomplete", **mlbl)
                        emit(r, "end", st="incomplete")
            for r, sp in enumerate(req_sp):
                if not sp.ended:          # stragglers (defensive path)
                    sp.end(status=status[r])
            gen_sp.end()
            while out:
                yield out.popleft()
            finished = True
        finally:
            if not finished:
                # the consumer abandoned the generator (GeneratorExit:
                # "cancelled") or an exception unwound out of the loop
                # ("error", and the exception propagates). Either way the
                # pages are released; pending events are lost.
                exc = sys.exc_info()[1]
                aborted = exc is not None and not isinstance(
                    exc, GeneratorExit)
                st = "error" if aborted else "cancelled"
                for b in range(self.B):
                    if slot_req[b] >= 0:
                        if not aborted:
                            self.stats["cancelled_requests"] += 1
                            self._m_cancel.inc(stage="decoding", **mlbl)
                        evict(b, st)
                for r in list(q.ids()):
                    q.remove(r)
                    if not aborted:
                        self.stats["cancelled_requests"] += 1
                        self._m_cancel.inc(stage="queued", **mlbl)
                    finish_queued(r, st, {"stage": "queued"})
                for r, s in enumerate(status):
                    # popped for an admission round but not yet placed
                    # when the loop died
                    if s in ("queued", "running"):
                        status[r] = st
                        if not aborted:
                            self.stats["cancelled_requests"] += 1
                            self._m_cancel.inc(stage="queued", **mlbl)
                        self._m_done.inc(status=st, **mlbl)
                for r, res in enumerate(results):
                    if res is None:
                        results[r] = []
                for r, sp in enumerate(req_sp):
                    if not sp.ended:
                        sp.end(status=status[r])
                if not gen_sp.ended:
                    gen_sp.end(status=st)

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
        nexts = self._jit_call(
            ("prefill", ids.shape, rows.shape), self._raw_prefill,
            self._put(ids), self._put(pos), self._put(lens), self._put(rows))
        # the admission download: every position's greedy token (the
        # prefix cache stores them as cached continuations)
        nexts = nexts.cpu().numpy()
        firsts = {}
        for i, plan in enumerate(group):
            prompt = plan["prompt"]
            L = len(prompt)
            firsts[plan["r"]] = int(nexts[i, -1])
            if self.prefix_cache is not None and not plan.get("no_cache"):
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
        nexts = self._jit_call(
            ("suffix", ids.shape, past_rows.shape), self._raw_suffix_prefill,
            self._put(ids), self._put(pos), self._put(np.int64(covered)),
            self._put(np.int64(sl)), self._put(past_rows), self._put(row))
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
    def _tok_in(self, last_tok_host, override, inflight):
        """Each slot's input token: the in-flight step's device-resident
        token, or the host's where ``override`` is set (a newly admitted
        slot's first token, a chunk's first token)."""
        host_tok = self._put(last_tok_host)
        tok = host_tok if inflight is None else torch.where(
            self._put(override), host_tok, inflight["tok"])
        override[:] = False
        return tok

    def _meta(self, builder, active, post_lens):
        """Advance the ragged meta of the active slots to their post-step
        lengths and snapshot it onto the device (the host mutates it
        while the step is in flight); None without ``use_ragged``."""
        if builder is None:
            return None
        for b in active:
            builder.advance_slot(b, int(post_lens[b]))
        return self._put(builder.stacked())

    def _span(self, tables, ctx, q_lens, qb=None):
        """The step's span index, built from the host arrays (no device
        sync) and copied to the device; the steps pass ``qb``, the span
        width, so it is padded to B * qb entries over the trash page (a
        static shape)."""
        s = span_index(torch.from_numpy(tables), torch.from_numpy(ctx),
                       torch.from_numpy(q_lens), self.page, qb, self._trash)
        return SpanIndex(self._put(s.rows), self._put(s.kv_lens))

    def _dispatch_step(self, active, slot_req, tables, ctx, last_tok_host,
                       override, builder, inflight, samp=None):
        """Dispatch one decode step WITHOUT waiting for the previous one:
        continuing slots chain the device-resident token straight back
        in; newly admitted slots inject their host-known first token.
        With ``samp`` (the sampling operands on the device) the sampling
        step runs instead."""
        t0 = time.perf_counter()
        meta = self._meta(builder, active, ctx + 1)
        tok_in = self._tok_in(last_tok_host, override, inflight)
        if samp is None:
            nxt, done = self._jit_call(
                ("decode", tables.shape, self._meta_sig(meta)),
                self._raw_decode_step, self._put(tables), self._put(ctx),
                tok_in, meta)
        else:
            nxt, done = self._jit_call(
                ("decode_sample", tables.shape, self._meta_sig(meta)),
                self._raw_decode_sample_step, self._put(tables),
                self._put(ctx), tok_in, samp, meta)
        fetch = self._fetch_async(nxt, done)
        snap = [(b, slot_req[b]) for b in active]
        ctx[active] += 1
        self.stats["decode_steps"] += 1
        self._m_steps.inc(**self._mlbl)
        return {"tok": nxt, "fetch": fetch, "snap": snap, "t": t0}

    def _chunk_bucket(self, remaining, n_decode):
        """Page-aligned chunk bucket for one mixed step: about
        chunk_max / (1 + decoding slots), so an ingest never holds the
        decode slots for more than a bounded slice, as page * 2^k,
        shrunk to the smallest bucket covering what is left."""
        tgt = max(self.page, self._chunk_max // (1 + max(0, n_decode)))
        b = self.page
        while b * 2 <= tgt:
            b *= 2
        while b > self.page and b // 2 >= remaining:
            b //= 2
        return b

    def _dispatch_mixed_step(self, active, slot_req, slot_pending, tables,
                             ctx, last_tok_host, override, builder,
                             inflight, req_sp, paused=()):
        """Dispatch one MIXED prefill+decode step: every slot with a
        pending prompt tail ingests its next chunk while the decode
        slots take their normal single-token step, chained off the
        in-flight step like ``_dispatch_step`` (chunk tokens are
        host-known, so chunk steps pipeline too).

        ``paused`` slots (sampled decodes: this step's argmax would be
        the wrong token for them) run their committed token again at
        their position without advancing: the K/V written there is
        written again by their next sampling step, and their output is
        dropped like a mid-prompt chunk's. Each chunk is a
        ``prefill_chunk`` event of its request's span (``req_sp``)."""
        t0 = time.perf_counter()
        mlbl = self._mlbl
        chunk_slots = [b for b in active if slot_pending[b]]
        qb = self._chunk_bucket(max(len(slot_pending[b])
                                    for b in chunk_slots),
                                len(active) - len(chunk_slots))
        span_ids = np.full((self.B, qb), self.pad_token_id, np.int64)
        q_lens = np.ones((self.B,), np.int32)
        mid, final = set(paused), set()
        for b in chunk_slots:
            take = min(len(slot_pending[b]), qb)
            chunk = slot_pending[b][:take]
            span_ids[b, :take] = chunk
            q_lens[b] = take
            # the chunk's first token rides the host-override path a
            # newly admitted decode slot uses (column 0 comes from tok_in)
            last_tok_host[b] = chunk[0]
            override[b] = True
            del slot_pending[b][:take]
            (final if not slot_pending[b] else mid).add(b)
            self.stats["prefill_chunks"] += 1
            self._m_chunks.inc(**mlbl)
            self._m_chunk_tok.inc(take, **mlbl)
            # ctx holds what the slot ingested before this chunk
            req_sp[slot_req[b]].event("prefill_chunk", tokens=take,
                                      covered=int(ctx[b]) + take)
        adv = [b for b in active if b not in paused]
        meta = self._meta(builder, adv, ctx + q_lens)
        tok_in = self._tok_in(last_tok_host, override, inflight)
        nxt, done = self._jit_call(
            ("mixed", qb, tables.shape, self._meta_sig(meta)),
            self._raw_mixed_step, self._put(tables), self._put(ctx),
            self._put(span_ids), self._put(q_lens), tok_in,
            self._span(tables, ctx, q_lens, qb), meta)
        fetch = self._fetch_async(nxt, done)
        snap = [(b, slot_req[b]) for b in active]
        ctx[adv] += q_lens[adv]
        self.stats["decode_steps"] += 1
        self.stats["mixed_steps"] += 1
        self._m_steps.inc(**mlbl)
        self.sampling_stats["paused_slots"] += len(paused)
        return {"tok": nxt, "fetch": fetch, "snap": snap, "t": t0,
                "chunk_mid": mid, "chunk_final": final}

    def _dispatch_spec_step(self, active, slot_req, slot_hist, tables, ctx,
                            last_tok_host, override, builder, max_new,
                            slot_new, samp=None, s_temp=None):
        """Dispatch one SPECULATIVE step: each slot's prompt-lookup
        drafter proposes up to spec_draft_tokens continuations from the
        request's own history; the committed last token plus the drafts
        run as one span (``_raw_spec_step``; with ``samp``, the sampling
        operands, sampled slots verify by rejection sampling). ctx and
        the ragged meta advance over the whole span; the resolver
        rewinds them to the accepted prefix. With no drafts anywhere the
        step is a plain (or sampling) decode step. Nothing is in flight
        here (spec mode resolves first), so every input token comes from
        the host. ``s_temp``: the host's per-slot temperatures (for the
        sampled-draft count)."""
        t0 = time.perf_counter()
        qs = self._spec_k + 1
        span_ids = np.full((self.B, qs), self.pad_token_id, np.int64)
        q_lens = np.ones((self.B,), np.int32)
        drafts = {}
        for b in active:
            room = max_new[slot_req[b]] - len(slot_new[b]) - 1
            kb = min(self._spec_k, max(0, room))
            d = sampling.propose_ngram_drafts(slot_hist[b], kb,
                                              self._ngram_max) \
                if kb > 0 else []
            if d:
                span_ids[b, 1:1 + len(d)] = d
                q_lens[b] = 1 + len(d)
                drafts[b] = list(d)
        if not drafts:
            return self._dispatch_step(active, slot_req, tables, ctx,
                                       last_tok_host, override, builder,
                                       None, samp)
        meta = self._meta(builder, active, ctx + q_lens)
        tok_in = self._tok_in(last_tok_host, override, None)
        bonus, accepted = self._jit_call(
            ("spec", qs, tables.shape, self._meta_sig(meta)),
            self._raw_spec_step, self._put(tables), self._put(ctx),
            self._put(span_ids), self._put(q_lens), tok_in,
            self._span(tables, ctx, q_lens, qs), meta, samp)
        fetch = self._fetch_async(bonus, accepted)
        snap = [(b, slot_req[b]) for b in active]
        ctx0 = {b: int(ctx[b]) for b in active}
        ctx[active] += q_lens[active]       # optimistic; resolve rewinds
        proposed = sum(len(d) for d in drafts.values())
        self.stats["decode_steps"] += 1
        self.stats["spec_ticks"] += 1
        self.stats["spec_proposed"] += proposed
        self._m_steps.inc(**self._mlbl)
        self._m_spec_prop.inc(proposed, **self._mlbl)
        if s_temp is not None:
            self.sampling_stats["sampled_spec_proposed"] += sum(
                len(d) for b, d in drafts.items() if s_temp[b] > 0)
        return {"spec": True, "tok": bonus, "fetch": fetch, "snap": snap,
                "t": t0, "ctx0": ctx0, "drafts": drafts,
                "qlen": {b: int(q_lens[b]) for b in active}}

    def _resolve_spec_step(self, step, slot_req, slot_new, slot_hist,
                           last_tok_host, max_new, ctx, override, builder,
                           evict, first_cb, emit, req_sp):
        """Sync one speculative step and commit each slot's accepted
        drafts plus the bonus token: tokens append (eos and the budget
        truncate and evict as in plain decode), ctx and the ragged meta
        rewind to the kept prefix (the rejected positions' K/V was
        already restored on the device), and the drafting history
        extends; the tick's tokens stream as one event (``emit``) whose
        span holds them all. Slots in ``chunk_final`` draw their first
        (sampled) token in this step: ``first_cb`` records TTFT. A slot
        with drafts adds a ``spec`` event to its request span
        (``req_sp``), every committed token a ``token`` event."""
        self._await_step(step)
        bonus, acc = step["fetch"]()
        self._m_tok.observe(time.perf_counter() - step["t"], **self._mlbl)
        firsts = step.get("chunk_final", ())
        accepted_total = 0
        for b, r in step["snap"]:
            if slot_req[b] != r:
                continue                  # evicted (and maybe re-admitted)
            drafts = step["drafts"].get(b, [])
            a = min(int(acc[b]), len(drafts))
            new_ctx = step["ctx0"][b] + a + 1
            ctx[b] = new_ctx
            if builder is not None and a + 1 < step["qlen"][b]:
                builder.rollback_slot(b, new_ctx)
            if drafts:
                accepted_total += a
                req_sp[r].event("spec", proposed=len(drafts), accepted=a)
            if b in firsts:
                first_cb(b, r)
            span_toks = []
            ended = False
            for t in drafts[:a] + [int(bonus[b])]:
                if self.eos_token_id is not None and t == self.eos_token_id:
                    ended = True          # eos is stripped
                    break
                slot_new[b].append(t)
                span_toks.append(t)
                req_sp[r].event("token", i=len(slot_new[b]))
                if len(slot_new[b]) >= max_new[r]:
                    break
            if span_toks:
                slot_hist[b].extend(span_toks)
                last_tok_host[b] = span_toks[-1]
                override[b] = True
                emit(r, "token", token=span_toks[-1],
                     index=len(slot_new[b]), span=tuple(span_toks))
            if ended or len(slot_new[b]) >= max_new[r]:
                evict(b)
        self.stats["spec_accepted"] += accepted_total
        if accepted_total:
            self._m_spec_acc.inc(accepted_total, **self._mlbl)
        if self.stats["spec_proposed"]:
            self._m_spec_rate.set(
                self.stats["spec_accepted"] / self.stats["spec_proposed"],
                **self._mlbl)

    def _resolve_step(self, step, slot_req, slot_new, last_tok_host, max_new,
                      evict, first_cb, hist, sampled_first, emit, req_sp):
        """Sync a previously dispatched step (its successor may already
        be in flight) and apply its tokens: append, detect eos / budget,
        evict. Slots recycled since the dispatch are skipped. In a mixed
        step, mid-prompt chunk slots and paused slots produce no token,
        and a slot whose FINAL chunk ran takes the step's argmax as its
        first token (``first_cb`` records TTFT); a sampled request's
        final chunk instead goes to ``sampled_first`` (first-token
        replay). A decode step's ``chunk_final`` slots draw their first
        sampled token. Committed tokens extend ``hist``, add a ``token``
        event to their request span (``req_sp``; the reference's, an eos
        computed on the device included) and stream through ``emit``."""
        self._await_step(step)
        nxt, done = step["fetch"]()
        self._m_tok.observe(time.perf_counter() - step["t"], **self._mlbl)
        if "chunk_mid" in step:
            self._m_mixed.observe(time.perf_counter() - step["t"],
                                  **self._mlbl)
        chunk_mid = step.get("chunk_mid", ())
        chunk_final = step.get("chunk_final", ())
        chunk_final_sampled = step.get("chunk_final_sampled", ())
        for b, r in step["snap"]:
            if slot_req[b] != r:
                continue                  # evicted (and maybe re-admitted)
            if b in chunk_mid:
                continue                  # mid-prompt chunk: no token yet
            if b in chunk_final_sampled:
                sampled_first(b, r)       # argmax dropped: replay next
                continue
            first = b in chunk_final
            t = int(nxt[b])
            if first:
                first_cb(b, r, t)
            elif len(slot_new[b]) >= max_new[r]:
                continue                  # token of a post-budget step
            if bool(done[b]):             # eos computed on the device
                if not first:
                    req_sp[r].event("token", i=len(slot_new[b]) + 1)
                evict(b)                  # eos is stripped
                continue
            slot_new[b].append(t)
            hist[b].append(t)
            last_tok_host[b] = t
            req_sp[r].event("token", i=len(slot_new[b]))
            emit(r, "token", token=t, index=len(slot_new[b]))
            if len(slot_new[b]) >= max_new[r]:
                evict(b)


class _Fetch:
    """The host copy of a dispatched step's small outputs: ``ready()``
    asks without blocking; calling it waits (``ev.synchronize()``) and
    gives numpy. On the CPU the outputs are the step's own tensors and a
    step is ready when it returns."""

    __slots__ = ("_outs", "_ev")

    def __init__(self, outs, ev):
        self._outs, self._ev = outs, ev

    def ready(self):
        return self._ev is None or self._ev.query()

    def __call__(self):
        if self._ev is not None:
            self._ev.synchronize()
        return tuple(o.numpy() for o in self._outs)
