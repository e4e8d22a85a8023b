"""Replica pool + prefix-affinity router (counterpart of
``paddle_tpu/serving/router.py``).

One ContinuousBatchingPredictor is one model replica. This module
fronts N of them, one worker thread per replica, all on one device
(tensor-parallel replicas and device groups are not ported), behind a
router that:

- **routes by prefix-cache affinity** — the prompt's page-aligned
  prefix hashes with :func:`generation.kv_cache.prefix_page_keys`,
  EXACTLY the keys the replica's PrefixCache trie uses, and the router
  prefers the replica whose affinity index already holds the longest
  leading run of those keys (its pool probably still caches the
  prefix's K/V → admission skips prefill work). Ties and cold prompts
  fall back to least-loaded (queued+running work estimate:
  Σ prompt_len + max_new). ``policy="random"`` is the control arm the
  bench compares against.
- **streams tokens** — every request gets a :class:`RequestHandle`
  whose `stream()` yields the replica's StreamEvents as decode ticks
  complete; `result()` blocks for the terminal status; `cancel()`
  propagates to the replica's serve loop (pages freed).
- **keeps replicas honest** — a replica whose serve loop dies (an
  exception) or wedges (PR-4 decode watchdog → requests end with
  status "watchdog") counts a failure; its unfinished requests are
  re-admitted to another replica EXACTLY ONCE
  (serving.router.readmissions) and `eject_after` consecutive failures
  drain + eject the replica (serving.router.ejections) — a decode
  wedge ejects IMMEDIATELY, because the wedged predictor's lost KV
  pages make it unsafe to restart. An ejected replica's predictor
  should be rebuilt before `revive()`.
- **feeds the fair scheduler** — requests land in the replica's serve
  loop queue (`serve_stream` dynamic intake), so the per-tier weighted
  deficit-round-robin (scheduler.py) applies at decode-tick
  granularity, not generate()-call granularity.
- **splits prefill from decode** — with ``roles=["prefill", "decode"]``
  a request prefills on a prefill replica, which exports its KV page
  span at the first token; the span is imported by a decode replica,
  which resumes with no prefill forward (serving.handoff.*). An export
  miss, a corrupt span, a full pool or an import error falls back to a
  plain prefill on the decode side, counted by reason.

The replicas' serve loops launch from their own threads on the
device's default stream; a CUDA-graph capture on one of them (a warm
start, a bucket miss) is kept apart from the others' device work by
``framework.graphs.device_gate``.

The metric and span names are the reference's (serving.router.*,
serving.handoff.*, serve.request.stage.seconds).
"""
from __future__ import annotations

import collections
import queue as _pyqueue
import random
import threading
import time
from typing import Dict, List, Optional

from ..framework import faults as _faults
from ..generation.kv_cache import _page_bytes, prefix_page_keys
from ..observability import critpath as _critpath
from ..observability import metrics as _obsm
from ..observability import tracing as _obstr
from .scheduler import stage_cost
from .streaming import ServeRequest, StreamEvent

__all__ = ["Router", "Replica", "RequestHandle"]

# terminal statuses that mean THIS REPLICA failed the request (retry
# elsewhere), as opposed to the request itself being done/overdue
_RETRYABLE = ("watchdog", "incomplete")


class RequestHandle:
    """One routed request: a thread-safe event stream + terminal state.

    `stream()` yields StreamEvents (kind "token" then one "end");
    `result()` blocks until terminal and returns the tokens; `cancel()`
    requests eviction (effective while inbox-queued, or from the first
    streamed token once decoding — the replica cancels the slot at its
    next loop tick)."""

    def __init__(self, rid: str, prompt, max_new_tokens: int,
                 tier: Optional[str], deadline_s: Optional[float]):
        self.id = rid
        self.prompt = list(prompt)
        self.max_new_tokens = int(max_new_tokens)
        self.tier = tier
        self.deadline_s = deadline_s
        self.cost = len(self.prompt) + self.max_new_tokens
        # disaggregated two-stage dispatch state: `stage` is None on a
        # unified pool, else "prefill" (filling pages, handing off at
        # first token) then "decode" (resuming from the exported span);
        # `handoff_span` carries the KVPageSpan between the stages and
        # stays attached so a decode replica dying mid-request can
        # replay the import elsewhere.
        self.stage: Optional[str] = None
        self.handoff_span = None
        self._handoff_t0: Optional[float] = None
        self.replica: Optional[str] = None
        self.status = "queued"
        self.tokens: List[int] = []
        self.attempts = 0
        self.cancelled = False
        self.done = threading.Event()
        self.submit_ts = time.time()
        self.first_token_ts: Optional[float] = None
        self._q: _pyqueue.SimpleQueue = _pyqueue.SimpleQueue()
        self._pushed_max = 0     # dedup guard across re-admissions
        self.span = _obstr.start_span(
            "router.request", parent=None, request_id=rid,
            prompt_len=len(self.prompt),
            **({"tier": tier} if tier else {}))
        # the request's TraceContext, minted once at admission and
        # carried on EVERY boundary (ServeRequest intake, the KV
        # page-span handoff record, re-admissions) so spans on other
        # threads/replicas join this trace instead of minting fresh
        # ones. None when telemetry is disabled.
        self.trace = self.span.context(
            request_id=rid, **({"tier": tier} if tier else {}))

    # ------------------------------------------------- replica-side API --
    def _push_token(self, ev: StreamEvent):
        """Exactly-once token delivery across re-admissions. One event
        covers a whole decode TICK: `ev.span` carries every token the
        tick committed (speculative ticks commit several; `ev.index` is
        the LAST one's ordinal). A re-admitted request re-decodes its
        prefix on the new replica, and a re-decoded tick may OVERLAP
        the already-delivered ordinals mid-span — only the fresh tail
        is appended/forwarded, trimmed to a consistent event."""
        toks = tuple(ev.span) or \
            ((ev.token,) if ev.token is not None else ())
        base = ev.index - len(toks)      # ordinal of toks[0] is base+1
        fresh = [(base + 1 + i, t) for i, t in enumerate(toks)
                 if base + 1 + i > self._pushed_max]
        if not fresh:
            return          # re-decoded prefix after a re-admission
        self._pushed_max = fresh[-1][0]
        for _, t in fresh:
            self.tokens.append(t)
        if self.first_token_ts is None:
            self.first_token_ts = ev.ts
            self.span.event("first_token")
        if len(fresh) < len(toks):       # partial overlap: trim
            ev = ev._replace(span=tuple(t for _, t in fresh),
                             token=fresh[-1][1], index=fresh[-1][0])
        self._q.put(ev)

    def _finish(self, status: str, ts: Optional[float] = None):
        self.status = status
        self.span.event("finish", status=status, tokens=len(self.tokens))
        self.span.end(status=status)
        self._q.put(StreamEvent(0, "end", None, 0, ts or time.time(),
                                status, None))
        self.done.set()

    # ------------------------------------------------- consumer-side API --
    def stream(self, timeout: Optional[float] = None):
        """Yield StreamEvents until (and including) the terminal "end".
        `timeout` bounds the wait for each event; like `result`, an
        expired wait raises TimeoutError."""
        while True:
            try:
                ev = self._q.get(timeout=timeout)
            except _pyqueue.Empty:
                raise TimeoutError(
                    f"request {self.id}: no stream event within "
                    f"{timeout}s") from None
            yield ev
            if ev.kind == "end":
                return

    def result(self, timeout: Optional[float] = None) -> List[int]:
        if not self.done.wait(timeout=timeout):
            raise TimeoutError(f"request {self.id} not done")
        return self.tokens

    def cancel(self):
        self.cancelled = True


class Replica:
    """One predictor + its worker thread running `serve_stream`.

    `role` is the replica's disaggregated serving role — "unified"
    (the default: prefill+decode, every historical path unchanged),
    "prefill" (serves each request's ingest + first token, then hands
    the KV page span to the decode fleet), or "decode" (imports the
    span and runs the remaining token budget). Defaults to the
    predictor's own role so a role-configured predictor needs nothing
    extra here."""

    def __init__(self, router: "Router", name: str, predictor,
                 role: Optional[str] = None):
        self.router = router
        self.name = name
        self.predictor = predictor
        self.role = (role or getattr(predictor, "role", None)
                     or "unified")
        self.lock = threading.Condition()
        self.inbox: collections.deque = collections.deque()
        self.pending: Dict[str, RequestHandle] = {}  # dispatched, not ended
        self.closed = False
        self.ejected = False
        self.consecutive_failures = 0
        self.last_failure: Optional[str] = None
        self.load = 0.0           # Σ cost of inbox + pending
        self.served = 0
        self.affinity: Dict[tuple, int] = {}   # page key -> LRU clock
        self._clock = 0
        self._epoch = 0     # bumped by revive(); fences the old worker
        self._stream = None
        self.thread = threading.Thread(
            target=self._run, name=f"replica-{name}", daemon=True)
        self.thread.start()

    # ---------------------------------------------------------- routing --
    def affinity_score(self, keys) -> int:
        """Length of the leading run of `keys` present in the affinity
        index — the number of prompt pages this replica's cache
        plausibly still holds. Locked: scores and adds run on client
        threads AND on the worker (readmission re-dispatch)."""
        with self.lock:
            n = 0
            for k in keys:
                if k in self.affinity:
                    n += 1
                else:
                    break
            return n

    def affinity_add(self, keys):
        with self.lock:
            for k in keys:
                self._clock += 1
                # pop+reinsert keeps dict insertion order == recency
                # order, so eviction is pop-from-front — O(1) per key
                # on this per-submit path, not a full sort under the
                # lock every call once the index is at capacity
                self.affinity.pop(k, None)
                self.affinity[k] = self._clock
            cap = self.router.affinity_capacity
            while len(self.affinity) > cap:
                del self.affinity[next(iter(self.affinity))]

    # ------------------------------------------------------------ queue --
    def submit(self, h: RequestHandle) -> bool:
        """Enqueue under the lock; False if the intake closed (drain/
        eject raced the router's health check) — the caller must route
        elsewhere, an entry appended after drain() would never be read."""
        with self.lock:
            if self.closed:
                return False
            self.inbox.append(h)
            self.load += h.cost
            self.lock.notify()
        return True

    def queue_depth(self) -> int:
        return len(self.inbox) + len(self.pending)

    def _intake(self):
        """Dynamic-intake hook polled by the predictor's serve loop
        (runs ON the worker thread, inside serve_stream)."""
        with self.lock:
            if not self.inbox and not self.closed and not self.pending:
                # truly idle: park on the condvar. With work in flight
                # the loop must keep decoding — a wait here would stall
                # every decode tick by the timeout
                self.lock.wait(timeout=0.02)
            if self.closed:
                return None
            batch = []
            while self.inbox:
                batch.append(self.inbox.popleft())
        out = []
        for h in batch:
            if h.cancelled:
                with self.lock:
                    self.load -= h.cost
                self.router._request_done(h, "cancelled", None)
                continue
            self.pending[h.id] = h
            if h.stage == "decode" and h.handoff_span is not None:
                # decode stage: materialize the handed-off span into
                # this replica's pool/trie BEFORE the serve loop sees
                # the request — admission then takes the full-prefix-
                # hit path (no prefill forward). Import failures fall
                # back to a plain prefill (counted, never fatal).
                self._import_handoff(h)
            mn = h.max_new_tokens
            if self.role == "prefill" and h.stage == "prefill":
                # prefill stage serves the ingest + FIRST token only
                # (TTFT is measured here); the rest of the budget runs
                # on the decode fleet after the span handoff
                mn = 1
            out.append(ServeRequest(h.prompt, mn, h.tier,
                                    h.deadline_s, h, trace=h.trace))
        return out

    def _import_handoff(self, h: RequestHandle):
        """Import a handoff span (worker thread, between serve-loop
        ticks). serving.handoff.seconds measures prefill-side export →
        decode-side pages resident; failures record a reason and leave
        the request to prefill from scratch."""
        r = self.router
        # marks decode-side arrival: the gap from the prefill side's
        # "handoff" event to here is the transfer leg of the critical
        # path (critpath stage "handoff_transfer"); from here to
        # "handoff_imported" is the import leg
        h.span.event("handoff_import_start", replica=self.name)
        fa = _faults.check("handoff_corrupt")
        if fa is not None:
            # bitrot-in-transit: flip one payload byte BEFORE import.
            # The span's checksum fence must reject it (reason
            # "corrupt" below) and the request must re-prefill from
            # scratch — never decode from corrupt pages. The flip
            # mutates the payload only, so the recorded checksum still
            # describes the original bytes.
            span = h.handoff_span
            pages = (getattr(span, "k_pages", None) or []) \
                + (getattr(span, "v_pages", None) or [])
            for arr in pages:
                # a host page: a CPU tensor or a numpy array; flip a
                # byte of its memory in place
                flat = _page_bytes(arr).reshape(-1)
                if flat.size:
                    idx = int(fa.params.get("byte", 0)) % flat.size
                    flat[idx] ^= 0xFF
                    break
        try:
            stats = self.predictor.import_page_span(h.handoff_span)
        except MemoryError:
            r._m_handoff_fb.inc(reason="alloc", replica=self.name)
            h.span.event("handoff_import_failed", reason="alloc")
            return
        except Exception as e:
            reason = "corrupt" if "checksum" in str(e) else "import_error"
            r._m_handoff_fb.inc(reason=reason, replica=self.name)
            h.span.event("handoff_import_failed", reason=reason,
                         error=f"{type(e).__name__}: {e}")
            return
        if h._handoff_t0 is not None:
            r._m_handoff_s.observe(time.perf_counter() - h._handoff_t0,
                                   replica=self.name)
            h._handoff_t0 = None     # a replayed import times nothing
        r._m_handoff_bytes.inc(int(stats["bytes"]), replica=self.name)
        r._m_handoff_pages.inc(int(stats["imported"]), kind="imported",
                               replica=self.name)
        if stats["reused"]:
            r._m_handoff_pages.inc(int(stats["reused"]), kind="reused",
                                   replica=self.name)
        if stats.get("resharded"):
            r._m_handoff_fb.inc(reason="reshard", replica=self.name)
        h.span.event("handoff_imported", imported=stats["imported"],
                     reused=stats["reused"], bytes=stats["bytes"])

    # ----------------------------------------------------------- worker --
    def _run(self):
        epoch = self._epoch
        while True:
            st = self.predictor.serve_stream(
                self._intake, tier_weights=self.router.tier_weights)
            self._stream = st
            failed = None
            try:
                for ev in st:
                    h = ev.meta
                    if h is None:
                        continue
                    if ev.kind == "token":
                        if h.cancelled:
                            st.cancel(ev.request)
                        else:
                            h._push_token(ev)
                    else:
                        self._on_end(h, ev.status, ev.ts)
                # serve loop exhausted: either intake closed (normal
                # shutdown/eject) or the loop broke on a decode wedge
                if self.closed:
                    return
                # a wedged predictor is poisoned (the wedged step's KV
                # pages are never reclaimed — see the serve loop's
                # watchdog path): restarting serve_stream on it can
                # strand requests forever, so eject immediately and
                # require revive(predictor=...) with a rebuilt one
                self._on_failure("serve loop ended (decode wedge)",
                                 fatal=True)
                return
            except Exception as e:   # replica loop died
                failed = f"{type(e).__name__}: {e}"
            self._on_failure(failed)
            # _epoch check: revive() may have reset closed/ejected
            # while this thread was still readmitting inside
            # _on_failure — looping again here would put TWO serve
            # loops on one predictor. The revived epoch's own worker
            # carries on; this one exits.
            if self.closed or self.ejected or self._epoch != epoch:
                return

    def _on_end(self, h: RequestHandle, status: str, ts: float):
        self.pending.pop(h.id, None)
        with self.lock:
            self.load -= h.cost
        if status in _RETRYABLE:
            # the replica failed THIS request (wedge / dropped): route
            # it elsewhere. The failure itself is counted once per
            # serve-loop death in _on_failure, not per request.
            self.router._readmit(h, self, status)
            return
        self.consecutive_failures = 0
        self.served += 1
        if (self.role == "prefill" and h.stage == "prefill"
                and status == "ok" and not h.cancelled and h.tokens
                and len(h.tokens) < h.max_new_tokens):
            # prefill stage done (first token streamed, budget
            # remains): hand the KV span to the decode fleet instead
            # of finishing. An eos-first or budget-of-1 request has
            # nothing left to decode and completes normally above.
            self.router._handoff(h, self)
            return
        self.router._request_done(h, status, ts)

    def _on_failure(self, reason: str, fatal: bool = False):
        """The serve loop died: every dispatched-but-unfinished request
        is re-admitted elsewhere (exactly once each), and the failure
        counts toward ejection — immediately, when `fatal` (the
        predictor cannot safely serve again without a rebuild)."""
        self.consecutive_failures += 1
        if fatal:
            self.consecutive_failures = max(self.consecutive_failures,
                                            self.router.eject_after)
        self.last_failure = reason
        dangling = list(self.pending.values())
        self.pending.clear()
        with self.lock:
            for h in dangling:
                self.load -= h.cost
        self.router._m_failures.inc(replica=self.name)
        self.router._maybe_eject(self, reason=reason)
        for h in dangling:
            self.router._readmit(h, self, "replica_failure")

    def drain(self) -> List[RequestHandle]:
        """Close the intake and return the not-yet-dispatched inbox."""
        with self.lock:
            self.closed = True
            leftovers = list(self.inbox)
            self.inbox.clear()
            for h in leftovers:
                self.load -= h.cost
            self.lock.notify_all()
        return leftovers

    def revive(self, predictor=None):
        """Bring an ejected replica back (optionally with a rebuilt
        predictor — after a decode wedge the old one is poisoned)."""
        if predictor is not None:
            self.predictor = predictor
        self._epoch += 1     # fence: a still-unwinding old worker must
        self.consecutive_failures = 0   # not re-enter its serve loop
        self.closed = False
        self.ejected = False
        self.thread = threading.Thread(
            target=self._run, name=f"replica-{self.name}", daemon=True)
        self.thread.start()


class Router:
    """Prefix-affinity router over a pool of predictor replicas.

    `predictors`: a list of ready ContinuousBatchingPredictor (one per
    replica; give each a `name=` for labeled telemetry) OR a list of
    models — then one predictor per model is built here with
    `predictor_kw` (max_batch_size, page_size, max_seq_len, ...), named
    ``replica0..N``.

    `policy`: "affinity" (default) | "least_loaded" | "random" (the
    bench's control arm). `tier_weights` switches every replica's
    admission queue to weighted fair queueing (scheduler.py).
    """

    def __init__(self, predictors, tier_weights=None, policy="affinity",
                 eject_after=2, max_readmissions=1, seed=0,
                 affinity_capacity=4096, roles=None, **predictor_kw):
        if policy not in ("affinity", "least_loaded", "random"):
            raise ValueError(f"unknown routing policy {policy!r}")
        if roles is not None and len(roles) != len(predictors):
            raise ValueError(
                f"roles ({len(roles)}) must parallel predictors "
                f"({len(predictors)})")
        self.policy = policy
        self.tier_weights = dict(tier_weights) if tier_weights else None
        self.eject_after = int(eject_after)
        self.max_readmissions = int(max_readmissions)
        self.affinity_capacity = int(affinity_capacity)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._req_seq = 0
        self.replicas: List[Replica] = []
        # every replica serves on one device (tp_degree 1: a predictor
        # refuses another degree, so there are no device groups to
        # partition); `predictor_kw` (device= included) goes to every
        # predictor built from a model
        for i, p in enumerate(predictors):
            role = roles[i] if roles is not None else None
            if not hasattr(p, "serve_stream"):   # a model: wrap it
                from ..inference import ContinuousBatchingPredictor
                kw = dict(predictor_kw)
                if role is not None:
                    # per-role specialization: the role's RuntimeConfig
                    # overlay applies to an explicit config (chunk
                    # thresholds for prefill, spec/sampling programs
                    # for decode — framework/runtime_config.py)
                    kw["role"] = role
                    if kw.get("runtime_config") is not None:
                        kw["runtime_config"] = \
                            kw["runtime_config"].for_role(role)
                p = ContinuousBatchingPredictor(
                    p, name=f"replica{i}", **kw)
            name = p.name or f"replica{i}"
            self.replicas.append(Replica(self, name, p, role=role))
        if not self.replicas:
            raise ValueError("Router needs at least one replica")
        self.page = self.replicas[0].predictor.page
        # telemetry (the reference's docs/OBSERVABILITY.md catalog)
        self._m_routed = _obsm.counter("serving.router.routed")
        self._m_readmit = _obsm.counter("serving.router.readmissions")
        self._m_eject = _obsm.counter("serving.router.ejections")
        self._m_failures = _obsm.counter("serving.router.replica_failures")
        self._m_depth = _obsm.gauge("serving.router.queue_depth")
        self._m_load = _obsm.gauge("serving.router.replica_load")
        self._m_ttft = _obsm.histogram("serving.router.ttft_seconds",
                                       unit="s")
        self._m_e2e = _obsm.histogram("serving.router.e2e_seconds",
                                      unit="s")
        # per-stage critical-path decomposition (critpath.py): one
        # observation per stage per completed request, telescoping so
        # a request's stage values sum to its e2e latency
        self._m_stage = _obsm.histogram("serve.request.stage.seconds",
                                        unit="s")
        self._m_done = _obsm.counter("serving.router.completed")
        self._m_shed = _obsm.counter("serving.router.shed")
        self._m_pool = _obsm.counter("serving.router.pool_resizes")
        # disaggregated handoff accounting:
        # requests handed prefill→decode, end-to-end handoff latency
        # (export → pages resident on the decode side), transferred
        # bytes, imported/reused page counts, and fallbacks by reason
        # (export_miss / corrupt / alloc / reshard / import_error)
        self._m_handoff = _obsm.counter("serving.handoff.requests")
        self._m_handoff_s = _obsm.histogram("serving.handoff.seconds",
                                            unit="s")
        self._m_handoff_bytes = _obsm.counter("serving.handoff.bytes")
        self._m_handoff_pages = _obsm.counter("serving.handoff.pages")
        self._m_handoff_fb = _obsm.counter("serving.handoff.fallbacks")
        # tiers currently refused at the admission edge (the control
        # loop's load-shed lever, serving/controller.py). Read on every
        # submit; mutated only via set_shed_tiers.
        self.shed_tiers: frozenset = frozenset()

    # ---------------------------------------------------------- routing --
    def healthy(self) -> List[Replica]:
        return [r for r in self.replicas if not r.ejected and not r.closed]

    @property
    def disaggregated(self) -> bool:
        """True when the pool actually runs two-stage dispatch: at
        least one prefill AND one decode replica. A pool of unified
        replicas (the default) never stages."""
        roles = {r.role for r in self.replicas}
        return "prefill" in roles and "decode" in roles

    def _target_role(self, h: RequestHandle) -> Optional[str]:
        if not self.disaggregated:
            return None
        return "decode" if h.stage == "decode" else "prefill"

    def _route(self, h: RequestHandle, exclude=()):
        cands = [r for r in self.healthy() if r not in exclude]
        role = self._target_role(h)
        if role is not None:
            # role-scoped dispatch: prefer the stage's own fleet
            # (unified replicas can serve either stage); when the
            # whole target fleet is down, ANY healthy replica beats
            # failing the request — the off-role fallback serves it
            # end-to-end (the reference's failure semantics)
            scoped = [r for r in cands if r.role in (role, "unified")]
            cands = scoped or cands
        if not cands:
            return None, "none"
        if self.policy == "random":
            return self._rng.choice(cands), "random"
        reason = "least_loaded"
        best = None
        if self.policy == "affinity":
            keys = prefix_page_keys(h.prompt, self.page)
            if keys:
                scored = [(r.affinity_score(keys), r) for r in cands]
                top = max(s for s, _ in scored)
                if top > 0:
                    tied = [r for s, r in scored if s == top]
                    best = min(tied, key=lambda r: r.load)
                    reason = "affinity"
        if best is None:
            best = min(cands, key=lambda r: r.load)
        return best, reason

    def submit(self, prompt, max_new_tokens=32, tier=None,
               deadline_s=None) -> RequestHandle:
        """Route one request; returns its RequestHandle immediately."""
        with self._lock:
            self._req_seq += 1
            rid = f"rr{self._req_seq}"
        h = RequestHandle(rid, prompt, max_new_tokens, tier, deadline_s)
        if tier is not None and tier in self.shed_tiers:
            # admission-edge shed: the cheapest place to refuse work —
            # nothing was queued, no KV pages were touched, and the
            # client gets a terminal status it can retry on
            self._m_shed.inc(tier=tier)
            self._m_done.inc(status="shed", tier=tier)
            h._finish("shed")
            return h
        self._dispatch(h)
        return h

    def _dispatch(self, h: RequestHandle, exclude=None,
                  reason_label=None):
        tried = {exclude} if exclude is not None else set()
        while True:
            rep, reason = self._route(h, exclude=tried)
            if rep is None:
                h._finish("error_no_replica")
                self._m_done.inc(status="error_no_replica",
                                 **({"tier": h.tier} if h.tier else {}))
                return
            if self.disaggregated:
                # two-stage dispatch: a fresh request landing on the
                # prefill fleet enters the prefill stage (handoff at
                # first token); a decode-stage request keeps its stage
                # wherever it lands. Off-role fallback (unified/prefill
                # absorbing a stage when a fleet is down) clears the
                # stage so the request serves end-to-end.
                if h.stage != "decode":
                    h.stage = "prefill" if rep.role == "prefill" else None
                h.cost = stage_cost(len(h.prompt), h.max_new_tokens,
                                    h.stage)
            # assign BEFORE submit: the worker thread may pick up,
            # serve, and finish the request before this thread runs
            # again — a client reading h.replica after result() must
            # never see the previous dispatch's name
            h.replica = rep.name
            if rep.submit(h):
                break
            # the replica closed between healthy() and submit (a drain/
            # eject raced us): try the rest of the pool
            tried.add(rep)
        if self.policy == "affinity":
            # future same-prefix requests chase these pages here
            rep.affinity_add(prefix_page_keys(h.prompt, self.page))
        h.span.set_label(replica=rep.name)
        h.span.event("routed", replica=rep.name,
                     reason=reason_label or reason)
        self._m_routed.inc(replica=rep.name,
                           reason=reason_label or reason,
                           **({"tier": h.tier} if h.tier else {}))
        self._m_depth.set(rep.queue_depth(), replica=rep.name)
        self._m_load.set(rep.load, replica=rep.name)

    # -------------------------------------------------- replica feedback --
    def _request_done(self, h: RequestHandle, status: str, ts: float):
        tl = {"tier": h.tier} if h.tier else {}
        # tail exemplars: the latency histograms keep the trace ids of
        # their largest observations, so a p99 on the dashboard links
        # straight to a renderable trace (tools/trace_report.py)
        ex = h.span.trace_id
        if h.first_token_ts is not None:
            self._m_ttft.observe(h.first_token_ts - h.submit_ts,
                                 exemplar=ex, **tl)
        self._m_e2e.observe((ts or time.time()) - h.submit_ts,
                            exemplar=ex, **tl)
        self._m_done.inc(status=status, **tl)
        h._finish(status, ts)
        self._observe_stages(h)

    def _observe_stages(self, h: RequestHandle):
        """Export the finished request's critical-path decomposition as
        serve.request.stage.seconds{stage=...} observations (with the
        trace id as exemplar). Telemetry must never break serving —
        any failure here is swallowed."""
        if not h.span.recording:
            return
        try:
            spans = [s for s in _obstr.flight_recorder().spans()
                     if s.get("trace") == h.span.trace_id]
            d = _critpath.stage_decomposition(
                spans, trace_id=h.span.trace_id)
            tl = {"tier": h.tier} if h.tier else {}
            for stage, secs in d["stages"]:
                self._m_stage.observe(secs, exemplar=h.span.trace_id,
                                      stage=stage, **tl)
        except Exception:
            pass

    def _handoff(self, h: RequestHandle, rep: Replica):
        """Prefill stage finished: export the request's KV page span
        from the prefill replica and re-dispatch to the decode fleet.
        An export miss (pages already evicted, or the first token never
        recorded) dispatches WITHOUT a span — the decode side prefills
        from scratch, correct but unaccelerated — and is counted under
        serving.handoff.fallbacks{reason=export_miss}."""
        h._handoff_t0 = time.perf_counter()
        span = None
        try:
            span = rep.predictor.export_page_span(h.prompt)
        except Exception as e:
            h.span.event("handoff_export_failed",
                         error=f"{type(e).__name__}: {e}")
        if span is not None and h.trace is not None:
            # the handoff record carries the trace across the
            # prefill->decode process boundary (plain dict: the record
            # may be serialized); checksum excludes it by design
            span.trace = h.trace.to_dict()
        if span is None:
            self._m_handoff_fb.inc(reason="export_miss",
                                   replica=rep.name)
        h.handoff_span = span
        h.stage = "decode"
        self._m_handoff.inc(replica=rep.name,
                            **({"tier": h.tier} if h.tier else {}))
        h.span.event("handoff", from_replica=rep.name,
                     bytes=(span.nbytes if span is not None else 0),
                     pages=(span.n_pages if span is not None else 0))
        self._dispatch(h, reason_label="handoff")

    def _readmit(self, h: RequestHandle, failed: Replica, why: str):
        """Re-admit a request its replica failed — exactly once. A
        second failure fails the request for real (the client retries
        above us; endless internal bouncing would hide a sick pool).

        A request that dies AFTER handoff keeps ``stage == "decode"``
        and its exported span, so it re-dispatches to the decode role
        (never back to prefill) and replays the span import on the new
        replica — already-delivered tokens dedup via the handle's
        ordinal guard."""
        if h.attempts >= self.max_readmissions:
            self._m_done.inc(status=why,
                             **({"tier": h.tier} if h.tier else {}))
            h._finish(why)
            return
        h.attempts += 1
        self._m_readmit.inc(replica=failed.name)
        h.span.event("readmitted", attempt=h.attempts,
                     from_replica=failed.name, why=why)
        self._dispatch(h, exclude=failed, reason_label="readmit")

    def _maybe_eject(self, rep: Replica, reason: str = ""):
        if rep.ejected or rep.consecutive_failures < self.eject_after:
            return
        rep.ejected = True
        self._m_eject.inc(replica=rep.name)
        leftovers = rep.drain()
        for h in leftovers:
            self._readmit(h, rep, "replica_ejected")

    # ------------------------------------------------------ pool control --
    def add_replica(self, predictor, name: Optional[str] = None,
                    role: Optional[str] = None) -> Replica:
        """Scale out: add one ready predictor as a live replica. The
        new worker starts serving immediately; routing sees it on the
        next healthy() pass. `role` scopes it to one disaggregated
        fleet (defaults to the predictor's own role)."""
        with self._lock:
            nm = name or predictor.name or f"replica{len(self.replicas)}"
            rep = Replica(self, nm, predictor, role=role)
            self.replicas.append(rep)
        self._m_pool.inc(direction="up",
                         **({"role": rep.role}
                            if rep.role != "unified" else {}))
        return rep

    def drain_replica(self, name: Optional[str] = None,
                      role: Optional[str] = None) -> Optional[Replica]:
        """Scale in: close one replica's intake (the least-loaded
        healthy one, or `name`, optionally scoped to one `role`),
        re-route its not-yet-dispatched inbox, and return the parked
        Replica — `revive()` brings it back with its predictor (and
        compiled programs) warm. Refuses to drain the last healthy
        replica — and, in a disaggregated pool, the last healthy
        replica of the victim's role (a fleet must never scale to
        zero while the other stage still feeds it)."""
        healthy = self.healthy()
        if role is not None:
            healthy = [r for r in healthy if r.role == role]
        if len(healthy) <= 1:
            return None
        if name is not None:
            cands = [r for r in healthy if r.name == name]
            if not cands:
                return None
            rep = cands[0]
        else:
            rep = min(healthy, key=lambda r: r.load)
        if self.disaggregated and sum(
                1 for r in self.healthy() if r.role == rep.role) <= 1:
            return None
        leftovers = rep.drain()
        self._m_pool.inc(direction="down")
        for h in leftovers:
            # voluntary rebalance, not a failure: route elsewhere
            # without burning the request's readmission budget
            self._dispatch(h, exclude=rep, reason_label="rebalance")
        return rep

    def set_tier_weight(self, tier: str, weight: float):
        """Shift one tier's fair-queueing share across the pool: future
        serve loops pick it up from tier_weights, and every running
        loop's live scheduler is updated in place (quantum grants use
        the new weight from the next round)."""
        w = max(float(weight), 1e-9)
        if self.tier_weights is None:
            self.tier_weights = {}
        self.tier_weights[tier] = w
        for rep in self.replicas:
            set_w = getattr(rep.predictor, "set_tier_weight", None)
            if set_w is not None:
                set_w(tier, w)

    def set_shed_tiers(self, tiers):
        """Replace the set of tiers refused at admission (frozenset
        swap: submit() reads one attribute, no lock needed)."""
        self.shed_tiers = frozenset(tiers)

    # ------------------------------------------------------- convenience --
    def generate(self, prompts, max_new_tokens=32, tiers=None,
                 deadline_s=None, timeout=None):
        """Blocking batch API mirroring the predictor's: route every
        prompt, wait for all, return List[List[int]] in order.
        `self.last_status` mirrors the per-request terminal statuses."""
        hs = [self.submit(p, max_new_tokens=max_new_tokens,
                          tier=tiers[i] if tiers else None,
                          deadline_s=deadline_s[i]
                          if isinstance(deadline_s, (list, tuple))
                          else deadline_s)
              for i, p in enumerate(prompts)]
        outs = [h.result(timeout=timeout) for h in hs]
        self.last_status = [h.status for h in hs]
        self.last_handles = hs
        return outs

    def generate_stream(self, prompt, max_new_tokens=32, tier=None,
                        deadline_s=None):
        """Single-request streaming API: yields the handle's
        StreamEvents (token ... token, end)."""
        return self.submit(prompt, max_new_tokens=max_new_tokens,
                           tier=tier, deadline_s=deadline_s).stream()

    # -------------------------------------------------------- lifecycle --
    def stats(self) -> Dict[str, dict]:
        out = {}
        for rep in self.replicas:
            s = dict(rep.predictor.stats)
            s.update(queue_depth=rep.queue_depth(), load=rep.load,
                     served=rep.served, ejected=rep.ejected,
                     consecutive_failures=rep.consecutive_failures,
                     last_failure=rep.last_failure,
                     affinity_keys=len(rep.affinity), role=rep.role)
            out[rep.name] = s
        return out

    def autoscale(self, slo_ttft_s=0.25, publish=True) -> dict:
        """The serving.autoscale.* signal view (autoscale.py). The
        demand term is EWMA-smoothed across calls on a router-held
        smoother so `desired_replicas` doesn't flap with every queue
        burst."""
        from ..observability.slo import Ewma
        from .autoscale import autoscale_signals, publish_autoscale
        sm = getattr(self, "_as_smoother", None)
        if sm is None:
            sm = self._as_smoother = Ewma(half_life_s=10.0)
        sig = autoscale_signals(self, slo_ttft_s=slo_ttft_s, smoother=sm)
        if publish:
            publish_autoscale(sig)
        return sig

    def shutdown(self, timeout: float = 5.0):
        """Close every replica's intake, let the serve loops drain what
        they already accepted, and join the workers. Requests still
        inbox-queued (never picked up by a serve loop) finish with
        status "shutdown" — a blocked result()/stream() must not hang
        on a pool that no longer exists."""
        for rep in self.replicas:
            for h in rep.drain():
                self._request_done(h, "shutdown", None)
        for rep in self.replicas:
            rep.thread.join(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False
