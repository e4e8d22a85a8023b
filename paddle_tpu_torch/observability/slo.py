"""Declarative SLOs evaluated from the live metrics registry
(counterpart of ``paddle_tpu/observability/slo.py``).

The autoscale view (the reference's serving/autoscale.py) exports raw
pressure signals; this module turns them into *objectives*: "99% of requests see first
token within 250ms", "99% of completions parse", per tenant tier. Each
:class:`SLOSpec` binds one objective to metric families the stack
already records, and :class:`SLOEngine.evaluate` keeps the error-budget
accounting the SRE playbook calls multi-window burn rates:

- budget = 1 - objective (the tolerated bad fraction).
- burn(W) = bad_fraction over window W / budget. burn == 1 means the
  budget is being spent exactly at the tolerated rate; burn == 10 means
  the budget for the whole window is gone in a tenth of it.
- a breach fires when BOTH the fast and the slow window burn above the
  threshold — the fast window makes the alert quick, the slow window
  keeps a transient blip from paging (and from flapping the controller
  that consumes these gauges, serving/controller.py).

Evaluation is cumulative-delta based: each tick diffs the underlying
counters/bucket counts against the previous tick and feeds the deltas
into rolling windows, so the engine works on top of the existing
monotonic families without private hooks. Latency objectives count an
observation as "good" when it lands in a histogram bucket at or below
the target — pick targets on bucket boundaries (DEFAULT_BUCKETS or a
custom `buckets=`) for exact accounting; an off-boundary target is
rounded conservatively (the straddling bucket counts as bad).

Exports (the reference's docs/OBSERVABILITY.md "SLOs & the control
loop"):
``slo.burn_rate{slo,window}``, ``slo.target{slo}``,
``slo.breaches{slo}`` and, on each breach episode, one
``{"kind": "slo_breach"}`` JSONL record carrying the burn numbers AND
the offending spans from the flight recorder — the page includes its
own evidence.
"""
from __future__ import annotations

import bisect
import collections
import math
import time
from typing import Dict, List, Optional

from . import metrics as _obsm
from . import tracing as _obstr
from .runtime import export_record

__all__ = ["Ewma", "SLOSpec", "SLOEngine", "default_serving_slos"]


class Ewma:
    """Time-aware exponential moving average with a half-life.

    ``update(v, now)`` decays the held value toward ``v`` so that a
    constant input converges and a sample `half_life_s` old carries
    half the weight of a fresh one. Shared by the SLO engine's burn
    smoothing and the autoscale `desired_replicas` fix
    (serving/autoscale.py) so both flap-damp on the same clock.
    """

    def __init__(self, half_life_s: float = 30.0, now_fn=time.time):
        self.half_life_s = float(half_life_s)
        self._now = now_fn
        self._value: Optional[float] = None
        self._ts: Optional[float] = None

    def update(self, value: float, now: Optional[float] = None) -> float:
        t = self._now() if now is None else float(now)
        v = float(value)
        if self._value is None or self.half_life_s <= 0:
            self._value, self._ts = v, t
            return v
        prev = self._ts if self._ts is not None else t
        dt = max(t - prev, 0.0)
        alpha = 1.0 - math.pow(0.5, dt / self.half_life_s)
        self._value += alpha * (v - self._value)
        self._ts = t
        return self._value

    @property
    def value(self) -> Optional[float]:
        return self._value


class SLOSpec:
    """One declarative objective bound to registry families.

    kind="latency": `metric` names a Histogram; an observation is good
    when <= `target` (seconds, snapped to a bucket boundary).
    kind="ratio": `metric` names a Counter and `good_labels` selects
    the good series (e.g. status="ok"); every series matching `labels`
    counts toward the total — parse-valid rates, success rates.

    `labels` filters which series are in scope (per-tenant SLOs pass
    tier=...); `objective` is the required good fraction; `tier` is a
    display/routing label the controller uses to pick which tenant to
    protect.
    """

    def __init__(self, name: str, metric: str, target: float = 0.0,
                 kind: str = "latency", objective: float = 0.99,
                 labels: Optional[Dict[str, str]] = None,
                 good_labels: Optional[Dict[str, str]] = None,
                 tier: Optional[str] = None,
                 fallback_metrics: tuple = (),
                 evidence_span: str = "router.request",
                 description: str = ""):
        if kind not in ("latency", "ratio"):
            raise ValueError(f"unknown SLO kind {kind!r}")
        if not (0.0 < objective < 1.0):
            raise ValueError("objective must be in (0, 1)")
        if kind == "ratio" and not good_labels:
            raise ValueError("ratio SLO needs good_labels")
        self.name = name
        self.metric = metric
        self.fallback_metrics = tuple(fallback_metrics)
        self.target = float(target)
        self.kind = kind
        self.objective = float(objective)
        self.labels = dict(labels or {})
        self.good_labels = dict(good_labels or {})
        self.tier = tier
        self.evidence_span = evidence_span
        self.description = description

    @property
    def budget(self) -> float:
        return 1.0 - self.objective

    def as_dict(self) -> dict:
        return {"name": self.name, "metric": self.metric,
                "kind": self.kind, "target": self.target,
                "objective": self.objective, "labels": self.labels,
                "good_labels": self.good_labels, "tier": self.tier}


def default_serving_slos(ttft_target_s: float = 0.25,
                         inter_token_target_s: float = 0.05,
                         objective: float = 0.95,
                         tier: Optional[str] = None) -> List[SLOSpec]:
    """The serving objectives every deployment starts from: TTFT,
    inter-token latency, and completion success rate (a parse-valid
    rate binds the same way: a ratio spec over its validity counter)."""
    tl = {"tier": tier} if tier else {}
    return [
        SLOSpec("ttft", "serving.router.ttft_seconds",
                target=ttft_target_s, objective=objective,
                labels=tl, tier=tier,
                fallback_metrics=("serving.ttft_seconds",),
                description="time to first token"),
        SLOSpec("inter_token", "serving.token_latency_seconds",
                target=inter_token_target_s, objective=objective,
                evidence_span="serve.request",
                description="decode inter-token latency"),
        SLOSpec("completion_ok", "serving.router.completed",
                kind="ratio", objective=objective,
                labels=tl, tier=tier, good_labels={"status": "ok"},
                description="requests finishing with status ok"),
    ]


class _Window:
    """Rolling (good, bad) totals over the last `horizon_s` seconds,
    fed with per-tick deltas."""

    __slots__ = ("horizon_s", "_buf", "_good", "_bad")

    def __init__(self, horizon_s: float):
        self.horizon_s = float(horizon_s)
        self._buf: collections.deque = collections.deque()
        self._good = 0.0
        self._bad = 0.0

    def add(self, ts: float, good: float, bad: float):
        if good or bad:
            self._buf.append((ts, good, bad))
            self._good += good
            self._bad += bad
        self._expire(ts)

    def _expire(self, now: float):
        cutoff = now - self.horizon_s
        buf = self._buf
        while buf and buf[0][0] < cutoff:
            _, g, b = buf.popleft()
            self._good -= g
            self._bad -= b

    def totals(self, now: float):
        self._expire(now)
        return self._good, self._bad


class _SpecState:
    __slots__ = ("cum_good", "cum_bad", "fast", "slow", "alerting",
                 "breaches")

    def __init__(self, fast_s: float, slow_s: float):
        self.cum_good: Optional[float] = None
        self.cum_bad: Optional[float] = None
        self.fast = _Window(fast_s)
        self.slow = _Window(slow_s)
        self.alerting = False    # breach episode in progress
        self.breaches = 0


def _labels_match(series_labels: dict, want: dict) -> bool:
    return all(series_labels.get(k) == v for k, v in want.items())


def _good_leq(series, target: float):
    """(good, total) observation counts for one histogram series: good
    = observations landing in buckets bounded at or below `target`."""
    with series._lock:
        buckets = series._buckets
        counts = list(series._counts)
        total = series._count
    k = bisect.bisect_left(buckets, target)
    good = sum(counts[:k])
    if k < len(buckets) and buckets[k] == target:
        good += counts[k]
    return good, total


class SLOEngine:
    """Continuous SLO evaluation over the process metric registry.

    ``evaluate()`` is the tick: diff the bound families, feed the
    fast/slow windows, export the ``slo.*`` gauges, and emit one
    evidence-carrying breach record per breach *episode* (re-armed when
    the fast window recovers below the threshold). Pure host-side
    bookkeeping — safe at controller-tick cadence. `now_fn` is
    injectable so tests drive a synthetic clock.
    """

    def __init__(self, specs: Optional[List[SLOSpec]] = None,
                 registry: Optional[object] = None,
                 fast_window_s: float = 60.0,
                 slow_window_s: float = 600.0,
                 breach_burn: float = 1.0,
                 evidence_limit: int = 5,
                 now_fn=time.time):
        self.specs = list(specs if specs is not None
                          else default_serving_slos())
        self._reg = registry if registry is not None \
            else _obsm.get_registry()
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.breach_burn = float(breach_burn)
        self.evidence_limit = int(evidence_limit)
        self._now = now_fn
        self._state: Dict[str, _SpecState] = {
            s.name: _SpecState(self.fast_window_s, self.slow_window_s)
            for s in self.specs}
        self.last: Dict[str, dict] = {}

    # ------------------------------------------------------- accounting --
    def _metric_for(self, spec: SLOSpec):
        m = self._reg.get(spec.metric)
        for alt in spec.fallback_metrics:
            if m is not None and any(True for _ in m.samples()):
                break
            alt_m = self._reg.get(alt)
            if alt_m is not None:
                m = alt_m
        return m

    def _cumulative(self, spec: SLOSpec):
        """Cumulative (good, bad) event counts for one spec, summed
        over every in-scope labeled series."""
        m = self._metric_for(spec)
        if m is None:
            return 0.0, 0.0
        good = total = 0.0
        if spec.kind == "latency":
            for s in m.series():
                if not _labels_match(s._labels, spec.labels):
                    continue
                g, t = _good_leq(s, spec.target)
                good += g
                total += t
        else:
            want_good = dict(spec.labels)
            want_good.update(spec.good_labels)
            for s in m.series():
                if not _labels_match(s._labels, spec.labels):
                    continue
                total += s._value
                if _labels_match(s._labels, want_good):
                    good += s._value
        return good, max(total - good, 0.0)

    # ------------------------------------------------------------- tick --
    def evaluate(self, now: Optional[float] = None,
                 publish: bool = True) -> Dict[str, dict]:
        t = self._now() if now is None else float(now)
        out: Dict[str, dict] = {}
        for spec in self.specs:
            st = self._state[spec.name]
            good, bad = self._cumulative(spec)
            if st.cum_good is None or good < st.cum_good \
                    or bad < st.cum_bad:
                # first tick, or the registry was reset underneath us:
                # (re)baseline without crediting the jump to any window
                dg = db = 0.0
            else:
                dg = good - st.cum_good
                db = bad - st.cum_bad
            st.cum_good, st.cum_bad = good, bad
            st.fast.add(t, dg, db)
            st.slow.add(t, dg, db)
            status = self._status(spec, st, t)
            out[spec.name] = status
            if publish:
                self._publish(spec, st, status)
        self.last = out
        return out

    def _status(self, spec: SLOSpec, st: _SpecState, now: float) -> dict:
        burns = {}
        fracs = {}
        events = {}
        for wname, w in (("fast", st.fast), ("slow", st.slow)):
            g, b = w.totals(now)
            n = g + b
            frac = b / n if n else 0.0
            burns[wname] = frac / spec.budget
            fracs[wname] = frac
            events[wname] = (g, b)
        breach_now = (burns["fast"] >= self.breach_burn
                      and burns["slow"] >= self.breach_burn)
        new_episode = breach_now and not st.alerting
        if new_episode:
            st.breaches += 1
        st.alerting = breach_now
        return {"slo": spec.name, "kind": spec.kind,
                "target": spec.target, "objective": spec.objective,
                "tier": spec.tier, "burn": burns,
                "bad_fraction": fracs, "events": events,
                "breaching": breach_now, "new_breach": new_episode,
                "breaches": st.breaches}

    # ----------------------------------------------------------- export --
    def _publish(self, spec: SLOSpec, st: _SpecState, status: dict):
        tl = {"tier": spec.tier} if spec.tier else {}
        for wname, burn in status["burn"].items():
            self._reg.gauge("slo.burn_rate").set(
                burn, slo=spec.name, window=wname, **tl)
        self._reg.gauge("slo.target").set(spec.target, slo=spec.name)
        if status["new_breach"]:
            self._reg.counter("slo.breaches").inc(slo=spec.name, **tl)
            self._emit_breach(spec, status)

    def _emit_breach(self, spec: SLOSpec, status: dict):
        rec = {"kind": "slo_breach", "ts": round(time.time(), 6),
               "slo": spec.name, "target": spec.target,
               "objective": spec.objective, "tier": spec.tier,
               "burn_fast": round(status["burn"]["fast"], 4),
               "burn_slow": round(status["burn"]["slow"], 4),
               "window_fast_s": self.fast_window_s,
               "window_slow_s": self.slow_window_s,
               "events_fast": list(status["events"]["fast"]),
               "events_slow": list(status["events"]["slow"]),
               "evidence": self._evidence(spec),
               "exemplars": self._exemplars(spec)}
        export_record(rec)

    def _evidence(self, spec: SLOSpec) -> List[dict]:
        """The offending spans, straight off the flight-recorder ring:
        the breach record carries its own forensics."""
        out: List[dict] = []
        for sp in reversed(_obstr.flight_recorder().spans()):
            if len(out) >= self.evidence_limit:
                break
            if sp.get("name") != spec.evidence_span:
                continue
            labels = sp.get("labels", {})
            if not _labels_match(labels, spec.labels):
                continue
            if spec.kind == "latency" \
                    and sp.get("dur", 0.0) <= spec.target:
                continue
            if spec.kind == "ratio" and sp.get("status") in ("ok", None):
                continue
            out.append({"name": sp.get("name"), "trace": sp.get("trace"),
                        "span": sp.get("span"),
                        "dur": round(sp.get("dur", 0.0), 6),
                        "status": sp.get("status"), "labels": labels})
        return out

    def _exemplars(self, spec: SLOSpec) -> List[dict]:
        """Tail exemplars off the spec's bound histogram: the trace
        ids of its largest observations, so a burn page links straight
        to renderable traces (tools/trace_report.py --request)."""
        m = self._metric_for(spec)
        if m is None or not hasattr(m, "exemplars"):
            return []     # ratio specs bind counters: no exemplars
        try:
            ex = m.exemplars(**spec.labels) or m.exemplars()
        except Exception:
            return []
        return [{"value": round(v, 6), "trace": t} for v, t in ex]

    # ------------------------------------------------------ convenience --
    def burn(self, name: str, window: str = "fast") -> float:
        """Last evaluated burn rate (0.0 before the first tick)."""
        st = self.last.get(name)
        return st["burn"].get(window, 0.0) if st else 0.0

    def breaching(self, name: str) -> bool:
        st = self.last.get(name)
        return bool(st and st["breaching"])
