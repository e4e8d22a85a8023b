"""Autoscale signals: the ``serving.autoscale.*`` view (counterpart of
``paddle_tpu/serving/autoscale.py``).

An external scaler (an operator loop, an HPA-style controller, a human
with a dashboard) needs a small, stable set of signals to size the
replica pool. This module computes them from state the stack already
tracks — the observability registry and, when given, a live Router —
and publishes them as gauges so they flow through the existing
JSONL/Prometheus sinks unchanged:

- ``serving.autoscale.queue_depth{tier}`` — queued work per priority
  tier (router inboxes + every replica's admission queue).
- ``serving.autoscale.ttft_burn`` — TTFT-SLO burn rate: p90 TTFT over
  the SLO target. >1 means the pool is burning its latency budget and
  should scale out; sustained <0.5 means headroom to scale in.
- ``serving.autoscale.page_pressure{replica}`` — KV page-pool
  utilization per replica (the serving capacity that actually runs
  out first on a memory-bound model).
- ``serving.autoscale.replica_utilization{replica}`` — in-flight decode
  slots over max_batch_size.
- ``serving.autoscale.healthy_replicas`` / ``desired_replicas`` — pool
  size now, and the suggestion: ``ceil(healthy * pressure)`` where
  pressure is the max of the burn rate, mean slot utilization, and
  queue backlog per replica-slot, clamped to [1, 4x healthy].

The suggestion is deliberately simple — the point is that every term
is externally recomputable from the exported series, so a real scaler
can own the policy and treat ours as a reference implementation.
"""
from __future__ import annotations

import math
import time
from typing import Optional

from ..observability import metrics as _obsm
from ..observability.runtime import export_record

__all__ = ["autoscale_signals", "publish_autoscale"]


def _hist_quantile(metric, q: float) -> float:
    """Max quantile across a histogram family's labeled series (the
    conservative read: the worst tier/replica drives scaling)."""
    if metric is None:
        return 0.0
    best = 0.0
    for s in metric.series():
        if s.count:
            best = max(best, s.quantile(q))
    return best


def autoscale_signals(router=None, registry=None, slo_ttft_s: float = 0.25,
                      max_scale: int = 4, smoother=None) -> dict:
    """Compute the signal dict (no side effects — `publish_autoscale`
    exports it). Works registry-only (router=None) for processes that
    run a bare predictor; the router adds inbox depth, health, and
    slot-accurate utilization.

    `smoother` is an observability.slo.Ewma (or anything with
    ``update(value) -> float``) applied to the demand term before
    sizing: queue depth is instantaneous, and a controller acting on
    the raw value flaps a replica in and out on every burst. Callers
    that scale on these signals should hold ONE smoother across calls
    (Router.autoscale and serving.controller do) so the EWMA window —
    the same half-life the SLO engine's fast window uses — actually
    accumulates; `demand_raw` stays in the dict for dashboards."""
    reg = registry if registry is not None else _obsm.get_registry()

    # queued work per tier: replica admission queues (serving.tier.*
    # when tiers are in play, else the untiered queue gauge)
    queue_by_tier: dict = {}
    m = reg.get("serving.tier.queue_depth")
    if m is not None:
        for s in m.samples():
            t = s.labels.get("tier", "default")
            queue_by_tier[t] = queue_by_tier.get(t, 0.0) + s.value
    if not queue_by_tier:
        m = reg.get("serving.queue_depth")
        if m is not None:
            total = sum(s.value for s in m.samples())
            if total:
                queue_by_tier["default"] = total
    healthy = n_replicas = None
    slots = 0
    util = {}
    pressure = {}
    if router is not None:
        healthy = len(router.healthy())
        n_replicas = len(router.replicas)
        for rep in router.replicas:
            pred = rep.predictor
            slots += pred.B
            # the serve loop's slot table is loop-local: the in_flight
            # gauge is the live source, pending count the fallback.
            # Gate on the PREDICTOR's name — an unnamed predictor
            # writes an UNLABELED in_flight series, and peeking it by
            # the router-assigned replica name would read 0 forever
            g = reg.get("serving.in_flight")
            if g is not None and pred.name:
                active = g.value(replica=pred.name)
            else:
                active = min(len(rep.pending), pred.B)
            util[rep.name] = active / max(pred.B, 1)
            pressure[rep.name] = (pred.capacity - pred.pool.free_count) \
                / max(pred.capacity, 1)
            for h in list(rep.inbox):
                t = h.tier or "default"
                queue_by_tier[t] = queue_by_tier.get(t, 0.0) + 1
    else:
        caps = {}
        g = reg.get("serving.slots")
        if g is not None:
            for s in g.samples():
                caps[s.labels.get("replica", "default")] = s.value
        slots = int(sum(caps.values()))
        g = reg.get("serving.in_flight")
        if g is not None:
            # in_flight is a raw slot count: normalize by the replica's
            # exported capacity so util matches the router branch
            for s in g.samples():
                name = s.labels.get("replica", "default")
                util[name] = s.value / max(caps.get(name, 1.0), 1.0)
        g = reg.get("serving.page_utilization")
        if g is not None:
            for s in g.samples():
                pressure[s.labels.get("replica", "default")] = s.value

    ttft_p90 = _hist_quantile(
        reg.get("serving.router.ttft_seconds")
        or reg.get("serving.ttft_seconds"), 0.9)
    burn = ttft_p90 / slo_ttft_s if slo_ttft_s > 0 else 0.0

    total_queue = sum(queue_by_tier.values())
    mean_util = (sum(util.values()) / len(util)) if util else 0.0
    backlog_per_slot = total_queue / max(slots, 1) if slots \
        else (1.0 if total_queue else 0.0)
    demand_raw = max(burn, mean_util, backlog_per_slot)
    demand = smoother.update(demand_raw) if smoother is not None \
        else demand_raw
    base = healthy if healthy else max(len(util), 1)
    desired = max(1, min(int(math.ceil(base * max(demand, 0.25))),
                         base * max_scale))

    # role-scoped signals (disaggregated prefill/decode fleets): one
    # block per role so the PoolController can size each fleet
    # independently — a prefill spike must grow the prefill fleet, not
    # N copies of everything. Present only when the pool actually has
    # non-unified roles; unified pools keep the exact legacy dict.
    role_sig = {}
    if router is not None:
        # getattr: duck-typed external routers (and the controller's
        # test stubs) predate roles — role-less replicas read as a
        # unified pool and keep the exact legacy signal dict
        role_names = {getattr(rep, "role", None) or "unified"
                      for rep in router.replicas}
        if role_names - {"unified"}:
            for role in sorted(role_names):
                hr = [r for r in router.healthy()
                      if (getattr(r, "role", None) or "unified") == role]
                u = [util[r.name] for r in hr if r.name in util]
                p = [pressure[r.name] for r in hr if r.name in pressure]
                qd = sum(r.queue_depth() for r in hr)
                rslots = sum(r.predictor.B for r in hr)
                mean_u = sum(u) / len(u) if u else 0.0
                backlog = qd / max(rslots, 1) if rslots \
                    else (1.0 if qd else 0.0)
                d_raw = max(mean_u, backlog, max(p, default=0.0))
                base_r = max(len(hr), 1)
                role_sig[role] = {
                    "healthy": len(hr),
                    "queue_depth": int(qd),
                    "utilization": round(mean_u, 4),
                    "page_pressure": round(max(p, default=0.0), 4),
                    "demand": round(d_raw, 4),
                    "desired": max(1, min(
                        int(math.ceil(base_r * max(d_raw, 0.25))),
                        base_r * max_scale)),
                }

    return {
        **({"roles": role_sig} if role_sig else {}),
        "ts": round(time.time(), 3),
        "slo_ttft_s": slo_ttft_s,
        "queue_depth": {k: int(v) for k, v in queue_by_tier.items()},
        "ttft_p90_s": round(ttft_p90, 6),
        "ttft_burn": round(burn, 4),
        "demand_raw": round(demand_raw, 4),
        "demand": round(demand, 4),
        "page_pressure": {k: round(v, 4) for k, v in pressure.items()},
        "replica_utilization": {k: round(v, 4) for k, v in util.items()},
        "healthy_replicas": healthy,
        "total_replicas": n_replicas,
        "desired_replicas": desired,
    }


def publish_autoscale(sig: dict, registry: Optional[object] = None):
    """Export the signal dict: set the serving.autoscale.* gauges (they
    ride every configured exporter) and write one {"kind": "autoscale"}
    record through the process JSONL sink for log-structured scalers."""
    reg = registry if registry is not None else _obsm.get_registry()
    for tier, v in sig["queue_depth"].items():
        reg.gauge("serving.autoscale.queue_depth").set(v, tier=tier)
    reg.gauge("serving.autoscale.ttft_burn").set(sig["ttft_burn"])
    for name, v in sig["page_pressure"].items():
        reg.gauge("serving.autoscale.page_pressure").set(v, replica=name)
    for name, v in sig["replica_utilization"].items():
        reg.gauge("serving.autoscale.replica_utilization").set(
            v, replica=name)
    if sig.get("healthy_replicas") is not None:
        reg.gauge("serving.autoscale.healthy_replicas").set(
            sig["healthy_replicas"])
    reg.gauge("serving.autoscale.desired_replicas").set(
        sig["desired_replicas"])
    if "demand" in sig:
        reg.gauge("serving.autoscale.demand").set(
            sig["demand_raw"], view="raw")
        reg.gauge("serving.autoscale.demand").set(
            sig["demand"], view="smoothed")
    # role-scoped fleet signals ride DISTINCT gauge names (role_*), all
    # labeled {role} — never the unlabeled pool totals above, so a
    # report summing one family cannot double-count the other
    for role, rs in (sig.get("roles") or {}).items():
        reg.gauge("serving.autoscale.role_healthy").set(
            rs["healthy"], role=role)
        reg.gauge("serving.autoscale.role_queue_depth").set(
            rs["queue_depth"], role=role)
        reg.gauge("serving.autoscale.role_utilization").set(
            rs["utilization"], role=role)
        reg.gauge("serving.autoscale.role_page_pressure").set(
            rs["page_pressure"], role=role)
        reg.gauge("serving.autoscale.role_desired").set(
            rs["desired"], role=role)
    export_record({"kind": "autoscale", **sig})
