"""Critical-path attribution over one request's span tree (counterpart
of ``paddle_tpu/observability/critpath.py``).

A disaggregated request leaves a *tree* of spans in one trace — the
router's ``router.request`` root, a prefill-side ``serve.request``, the
handoff events, a decode-side ``serve.request`` — and an aggregate p99
gauge cannot say which stage made it slow. This module folds that tree
into a telescoping stage decomposition: consecutive milestone
timestamps along the request's life, so the stage values sum EXACTLY to
the measured span window (TTFT up to the ``first_token`` milestone, E2E
up to ``finish``). The serving router exports the same decomposition
live as ``serve.request.stage.seconds{stage=...}`` histograms;
the reference's ``tools/trace_report.py --request <trace_id>`` renders it
offline from the JSONL sink. Stdlib only.

Stages, in path order (absent boundaries are skipped — a unified pool
has no handoff stages):

==================  ======================================================
``admission``       router submit -> replica chosen (``routed``)
``dispatch``        routed -> the replica serve loop saw the request
``queue``           replica intake -> prefill starts (batch admission)
``prefill``         prefill/chunked-ingest compute -> first token
``handoff_export``  prefill finished -> KV page span exported
``handoff_transfer``span exported -> decode replica begins the import
``handoff_import``  page-span import (verify + scatter) on decode
``decode_queue``    imported -> decode-side slot admission
``decode``          per-tick decode (spec draft/verify ticks included;
                    their counts ride ``aux``)
``flush``           last decode tick -> stream completion at the handle
==================  ======================================================
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

__all__ = ["STAGES", "trace_tree", "stage_decomposition"]

STAGES = ("admission", "dispatch", "queue", "prefill", "handoff_export",
          "handoff_transfer", "handoff_import", "decode_queue",
          "decode", "flush")


def _ev_ts(span: dict, *names: str, last: bool = False) \
        -> Optional[float]:
    hit = None
    for ev in span.get("events") or ():
        if ev.get("name") in names and ev.get("ts") is not None:
            hit = float(ev["ts"])
            if not last:
                return hit
    return hit


def trace_tree(spans: List[dict], trace_id: Optional[str] = None) \
        -> dict:
    """Group `spans` (span dicts, ``as_dict`` schema) into one trace's
    tree: the root (``parent`` is None — ``router.request`` preferred,
    else the earliest), the trace's spans sorted by start, and any
    orphans (spans whose ``parent`` does not resolve inside the
    trace — a broken propagation chain)."""
    if trace_id is not None:
        spans = [s for s in spans if s.get("trace") == trace_id]
    spans = sorted(spans, key=lambda s: float(s.get("start") or 0.0))
    ids = {s.get("span") for s in spans}
    roots = [s for s in spans if not s.get("parent")]
    root = None
    for s in roots:
        if s.get("name") == "router.request":
            root = s
            break
    if root is None and roots:
        root = roots[0]
    if root is None and spans:
        root = spans[0]
    orphans = [s for s in spans
               if s.get("parent") and s["parent"] not in ids]
    return {"root": root, "spans": spans, "orphans": orphans}


def _span_end(span: dict) -> Optional[float]:
    start = span.get("start")
    dur = span.get("dur")
    if start is None or dur is None:
        return None
    return float(start) + float(dur)


def stage_decomposition(spans: List[dict],
                        trace_id: Optional[str] = None) -> dict:
    """Fold one trace's spans into the telescoping stage table.

    Returns ``{"trace", "stages": [(stage, seconds), ...], "ttft",
    "e2e", "aux"}``. ``stages`` telescopes: each value is the gap to
    the previous milestone (clamped monotonic), so
    ``sum(stages) == e2e`` and the prefix up to the ``prefill`` stage
    sums to ``ttft`` — by construction, not by luck. ``ttft``/``e2e``
    are None/0 when the trace never reached the milestone."""
    tree = trace_tree(spans, trace_id=trace_id)
    root = tree["root"]
    if root is None:
        return {"trace": trace_id, "stages": [], "ttft": None,
                "e2e": 0.0, "aux": {"orphans": 0}}
    t0 = float(root.get("start") or 0.0)
    sreqs = [s for s in tree["spans"] if s.get("name") == "serve.request"]
    first_sreq = sreqs[0] if sreqs else None
    is_router_root = root.get("name") == "router.request"
    if not is_router_root and first_sreq is None \
            and root.get("name") == "serve.request":
        first_sreq = root

    # ---- milestone timestamps (None = boundary never crossed) --------
    m: List[Tuple[str, Optional[float]]] = []
    if is_router_root:
        m.append(("admission", _ev_ts(root, "routed")))
        m.append(("dispatch", float(first_sreq["start"])
                  if first_sreq else None))
    if first_sreq is not None:
        m.append(("queue", _ev_ts(first_sreq, "prefill", "admitted")))
    # first_token on the root (the handle's stream clock — what the
    # router's TTFT histogram measures) falls back to the serve loop's
    ft = _ev_ts(root, "first_token")
    if ft is None and first_sreq is not None:
        ft = _ev_ts(first_sreq, "first_token")
    m.append(("prefill", ft))
    if is_router_root:
        m.append(("handoff_export", _ev_ts(root, "handoff")))
        m.append(("handoff_transfer",
                  _ev_ts(root, "handoff_import_start")))
        m.append(("handoff_import", _ev_ts(root, "handoff_imported",
                                           "handoff_import_failed")))
        post = [s for s in sreqs[1:]]
        if post:
            m.append(("decode_queue", _ev_ts(post[0], "admitted")))
    dec_fin = None
    for s in reversed(sreqs):
        dec_fin = _ev_ts(s, "finish", last=True)
        if dec_fin is not None:
            break
    m.append(("decode", dec_fin))
    end = _ev_ts(root, "finish", last=True) or _span_end(root)
    m.append(("flush", end))

    stages: List[Tuple[str, float]] = []
    ttft = None
    prev = t0
    for stage, ts in m:
        if ts is None:
            continue
        ts = max(float(ts), prev)      # keep the telescoping exact
        stages.append((stage, ts - prev))
        prev = ts
        if stage == "prefill":
            ttft = prev - t0
    e2e = prev - t0

    spec_ticks = spec_accepted = tokens = 0
    for s in sreqs:
        for ev in s.get("events") or ():
            n = ev.get("name")
            if n == "spec":
                spec_ticks += 1
                spec_accepted += int(ev.get("accepted") or 0)
            elif n == "token":
                tokens += 1
    return {"trace": root.get("trace"), "stages": stages, "ttft": ttft,
            "e2e": e2e,
            "aux": {"orphans": len(tree["orphans"]),
                    "spans": len(tree["spans"]), "tokens": tokens,
                    "spec_ticks": spec_ticks,
                    "spec_accepted": spec_accepted,
                    "status": root.get("status")}}
