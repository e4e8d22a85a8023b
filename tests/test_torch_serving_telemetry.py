"""The telemetry the port records on its serving and training paths,
against the JAX reference's.

The same traffic, on a tiny Llama with the reference's weights
(``convert``), goes through both ``ContinuousBatchingPredictor``s —
greedy with prefix hits and a partial hit, chunked prefill, lookup
speculation, deadlines, a bounded queue that sheds, tiers, a rejection,
cancellation, a ``decode_wedge`` fault under the watchdog, and
``serve_stream`` requests carrying a ``TraceContext``. Each package's
registry must then hold the same series (names and label sets), equal
counter and final gauge values (the cold-start time aside) and equal
histogram counts; the ``serve.*`` spans must have the same names,
parents, statuses, labels and events; every ``StreamEvent.ts`` must be
one of its request span's event times; and the port's registry must
agree with its own ``stats``. Also: the AOT engine's and builder's
series and spans on a CPU build and warm start (the build against the
reference builder's), the Trainer's spans and gauges on a run with one
NaN step against the reference Trainer's, and the Trainer's
``RankHeartbeat`` file.
"""
import collections
import json
import os

import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.observability as ref_obs
from paddle_tpu.serving import ServeRequest as RefServeRequest

import paddle_tpu_torch.observability as obs
from paddle_tpu_torch.framework import flags
from paddle_tpu_torch.inference import aot
from paddle_tpu_torch.serving import ServeRequest

from test_torch_predictor import _pair, _predictors, _prompts
from test_torch_serving_frontend import _cyclic
from test_torch_train import OPT, _data, _ref_data

# series whose value is a time: compared by label set only
TIMED = {"serve.cold_start_seconds", "aot.build_seconds"}
PREFIXES = ("serving.", "serve.", "robustness.", "aot.", "train.")


@pytest.fixture(autouse=True)
def _clean(tmp_path):
    for o in (obs, ref_obs):
        o.configure(None)
        o.enabled(True)
        o.get_registry().reset()
        o.flight_recorder().clear()
        o.set_flight_dir(str(tmp_path / ("port" if o is obs else "ref")))
    yield
    paddle.set_flags({"fault_injection": "",
                      "serve_decode_watchdog_s": 0.0})
    flags.set_flags({"fault_injection": "", "serve_decode_watchdog_s": 0.0})
    for o in (obs, ref_obs):
        o.set_flight_dir(None)
        o.get_registry().reset()
        o.flight_recorder().clear()


def _arm(spec):
    paddle.set_flags({"fault_injection": spec})
    flags.set_flags({"fault_injection": spec})


def _registry(o, timed=False):
    """{name: {labels: value}} over the series the port records: counter
    and gauge values, histogram counts (time-valued gauges by label set
    only unless ``timed``)."""
    out = {}
    for m in o.get_registry().metrics():
        if not m.name.startswith(PREFIXES):
            continue
        for s in m.series():
            key = tuple(sorted(s._labels.items()))
            if m.kind == "histogram":
                v = s._count
            elif m.name in TIMED and not timed:
                v = "time"
            else:
                v = s._value
            out.setdefault(m.name, {})[key] = v
    return out


def _spans(o, names=("serve.",)):
    """The finished spans of the flight ring in ring order, ids replaced
    by the parent's name (or "ctx" for a TraceContext from outside)."""
    spans = o.flight_recorder().spans()
    by_id = {s["span"]: s["name"] for s in spans}
    out = []
    for s in spans:
        if not s["name"].startswith(names):
            continue
        parent = s["parent"]
        out.append({"name": s["name"], "status": s["status"],
                    "labels": s["labels"],
                    "parent": by_id.get(parent, parent and "ctx"),
                    "events": [{k: v for k, v in e.items() if k != "ts"}
                               for e in s["events"]],
                    "dropped": s.get("dropped_events", 0)})
    return out


def _stats_twins(cb, statuses):
    """(registry value, stats value) pairs of one serve on a registry
    reset before it."""
    def total(name, **want):
        m = obs.get_registry().get(name)
        if m is None:
            return 0.0
        return sum(s._value for s in m.series()
                   if all(s._labels.get(k) == v for k, v in want.items()))

    def unlabelled(name):
        m = obs.get_registry().get(name)
        return sum(s._value for s in m.series()
                   if "kind" not in s._labels) if m else 0.0
    st = cb.stats
    pairs = {
        "decode_steps": (total("serving.decode_steps"),
                         st["decode_steps"]),
        "admissions": (total("serving.admissions"),
                       st["prefills"] + st["prefix_hits"]
                       + st["chunked_requests"]),
        "evictions": (total("serving.evictions"), st["evictions"]),
        "prefix_hits": (unlabelled("serving.prefix_cache_hits"),
                        st["prefix_hits"]),
        "prefix_partial_hits": (total("serving.prefix_cache_hits",
                                      kind="partial"),
                                st["prefix_partial_hits"]),
        "prefix_misses": (total("serving.prefix_cache_misses"),
                          st["prefix_misses"]),
        "pages_reused": (total("serving.prefix_cache_pages_reused"),
                         st["pages_reused"]),
        "hol_skips": (total("serving.hol_skips"), st["hol_skips"]),
        "deadline_evictions": (total("robustness.deadline_evictions"),
                               st["deadline_evictions"]),
        "shed_requests": (total("robustness.shed_requests"),
                          st["shed_requests"]),
        "watchdog_trips": (total("robustness.watchdog_trips"),
                           st["watchdog_trips"]),
        "cancelled_requests": (total("serving.cancelled_requests"),
                               st["cancelled_requests"]),
        "spec_proposed": (total("serving.spec.proposed_tokens"),
                          st["spec_proposed"]),
        "spec_accepted": (total("serving.spec.accepted_tokens"),
                          st["spec_accepted"]),
        "prefill_chunks": (total("serving.chunked_prefill.chunks"),
                           st["prefill_chunks"]),
        "chunked_requests": (total("serving.chunked_prefill.requests"),
                             st["chunked_requests"]),
    }
    for status, n in collections.Counter(statuses).items():
        pairs["completed:" + status] = (
            total("serving.completed_requests", status=status), n)
    return pairs


def _ts_check(spans, streams):
    """Every stream event's ts is an event time of its request's span
    (``streams``: [(events, first request span index)])."""
    reqs = [s for s in spans if s["name"] == "serve.request"]
    for events, _ in streams:
        for ev in events:
            sp = next(s for s in reqs if s["labels"]["idx"] == ev.request)
            assert ev.ts in {e["ts"] for e in sp["events"]}, ev


# -------------------------------------------------------------- traffic --

def _greedy_prefix(cb, ref):
    base = _prompts(5, (11,))[0]
    ext = base + _prompts(6, (6,))[0]
    calls = [([base, _prompts(7, (16,))[0]], {}),
             ([base, ext, _prompts(7, (16,))[0]], {})]
    return calls


def _chunked(cb, ref):
    return [(_cyclic(2, 20) + [_prompts(12, (40,))[0]],
             dict(max_new_tokens=10))]


def _spec(cb, ref):
    return [(_cyclic(3, 20), dict(max_new_tokens=12))]


def _front_end(cb, ref):
    prompts = _prompts(4, (5, 9, 12, 7, 4, 10, 6, 70))
    return [(prompts, dict(max_new_tokens=3, strict=False,
                           tiers=["batch"] * 5 + ["interactive"] * 3,
                           tier_weights={"interactive": 8, "batch": 1},
                           deadline_s=[None, 0.0, None, None, 60.0, None,
                                       None, None]))]


CFGS = {
    "greedy_prefix": (_greedy_prefix, dict()),
    "chunked": (_chunked, dict(max_seq_len=128, prefill_chunk_tokens=16)),
    "spec": (_spec, dict(max_seq_len=128, spec_draft_tokens=3)),
    "front_end": (_front_end, dict(max_batch_size=1, max_queue=3)),
}


def _serve_calls(cb, calls, cancel_at=None):
    out = []
    for prompts, kw in calls:
        kw = dict(dict(max_new_tokens=6), **kw)
        st = cb.generate_stream(prompts, **kw)
        evs = []
        for ev in st:
            evs.append(ev)
            if cancel_at is not None and len(evs) == cancel_at[0]:
                st.cancel(cancel_at[1])
        out.append((evs, list(st.status)))
    return out


@pytest.mark.parametrize("cfg", list(CFGS))
def test_serving_registry_and_spans_match_reference(cfg):
    traffic, geom = CFGS[cfg]
    ref, port = _predictors(**geom)
    cancel_at = (2, 0) if cfg == "front_end" else None
    got = _serve_calls(port, traffic(port, False), cancel_at)
    want = _serve_calls(ref, traffic(ref, True), cancel_at)
    assert [s for _, s in got] == [s for _, s in want]
    assert [[(e.request, e.kind, e.token, e.index, e.status, e.span)
             for e in evs] for evs, _ in got] == \
        [[(e.request, e.kind, e.token, e.index, e.status, e.span)
          for e in evs] for evs, _ in want]
    assert _registry(obs) == _registry(ref_obs)
    assert _spans(obs) == _spans(ref_obs)
    # the port's registry is its stats, request by request
    statuses = [s for _, sts in got for s in sts]
    for k, (reg, st) in _stats_twins(port, statuses).items():
        assert reg == st, k
    if len(got) == 1:
        _ts_check(obs.flight_recorder().spans(), got)
        # the TTFT histogram holds last_ttft_s's values
        ttft = obs.get_registry().get("serving.ttft_seconds")
        assert sorted(v for s in ttft.series() for v in s._raw) == \
            sorted(t for t in port.last_ttft_s if t is not None)
    cold = _registry(obs, timed=True)["serve.cold_start_seconds"]
    assert list(cold) == [(("mode", "cold"),)]
    assert 0 < next(iter(cold.values())) < 600
    if cfg == "spec":
        assert port.stats["spec_accepted"] > 0
    if cfg == "chunked":
        assert port.stats["chunked_requests"] > 0
    if cfg == "greedy_prefix":
        assert port.stats["prefix_partial_hits"] > 0
    if cfg == "front_end":
        st = got[0][1]
        assert {"shed", "deadline", "cancelled",
                "rejected_over_max_seq_len"} <= set(st)


def test_watchdog_trip_dumps_the_wedged_requests_spans(tmp_path):
    _arm("decode_wedge:sleep=5")
    ref, port = _predictors(decode_watchdog_s=0.25)
    prompts = _prompts(7, (5, 9, 12))
    assert port.generate(prompts, max_new_tokens=8) == \
        ref.generate(prompts, max_new_tokens=8)
    assert port.last_status == ["watchdog"] * 3
    assert _registry(obs) == _registry(ref_obs)
    assert _spans(obs) == _spans(ref_obs)
    dumps = {}
    for name, o in (("port", obs), ("ref", ref_obs)):
        p = o.flight_recorder().last_dump
        assert p == str(tmp_path / name / f"flight_{os.getpid()}.json")
        with open(p) as f:
            dumps[name] = json.load(f)
    d = dumps["port"]
    assert d["reason"] == dumps["ref"]["reason"] == "decode_wedged"
    wedged = [s for s in d["spans"] if s["name"] == "serve.request"
              and s["status"] == "watchdog"]
    # the two slots' requests and the queued one
    assert sorted(s["events"][-1]["stage"] for s in wedged) == \
        ["decoding", "decoding", "queued"]
    assert all(s["events"][-1]["name"] == "watchdog" for s in wedged)
    gen = [s for s in d["spans"] if s["name"] == "serve.generate"]
    assert gen[-1]["status"] == "watchdog"
    assert d["fault_events"] == dumps["ref"]["fault_events"]
    assert d["metrics"]["robustness.watchdog_trips"][0]["value"] == 1.0
    assert obs.counter("robustness.faults_injected").value(
        site="decode_wedge", mode="sleep") == 1.0


def test_serve_stream_requests_join_their_trace_context():
    ref, port = _predictors()
    prompts = _prompts(10, (5, 9, 12, 7))
    got = {}
    for name, cb, o, cls in (("port", port, obs, ServeRequest),
                             ("ref", ref, ref_obs, RefServeRequest)):
        ctx = o.TraceContext("a" * 16, "b" * 16, {"tier": "gold"})
        reqs = [cls(p, 3, None, None, r, None,
                    ctx if r % 2 == 0 else None)
                for r, p in enumerate(prompts)]
        it = iter([reqs[:2], reqs[2:], None])
        st = cb.serve_stream(lambda: next(it))
        evs = list(st)
        got[name] = ([(e.request, e.kind, e.token, e.meta) for e in evs],
                     _spans(o))
        spans = o.flight_recorder().spans()
        rq = sorted((s for s in spans if s["name"] == "serve.request"),
                    key=lambda s: s["labels"]["idx"])
        assert [s["trace"] == "a" * 16 for s in rq] == [True, False] * 2
        assert [s["parent"] == "b" * 16 for s in rq] == [True, False] * 2
        if o is obs:
            _ts_check(spans, [(evs, 0)])
    assert got["port"] == got["ref"]


def test_disabled_telemetry_serves_the_same_tokens():
    """With telemetry off nothing is recorded, the tokens are the same and
    stream events take the wall clock."""
    _, port = _predictors()
    prompts = _prompts(2, (9, 4, 13))
    want = port.generate(prompts, max_new_tokens=6)
    obs.get_registry().reset()
    obs.flight_recorder().clear()
    with obs.scoped(False):
        _, port = _predictors()
        st = port.generate_stream(prompts, max_new_tokens=6)
        evs = list(st)
    assert st.results == want and port.last_status == ["ok"] * 3
    assert _registry(obs) == {}
    assert obs.flight_recorder().spans() == []
    assert all(e.ts > 0 for e in evs)


# ------------------------------------------------------------------- aot --

AOT_GEO = dict(max_batch_size=2, page_size=8, max_seq_len=64,
               enable_prefix_cache=False)


def test_aot_series_and_spans_build_and_warm_start(tmp_path):
    from paddle_tpu.inference import aot as ref_aot
    ref, port = _pair(tensor_parallel=False)
    kw = dict(prompt_buckets=(8, 16), batch_sizes=(1, 2), **AOT_GEO)
    ref_aot.build_engine(ref, str(tmp_path / "ref"), **kw)
    path = str(tmp_path / "port")
    aot.build_engine(port, path, wire_cache=False, **kw)
    builds = {}
    for name, o in (("port", obs), ("ref", ref_obs)):
        spans = o.flight_recorder().spans()
        b = [s for s in spans if s["name"] == "aot.build"]
        assert len(b) == 1
        kinds = collections.Counter(
            s["labels"]["kind"] for s in spans
            if s["name"] == "aot.build_program")
        builds[name] = ([(e["name"], {k: v for k, v in e.items()
                                      if k not in ("ts", "name")})
                         for e in b[0]["events"]], kinds,
                        b[0]["labels"]["artifacts"],
                        sorted(b[0]["labels"]))
        reg = _registry(o)
        assert list(reg["aot.build_seconds"]) == [()]
        assert "aot.bucket_misses" not in reg
        assert "serve.cold_start_seconds" not in reg
    assert builds["port"] == builds["ref"]

    obs.get_registry().reset()
    obs.flight_recorder().clear()
    aot.reset_counters()
    pred, eng = aot.warm_start(port, path, wire_cache=False)
    pred.generate(_prompts(3, (8, 12)), max_new_tokens=3)
    reg = _registry(obs, timed=True)
    hits = {dict(k)["kind"]: v for k, v in reg["aot.bundle_hits"].items()}
    assert hits == dict(aot.counters["bundle_hits"]) and hits["decode"] > 0
    assert list(reg["serve.cold_start_seconds"]) == [(("mode", "warm"),)]
    load = [s for s in obs.flight_recorder().spans()
            if s["name"] == "aot.load"]
    assert len(load) == 1 and load[0]["labels"]["path"] == path
    with open(os.path.join(path, "manifest.json")) as f:
        assert load[0]["labels"]["artifacts"] == len(
            json.load(f)["artifacts"])
    # a bucket miss: one counted miss, one compile_fallback span whose
    # write-back is an event
    pred.generate(_prompts(4, (32,)), max_new_tokens=2)
    miss = obs.counter("aot.bucket_misses")
    assert miss.value(kind="prefill") == 1 == \
        aot.counters["bucket_misses"]["prefill"]
    fb = [s for s in obs.flight_recorder().spans()
          if s["name"] == "aot.compile_fallback"]
    assert [s["labels"]["kind"] for s in fb] == ["prefill"]
    assert fb[0]["status"] == "ok"
    assert [e["name"] for e in fb[0]["events"]] == ["write_back"]
    # an invalidation by reason and tier
    aot.warm_start(port, path, wire_cache=False, page_size=16)
    inv = obs.counter("aot.invalidations")
    assert inv.value(reason="geometry", tier="bundle") == 1 == \
        aot.counters["invalidations"]["geometry"]


# --------------------------------------------------------------- trainer --

class _NanAt:
    """Wraps a train step: the loss it returns at call ``n`` (1-based) is
    NaN (the port's stand-in for the reference's ``nan_loss`` fault,
    which replaces the same step's loss at the guard)."""

    def __init__(self, step, n):
        self._step, self._n, self._i = step, n, 0

    def __call__(self, *batch):
        self._i += 1
        loss = self._step(*batch)
        return loss * float("nan") if self._i == self._n else loss


def test_trainer_spans_and_gauges_match_reference(tmp_path, monkeypatch):
    """4 steps with a NaN loss at step 3: the same train.* spans (step,
    data, dispatch, loss_sync, anomaly_skip), ``train.loss``,
    ``robustness.goodput`` and ``robustness.anomalies_skipped``, one
    JSONL snapshot per step, and the same heartbeat lines."""
    from paddle_tpu.models import LlamaConfig as RefConfig
    from paddle_tpu.models import LlamaForCausalLM as RefLlama
    from paddle_tpu.models import LlamaPretrainingCriterion as RefCrit
    from paddle_tpu.trainer import Trainer as RefTrainer
    from paddle_tpu.trainer import TrainingArguments as RefArgs
    from paddle_tpu_torch.convert import load_reference_state_dict
    from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLM,
                                         LlamaPretrainingCriterion)
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.trainer import Trainer, TrainingArguments

    paddle.seed(0)
    ref = RefLlama(RefConfig.tiny())
    sd = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    monkeypatch.setenv("PADDLE_RANK_HEARTBEAT_INTERVAL", "1e-9")
    monkeypatch.setenv("RANK", "0")

    monkeypatch.setenv("PADDLE_RANK_HEARTBEAT", str(tmp_path / "hb_ref"))
    ref_obs.configure(str(tmp_path / "ref_tel.jsonl"))
    crit = RefCrit()
    ropt = paddle.optimizer.AdamW(
        parameters=ref.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0), **OPT)
    _arm("nan_loss:step=2")           # the reference's 0-based step 2
    want = RefTrainer(ref, ropt, lambda lg, lb: crit(lg, lb),
                      RefArgs(output_dir=str(tmp_path / "ref"), max_steps=4,
                              logging_steps=1, save_steps=100),
                      _ref_data).train()
    _arm("")
    ref_obs.configure(None)

    monkeypatch.setenv("PADDLE_RANK_HEARTBEAT", str(tmp_path / "hb_port"))
    obs.configure(str(tmp_path / "port_tel.jsonl"))
    port = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    load_reference_state_dict(port, sd)
    pcrit = LlamaPretrainingCriterion()
    opt = AdamW(parameters=port.parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0), **OPT)
    tr = Trainer(port, opt, lambda lg, lb: pcrit(lg, lb),
                 TrainingArguments(output_dir=str(tmp_path / "port"),
                                   max_steps=4, logging_steps=1,
                                   save_steps=100), _data)
    tr._step_obj = _NanAt(tr._step_obj, 3)
    got = tr.train()
    obs.configure(None)

    assert got["anomalous_steps"] == want["anomalous_steps"] == 1
    names = ("train.",)
    assert _spans(obs, names) == _spans(ref_obs, names)
    sp = _spans(obs, names)
    assert [s["name"] for s in sp].count("train.step") == 4
    assert [s for s in sp if s["name"] == "train.anomaly_skip"][0][
        "labels"] == {"step": 3, "reason": "nonfinite", "consecutive": 1}
    for name in ("robustness.anomalies_skipped", "robustness.goodput"):
        assert _registry(obs)[name] == _registry(ref_obs)[name]
    assert obs.counter("robustness.anomalies_skipped").value(
        reason="nonfinite") == 1
    np.testing.assert_allclose(obs.gauge("train.loss").value(),
                               ref_obs.gauge("train.loss").value(),
                               rtol=1e-5)
    steps = {}
    for name in ("port", "ref"):
        with open(tmp_path / f"{name}_tel.jsonl") as f:
            recs = [json.loads(x) for x in f]
        steps[name] = sorted({r["step"] for r in recs
                              if r.get("name") == "train.loss"})
    assert steps["port"] == steps["ref"] == [1, 2, 3, 4]
    beats = {}
    for name in ("port", "ref"):
        with open(tmp_path / f"hb_{name}") as f:
            beats[name] = [{k: v for k, v in json.loads(x).items()
                            if k != "ts"} for x in f]
    assert beats["port"] == beats["ref"]
    assert [b["phase"] for b in beats["port"]] == \
        ["init", "resumed"] + ["step"] * 4
