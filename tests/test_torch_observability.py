"""``paddle_tpu_torch.observability`` against ``paddle_tpu.observability``.

The same operations, drawn from a numpy seed, go to both packages'
registries, exporters, tracers, SLO engines and critical-path folds;
what comes out must be equal (timestamps, span ids and the process
identity aside): registry snapshots, quantiles and exemplars past the
reservoir cap, the Prometheus text, the JSONL records, the TensorBoard
scalars (both files framed as the reference's writer frames them), span
trees with their event caps, ``TraceContext`` dicts crossing between the
packages, flight-dump files, Chrome traces, SLO decisions and stage
decompositions. Also the port's disabled mode and its ``jit_callback``
on the CPU.
"""
import json
import os
import struct

import numpy as np
import pytest
import torch

import paddle_tpu.observability as ref_obs
from paddle_tpu.observability import metrics as ref_metrics
from paddle_tpu.observability import tracing as ref_tracing
from paddle_tpu.utils.tbwriter import _masked_crc

import paddle_tpu_torch.observability as obs
from paddle_tpu_torch.observability import metrics as port_metrics
from paddle_tpu_torch.observability import runtime as port_runtime
from paddle_tpu_torch.observability import tracing as port_tracing

BOTH = (("port", obs), ("ref", ref_obs))


@pytest.fixture(autouse=True)
def _clean():
    """Both packages start with no sink, an empty flight ring, telemetry
    on, and end the same way (each package has its own globals)."""
    for o in (obs, ref_obs):
        o.configure(None)
        o.enabled(True)
        o.flight_recorder().clear()
    yield
    for o in (obs, ref_obs):
        o.configure(None)
        o.enabled(True)
        o.flight_recorder().clear()
        o.set_flight_dir(None)


def _ops(seed, n_hist=5000):
    """A recording script: (kind, name, args, labels) tuples."""
    rng = np.random.RandomState(seed)
    ops = []
    for _ in range(40):
        ops.append(("counter", "t.calls", float(rng.randint(1, 4)),
                    {"op": ["all_reduce", "all_gather"][rng.randint(2)],
                     "axis": ["data", "model"][rng.randint(2)]}))
        ops.append(("gauge", "t.depth", float(rng.randint(0, 9)),
                    {"tier": ["a", "b", "c"][rng.randint(3)]}))
    for i, v in enumerate(rng.lognormal(-5.0, 1.5, n_hist)):
        ops.append(("hist", "t.lat", float(v),
                    {"replica": ["r0", "r1"][i % 2]},
                    f"trace{i:05d}" if i % 7 == 0 else None))
    ops.append(("counter", "t.empty", 0.0, {}))
    return ops


def _record(o, reg, ops):
    c = reg.counter("t.calls", help="collective calls")
    g = reg.gauge("t.depth")
    h = reg.histogram("t.lat", help="latency", unit="s")
    reg.counter("t.empty").inc(0.0)
    for op in ops:
        kind, _, v, lbl = op[:4]
        if kind == "counter" and op[1] == "t.calls":
            c.inc(v, **lbl)
        elif kind == "gauge":
            g.set(v, **lbl)
        elif kind == "hist":
            h.observe(v, exemplar=op[4], **lbl)
    return reg


def _pair_registries(seed=0):
    ops = _ops(seed)
    return (_record(obs, obs.MetricRegistry(), ops),
            _record(ref_obs, ref_obs.MetricRegistry(), ops))


# ------------------------------------------------------------- registry --

def test_registry_snapshot_quantiles_exemplars_equal():
    port, ref = _pair_registries(0)
    assert port.snapshot() == ref.snapshot()
    ph, rh = port.get("t.lat"), ref.get("t.lat")
    for lbl in ({"replica": "r0"}, {"replica": "r1"}):
        # 2500 observations a series: past the 2048-sample reservoir
        assert len(ph.labels(**lbl)._raw) < 2500
        for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
            assert ph.quantile(q, **lbl) == rh.quantile(q, **lbl)
        assert ph.exemplars(**lbl) == rh.exemplars(**lbl)
        assert len(ph.exemplars(**lbl)) == port_metrics._EXEMPLAR_CAP
    assert ph.exemplars() == rh.exemplars()
    assert port_metrics._RAW_CAP == ref_metrics._RAW_CAP == 2048
    assert obs.DEFAULT_BUCKETS == ref_obs.DEFAULT_BUCKETS
    # reading never creates a series; a kind clash raises in both
    for reg in (port, ref):
        assert reg.get("t.calls").value(op="none") == 0.0
        with pytest.raises(ValueError):
            reg.gauge("t.calls")
    assert port.snapshot() == ref.snapshot()
    port.reset()
    ref.reset()
    assert port.snapshot() == ref.snapshot() == {}


def test_disabled_and_scoped_record_nothing():
    reg = obs.MetricRegistry()
    c, h = reg.counter("x.c"), reg.histogram("x.h")
    with obs.scoped(False):
        assert not obs.enabled()
        c.inc(5, a="1")
        h.observe(1.0)
        reg.gauge("x.g").set(3.0)
        assert obs.span("x.s") is obs.NULL_SPAN
        assert obs.start_span("x.s") is obs.NULL_SPAN
        called = []
        obs.jit_callback(lambda *v: called.append(v), torch.ones(2))
        assert called == []
    assert obs.enabled()
    assert reg.snapshot() == {}
    obs.enabled(False)
    c.inc(1)
    obs.enabled(True)
    assert reg.snapshot() == {}
    assert obs.flight_recorder().spans() == []


def test_switch_reads_the_reference_environment_variable():
    import subprocess
    import sys
    code = ("import paddle_tpu_torch.observability as o; "
            "print(o.enabled())")
    for val, want in (("0", "False"), ("off", "False"), ("1", "True")):
        env = dict(os.environ, PADDLE_TPU_TELEMETRY=val)
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, check=True,
                             timeout=120)
        assert out.stdout.strip() == want


# ------------------------------------------------------------ exporters --

@pytest.mark.parametrize("const", [None, {"rank": 2, "topology":
                                          'data=4,"model"=2\n'}])
def test_prometheus_text_equal(const):
    port, ref = _pair_registries(1)
    kw = {} if const is None else {"const_labels": const}
    text = obs.PrometheusExporter(port, **kw).render()
    assert text == ref_obs.PrometheusExporter(ref, **kw).render()
    assert "# TYPE t_lat histogram" in text and 't_lat_bucket{' in text


def _jsonl(path):
    with open(path) as f:
        return [json.loads(x) for x in f if x.strip()]


def test_jsonl_records_equal_and_rotation(tmp_path):
    port, ref = _pair_registries(2)
    recs = {}
    for name, o, reg in (("port", obs, port), ("ref", ref_obs, ref)):
        p = str(tmp_path / name / "t.jsonl")
        with o.JsonlExporter(p, registry=reg, identity={}) as e:
            e.export(step=3, extra={"run": "a"})
            e.write_record({"kind": "meta", "k": 1})
        recs[name] = [{k: v for k, v in r.items() if k != "ts"}
                      for r in _jsonl(p)]
    assert recs["port"] == recs["ref"]
    assert len(recs["port"]) > 5
    # rotation on whole lines at max_bytes: the same files in both
    sizes = {}
    for name, o, reg in (("port", obs, port), ("ref", ref_obs, ref)):
        p = str(tmp_path / name / "rot.jsonl")
        e = o.JsonlExporter(p, registry=reg, max_bytes=2000, identity={})
        for s in range(4):
            e.export(step=s)
        e.close()
        e.close()                       # idempotent
        e.export(step=9)                # no-op once closed
        sizes[name] = (os.path.exists(p + ".1"), len(_jsonl(p)),
                       len(_jsonl(p + ".1")))
    assert sizes["port"] == sizes["ref"] and sizes["port"][0]


def test_process_sink_and_identity(tmp_path, monkeypatch):
    """configure + maybe_export every N + span lines in the same file;
    under a launcher's rank environment every line carries the identity."""
    out = {}
    for name, o in BOTH:
        monkeypatch.setenv("PADDLE_TRAINER_ID", "3")
        monkeypatch.setenv("PADDLE_TRAINERS_NUM", "4")
        rt = port_runtime if o is obs else ref_obs.runtime
        monkeypatch.setattr(rt, "_identity", None)
        p = str(tmp_path / name / "tel.jsonl")
        o.configure(p, every=2)
        assert o.telemetry_path() == p
        o.counter("sink.c").inc(2, k="v")
        for s in range(1, 5):
            o.maybe_export(step=s)
        with o.span("sink.span", parent=None, k=1) as sp:
            sp.event("e", i=1)
        o.configure(None)
        out[name] = [{k: v for k, v in r.items()
                      if k not in ("ts", "trace", "span", "start", "dur")}
                     for r in _jsonl(p)
                     if r.get("name") in ("sink.c", "sink.span")]
        for r in out[name]:
            for e in r.get("events", ()):
                e.pop("ts")
        monkeypatch.setattr(rt, "_identity", None)
    assert out["port"] == out["ref"]
    assert [r.get("step") for r in out["port"]] == [2, 4, None]
    assert all(r["rank"] == 3 and r["world_size"] == 4 for r in out["port"])
    for o in (obs, ref_obs):
        o.counter("sink.c").reset()


def _tb_scalars(logdir):
    """(tag, value, step) of every scalar event in ``logdir``'s event
    file, the TFRecord framing checked with the reference writer's
    masked CRC."""
    files = [f for f in os.listdir(logdir) if "tfevents" in f]
    assert len(files) == 1
    raw = open(os.path.join(logdir, files[0]), "rb").read()
    out, off = [], 0

    def varint(b, i):
        n = s = 0
        while True:
            x = b[i]
            n |= (x & 0x7F) << s
            i += 1
            s += 7
            if not x & 0x80:
                return n, i

    def fields(b):
        i = 0
        while i < len(b):
            key, i = varint(b, i)
            f, w = key >> 3, key & 7
            if w == 0:
                v, i = varint(b, i)
            elif w == 1:
                v, i = b[i:i + 8], i + 8
            elif w == 5:
                v, i = b[i:i + 4], i + 4
            else:
                n, i = varint(b, i)
                v, i = b[i:i + n], i + n
            yield f, v

    while off < len(raw):
        (ln,) = struct.unpack("<Q", raw[off:off + 8])
        (crc_len,) = struct.unpack("<I", raw[off + 8:off + 12])
        assert crc_len == _masked_crc(raw[off:off + 8])
        payload = raw[off + 12:off + 12 + ln]
        (crc_data,) = struct.unpack("<I", raw[off + 12 + ln:off + 16 + ln])
        assert crc_data == _masked_crc(payload)
        off += 16 + ln
        ev = dict(fields(payload))
        if 5 not in ev:                  # file_version record
            continue
        step = ev.get(2, 0)
        for f, val in fields(ev[5]):
            vals = dict(fields(val))
            out.append((vals[1].decode(),
                        struct.unpack("<f", vals[2])[0], step))
    return out


def test_tensorboard_scalars_equal(tmp_path):
    port, ref = _pair_registries(3)
    got = {}
    for name, o, reg in (("port", obs, port), ("ref", ref_obs, ref)):
        d = str(tmp_path / name)
        with o.TensorBoardExporter(d, registry=reg) as e:
            e.export(step=7)
            e.flush()
        got[name] = _tb_scalars(d)
    assert got["port"] == got["ref"]
    tags = {t for t, _, _ in got["port"]}
    assert "t.lat/replica=r0/p99" in tags and len(got["port"]) > 10


# -------------------------------------------------------------- tracing --

def _span_script(o, n_events):
    """The same span tree in either package: a root with nested context
    spans, an explicit span parented on the root, an event cap overflow,
    an exception, and one span left open."""
    with o.span("t.root", parent=None, job="x") as root:
        with o.span("t.child", step=1) as ch:
            ch.event("a", k=1)
            with o.span("t.grand"):
                pass
        sp = o.start_span("t.explicit", parent=root, req="r1")
        for i in range(n_events):
            sp.event("tick", i=i)
        sp.set_label(extra="y")
        sp.end(status="ok", done=True)
        sp.end(status="late")              # idempotent
        try:
            with o.span("t.fails"):
                raise KeyError("boom")
        except KeyError:
            pass
        ctx = root.context(tier="gold")
    o.start_span("t.remote", parent=ctx, side="b").end()
    return o.start_span("t.open", parent=None, k=2)


def _shape(spans):
    """Span dicts with ids replaced by positions and times dropped."""
    idx = {s["span"]: i for i, s in enumerate(spans)}
    traces = {}
    out = []
    for s in spans:
        d = {k: v for k, v in s.items()
             if k not in ("ts", "start", "dur", "span", "trace", "parent")}
        d["parent"] = idx.get(s["parent"], s["parent"] and "?")
        d["trace"] = traces.setdefault(s["trace"], len(traces))
        d["events"] = [{k: v for k, v in e.items() if k != "ts"}
                       for e in s["events"]]
        out.append(d)
    return out


def test_span_trees_and_event_caps_equal():
    n = port_tracing._MAX_EVENTS + 10
    assert port_tracing._MAX_EVENTS == ref_tracing._MAX_EVENTS == 256
    got = {}
    for name, o in BOTH:
        _span_script(o, n)
        got[name] = (_shape(o.flight_recorder().spans()),
                     _shape(o.flight_recorder().open_spans()))
    assert got["port"] == got["ref"]
    spans = got["port"][0]
    exp = next(s for s in spans if s["name"] == "t.explicit")
    assert len(exp["events"]) == 256 and exp["dropped_events"] == 10
    assert exp["labels"] == {"req": "r1", "extra": "y", "done": True}
    fails = next(s for s in spans if s["name"] == "t.fails")
    assert fails["status"] == "error:KeyError"
    assert got["port"][1][0]["open"] is True


def test_trace_context_round_trips_between_packages():
    for src, dst in ((obs, ref_obs), (ref_obs, obs)):
        with src.span("x.send", parent=None) as sp:
            d = sp.context(tier="gold").to_dict()
        ctx = dst.TraceContext.from_dict(json.loads(json.dumps(d)))
        assert ctx.to_dict() == d
        child = dst.start_span("x.recv", parent=ctx)
        child.end()
        assert (child.trace_id, child.parent_id) == (sp.trace_id,
                                                     sp.span_id)
        assert ctx.baggage == {"tier": "gold"}
    assert obs.TraceContext.from_dict(None) is None
    assert obs.TraceContext.from_dict({"trace": "a"}) is None


def test_flight_dumps_have_the_same_shape(tmp_path):
    dumps = {}
    for name, o in BOTH:
        o.set_flight_dir(str(tmp_path / name))
        _span_script(o, 3)
        o.counter("t.flight").inc(k="v")
        p = o.flight_dump(reason="test", extra={"why": 1})
        assert p == os.path.join(str(tmp_path / name),
                                 f"flight_{os.getpid()}.json")
        with open(p) as f:
            d = json.load(f)
        dumps[name] = d
        o.flight_recorder().clear()
        assert o.flight_dump(reason="empty") is None
        o.counter("t.flight").reset()
    a, b = dumps["port"], dumps["ref"]
    assert sorted(a) == sorted(b)
    assert _shape(a["spans"]) == _shape(b["spans"])
    assert _shape(a["open_spans"]) == _shape(b["open_spans"])
    for k in ("reason", "capacity", "extra", "pid"):
        assert a[k] == b[k]
    assert a["metrics"]["t.flight"] == b["metrics"]["t.flight"]


def test_chrome_trace_equal(tmp_path):
    for name, o in BOTH:
        _span_script(o, 4)
    ref_spans = ref_obs.flight_recorder().spans()
    assert obs.to_chrome_trace(ref_spans) == ref_obs.to_chrome_trace(
        ref_spans)
    p = obs.write_chrome_trace(str(tmp_path / "t.json"), ref_spans)
    with open(p) as f:
        assert json.load(f) == ref_obs.to_chrome_trace(ref_spans)
    # default: the flight ring, finished and open
    d = obs.to_chrome_trace(obs.flight_recorder().spans()
                            + obs.flight_recorder().open_spans())
    assert d["traceEvents"][-1]["args"]["open"] is True


def test_traced_decorator():
    for name, o in BOTH:
        @o.traced
        def f(x):
            return o.current_span().name

        @o.traced("t.named", k=1)
        def g():
            return o.current_span().labels

        assert f(1).endswith("f") and g() == {"k": 1}
        assert o.current_span() is None


# ---------------------------------------------------------- slo, critpath --

def _slo_script(o, seed):
    rng = np.random.RandomState(seed)
    reg = o.MetricRegistry()
    t = [1000.0]
    eng = o.SLOEngine(o.default_serving_slos(ttft_target_s=0.25,
                                             inter_token_target_s=0.05,
                                             objective=0.9),
                      registry=reg, fast_window_s=30, slow_window_s=120,
                      now_fn=lambda: t[0])
    outs = []
    for tick in range(40):
        bad = tick in range(12, 22)
        for _ in range(rng.randint(1, 6)):
            reg.histogram("serving.ttft_seconds").observe(
                0.5 if bad and rng.rand() < 0.7 else 0.1)
            reg.histogram("serving.token_latency_seconds").observe(
                float(rng.choice([0.01, 0.025, 0.1])))
            reg.counter("serving.router.completed").inc(
                status="ok" if rng.rand() > (0.4 if bad else 0.02)
                else "error")
        if tick == 30:
            reg.reset()                   # re-baselines, credits nothing
        t[0] += 5.0
        outs.append(eng.evaluate())
    ew = o.Ewma(half_life_s=10.0)
    ews = [ew.update(v, now=float(i)) for i, v in enumerate(range(8))]
    return outs, reg.snapshot(), ews, [eng.burn(s.name) for s in eng.specs]


def test_slo_engine_decisions_equal():
    got = _slo_script(obs, 4)
    want = _slo_script(ref_obs, 4)
    assert got == want
    outs = got[0]
    assert any(o["ttft"]["new_breach"] for o in outs)
    assert any(o["completion_ok"]["breaching"] for o in outs)


def _synthetic_trace(rng, with_router):
    t0 = 1000.0 + rng.rand()
    spans = []
    if with_router:
        spans.append({"name": "router.request", "trace": "T", "span": "r",
                      "parent": None, "start": t0, "dur": 2.0,
                      "status": "ok",
                      "events": [{"name": "routed", "ts": t0 + 0.01},
                                 {"name": "first_token", "ts": t0 + 0.4},
                                 {"name": "handoff", "ts": t0 + 0.45},
                                 {"name": "handoff_import_start",
                                  "ts": t0 + 0.5},
                                 {"name": "handoff_imported",
                                  "ts": t0 + 0.55},
                                 {"name": "finish", "ts": t0 + 1.9}]})
    parent = "r" if with_router else None
    ev = [{"name": "queued", "ts": t0 + 0.02},
          {"name": "prefill", "ts": t0 + 0.1},
          {"name": "admitted", "ts": t0 + 0.11},
          {"name": "first_token", "ts": t0 + 0.38}]
    ev += [{"name": "token", "ts": t0 + 0.4 + 0.05 * i} for i in range(5)]
    ev += [{"name": "spec", "ts": t0 + 0.7, "accepted": 2},
           {"name": "finish", "ts": t0 + 1.2}]
    spans.append({"name": "serve.request", "trace": "T", "span": "s1",
                  "parent": parent, "start": t0 + 0.02, "dur": 1.3,
                  "status": "ok", "events": ev})
    if with_router:
        spans.append({"name": "serve.request", "trace": "T", "span": "s2",
                      "parent": "r", "start": t0 + 0.5, "dur": 1.3,
                      "events": [{"name": "admitted", "ts": t0 + 0.6},
                                 {"name": "token", "ts": t0 + 0.7},
                                 {"name": "finish", "ts": t0 + 1.8}]})
    spans.append({"name": "orphan", "trace": "T", "span": "o",
                  "parent": "missing", "start": t0, "dur": 0.1})
    spans.append({"name": "other", "trace": "U", "span": "u",
                  "parent": None, "start": t0, "dur": 0.1})
    return spans


@pytest.mark.parametrize("router", [False, True])
def test_stage_decomposition_equal(router):
    rng = np.random.RandomState(5)
    spans = _synthetic_trace(rng, router)
    got = obs.stage_decomposition(spans, trace_id="T")
    assert got == ref_obs.stage_decomposition(spans, trace_id="T")
    assert obs.trace_tree(spans, "T") == ref_obs.trace_tree(spans, "T")
    assert abs(sum(v for _, v in got["stages"]) - got["e2e"]) < 1e-9
    assert got["aux"]["orphans"] == 1
    empty = obs.stage_decomposition([], trace_id="none")
    assert empty == ref_obs.stage_decomposition([], trace_id="none")


# ------------------------------------------------------------- runtime --

def test_jit_callback_on_the_cpu():
    seen = []
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    obs.jit_callback(lambda a, b: seen.append((a, b)), x, torch.tensor(3))
    assert len(seen) == 1                  # at once on the CPU
    assert isinstance(seen[0][0], np.ndarray)
    np.testing.assert_array_equal(seen[0][0], x.numpy())
    assert int(seen[0][1]) == 3

    def boom(_):
        raise ValueError("never propagates")
    obs.jit_callback(boom, x)              # swallowed
    obs.enabled(False)
    obs.jit_callback(lambda _: seen.append("off"), x)
    obs.enabled(True)
    assert len(seen) == 1


def test_device_memory_stats_on_the_cpu():
    keep = torch.empty(1 << 20, dtype=torch.uint8)
    st = obs.device_memory_stats("cpu")
    assert set(st) == set(ref_obs.device_memory_stats())
    assert st["source"] == "live_tensors"
    assert st["bytes_in_use"] >= keep.numel()
    assert st["peak_bytes_in_use"] == st["bytes_in_use"]


def test_rank_heartbeat_lines_equal(tmp_path):
    recs = {}
    for name, o in BOTH:
        p = str(tmp_path / name / "hb.jsonl")
        hb = o.RankHeartbeat(p, interval=3600.0)
        assert hb.due()
        assert hb.beat(phase="init", rank="0")
        assert not hb.due() and not hb.beat(phase="step", step=1)
        assert hb.beat(force=True, phase="step", step=2, rank="0")
        hb.close()
        recs[name] = [{k: v for k, v in r.items() if k != "ts"}
                      for r in _jsonl(p)]
        off = o.RankHeartbeat(str(tmp_path / name / "off.jsonl"),
                              interval=0)
        assert not off.beat(force=True)
    assert recs["port"] == recs["ref"]
    assert [r["phase"] for r in recs["port"]] == ["init", "step"]
