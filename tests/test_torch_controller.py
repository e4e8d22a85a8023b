"""The port's ``PoolController`` and autoscale signals against the JAX
reference's.

The reference's controller scenarios (``tests/test_slo_controller.py``:
its ``StubRouter``, ``FakeEngine`` and ``Clock``, host-side stand-ins
for a pool, an SLO engine and a clock) are driven through both packages
step by step; the decision records (every field but the wall-clock
``ts``) and the stub pools' end states must be equal. A disaggregated
stub pool (prefill and decode fleets, a role-aware spawn factory)
covers the per-role scale-out and scale-in rules. ``autoscale_signals``
on the same registry contents, with and without a router and with one
EWMA smoother held across calls, must give equal dicts (``ts`` aside).
Exact equality throughout.
"""
import pytest

import paddle_tpu.observability as ref_obs
from paddle_tpu.observability import metrics as ref_metrics
from paddle_tpu.observability import slo as ref_slo
from paddle_tpu.serving import autoscale as ref_autoscale
from paddle_tpu.serving import controller as ref_controller

import paddle_tpu_torch.observability as obs
from paddle_tpu_torch.observability import metrics as port_metrics
from paddle_tpu_torch.observability import slo as port_slo
from paddle_tpu_torch.serving import autoscale as port_autoscale
from paddle_tpu_torch.serving import controller as port_controller

from test_slo_controller import (Clock, FakeEngine, StubPredictor,
                                 StubReplica, StubRouter,
                                 _load_trace_replay)

PKGS = {"ref": (ref_controller, ref_slo, ref_metrics, ref_autoscale),
        "port": (port_controller, port_slo, port_metrics, port_autoscale)}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """Each package's process registry, which ``autoscale_signals`` and
    the controller's tick read, is a fresh one for the test: a serve loop
    another test left behind records into the old one."""
    for o in (obs, ref_obs):
        o.configure(None)
        o.enabled(True)
    for m in (port_metrics, ref_metrics):
        monkeypatch.setattr(m, "_default_registry", m.MetricRegistry())


def _ctl(pkg, router, engine, clk, spawn=None, **cfg):
    ctl_mod, slo, metrics, _ = PKGS[pkg]
    cfg.setdefault("scale_out_cooldown_s", 1.0)
    cfg.setdefault("scale_in_cooldown_s", 0.0)
    cfg.setdefault("shift_cooldown_s", 1.0)
    ctl = ctl_mod.PoolController(
        router, slo_engine=engine, spawn=spawn,
        config=ctl_mod.ControllerConfig(**cfg),
        registry=metrics.MetricRegistry(), now_fn=clk)
    # the demand EWMA on the scenario's clock too (the controller builds
    # it on the wall clock): the records then depend on the scenario alone
    ctl._demand_ewma = slo.Ewma(half_life_s=engine.fast_window_s / 4.0,
                                now_fn=clk)
    return ctl


def _strip(records):
    return [{k: v for k, v in r.items() if k != "ts"} for r in records]


# each scenario: (pkg) -> (decision records, end state of the stub pool)
def _scale_out(pkg):
    router, eng, clk = StubRouter(n=1), FakeEngine(), Clock(0.0)
    eng.set_burn("ttft", 2.0)
    spawned = []

    def spawn():
        spawned.append(StubPredictor(f"spare{len(spawned)}"))
        return spawned[-1]

    ctl = _ctl(pkg, router, eng, clk, spawn=spawn)
    out = [ctl.tick()]
    for dt in (0.5, 1.0):
        clk.advance(dt)
        out.append(ctl.tick())
    return ctl, router, out


def _max_replicas(pkg):
    router, eng = StubRouter(n=1), FakeEngine()
    eng.set_burn("ttft", 5.0)
    ctl = _ctl(pkg, router, eng, Clock(0.0),
               spawn=lambda: StubPredictor("x"), max_replicas=1)
    return ctl, router, [ctl.tick()]


def _scale_in_then_revive(pkg):
    router, eng, clk = StubRouter(n=2), FakeEngine(), Clock(0.0)
    ctl = _ctl(pkg, router, eng, clk, scale_in_quiet_ticks=3)
    out = []
    for _ in range(3):
        out.append(ctl.tick())
        clk.advance(1.0)
    eng.set_burn("ttft", 2.0)
    out.append(ctl.tick())
    return ctl, router, out


def _shift_quantum(pkg):
    spec_cls = PKGS[pkg][1].SLOSpec
    router = StubRouter(n=1, tier_weights={"gold": 1.0, "bulk": 1.0})
    eng = FakeEngine(specs=[spec_cls("ttft_gold", "m", tier="gold")])
    eng.set_burn("ttft", 0.0)
    eng.set_burn("ttft_gold", 2.0, tier="gold")
    clk = Clock(0.0)
    ctl = _ctl(pkg, router, eng, clk, weight_shift_factor=2.0,
               max_weight_factor=4.0)
    out = [ctl.tick()]
    for dt in (0.5, 1.0, 1.5):
        clk.advance(dt)
        out.append(ctl.tick())
    eng.set_burn("ttft_gold", 0.0, tier="gold")
    clk.advance(1.5)
    out.append(ctl.tick())
    return ctl, router, out


def _shed(pkg):
    spec_cls = PKGS[pkg][1].SLOSpec
    router = StubRouter(n=1, tier_weights={"gold": 1.0, "bulk": 0.5})
    eng = FakeEngine(specs=[spec_cls("ttft_gold", "m", tier="gold")])
    eng.set_burn("ttft", 3.0)
    clk = Clock(0.0)
    ctl = _ctl(pkg, router, eng, clk, shed_burn=2.0, shed_recover_burn=1.0)
    out = [ctl.tick()]
    eng.set_burn("ttft", 0.5)
    clk.advance(1.0)
    out.append(ctl.tick())
    return ctl, router, out


def _shed_protected_only(pkg):
    spec_cls = PKGS[pkg][1].SLOSpec
    router = StubRouter(n=1, tier_weights={"gold": 1.0})
    eng = FakeEngine(specs=[spec_cls("ttft_gold", "m", tier="gold")])
    eng.set_burn("ttft", 9.0)
    ctl = _ctl(pkg, router, eng, Clock(0.0), shed_burn=2.0)
    return ctl, router, [ctl.tick()]


def _decision_stream(pkg):
    spec_cls = PKGS[pkg][1].SLOSpec
    router = StubRouter(n=1, tier_weights={"gold": 1.0, "bulk": 1.0})
    eng = FakeEngine(specs=[spec_cls("ttft_gold", "m", tier="gold")])
    clk = Clock(0.0)
    pool = [StubPredictor("spare0")]
    ctl = _ctl(pkg, router, eng, clk,
               spawn=lambda: pool.pop() if pool else None, shed_burn=2.0,
               weight_shift_factor=2.0, max_weight_factor=8.0)
    eng.set_burn("ttft", 3.0)
    eng.set_burn("ttft_gold", 3.0, tier="gold")
    out = [ctl.tick()]
    clk.advance(2.0)
    eng.set_burn("ttft", 0.4)
    eng.set_burn("ttft_gold", 0.0, tier="gold")
    out.append(ctl.tick())
    return ctl, router, out


class _Queued:
    tier = None


class RoleReplica(StubReplica):
    def __init__(self, name, role):
        super().__init__(name)
        self.role = role

    def queue_depth(self):
        return len(self.inbox) + len(self.pending)


class RoleRouter(StubRouter):
    """A disaggregated stub pool: replicas carry a role, growth and
    draining are role-scoped (the real Router's signatures)."""

    def __init__(self, roles):
        super().__init__(n=0)
        self.replicas = [RoleReplica(f"{r[0]}{i}", r)
                         for i, r in enumerate(roles)]

    def add_replica(self, pred, name=None, role=None):
        rep = RoleReplica(pred.name, role or "unified")
        rep.predictor = pred
        self.replicas.append(rep)
        return rep

    def drain_replica(self, name=None, role=None):
        healthy = [r for r in self.healthy()
                   if role is None or r.role == role]
        if len(healthy) <= 1:
            return None
        healthy[-1].closed = True
        return healthy[-1]


def _roles(pkg):
    router = RoleRouter(["prefill", "decode", "decode", "decode"])
    for rep in router.replicas[:1]:
        rep.inbox = [_Queued()] * 6         # a prefill backlog
    eng, clk = FakeEngine(), Clock(0.0)
    spawned = []

    def spawn(role):
        spawned.append(StubPredictor(f"{role}-spare{len(spawned)}"))
        return spawned[-1]

    ctl = _ctl(pkg, router, eng, clk, spawn=spawn, scale_in_quiet_ticks=2)
    out = []
    for _ in range(4):
        out.append(ctl.tick())
        clk.advance(2.0)
    router.replicas[0].inbox = []
    for _ in range(3):
        out.append(ctl.tick())
        clk.advance(2.0)
    return ctl, router, out


SCENARIOS = {f.__name__.strip("_"): f for f in (
    _scale_out, _max_replicas, _scale_in_then_revive, _shift_quantum,
    _shed, _shed_protected_only, _decision_stream, _roles)}


def _state(ctl, router):
    return {"healthy": [r.name for r in router.healthy()],
            "replicas": [(r.name, getattr(r, "role", None), r.revived)
                         for r in router.replicas],
            "tier_weights": router.tier_weights,
            "shed_tiers": sorted(router.shed_tiers),
            "weight_calls": router.weight_calls,
            "parked": ctl.park_count()}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_decisions_equal_the_reference(name):
    got = {}
    for pkg in PKGS:
        ctl, router, ticks = SCENARIOS[name](pkg)
        got[pkg] = ([_strip(t) for t in ticks], _strip(ctl.decisions),
                    _state(ctl, router))
    assert got["port"] == got["ref"]
    ticks, decisions, _ = got["port"]
    assert [r["seq"] for r in decisions] == \
        list(range(1, len(decisions) + 1))
    if name in ("scale_out", "shift_quantum", "shed", "roles"):
        assert any(ticks), "the scenario fired no rule"


def test_decision_stream_replays_to_live_state():
    """``tools/trace_replay.py`` rebuilds the port's pool state from the
    port's decision records alone, as it does the reference's."""
    tr = _load_trace_replay()
    ctl, router, _ = _decision_stream("port")
    timeline = tr.rebuild_timeline(ctl.decisions)
    assert timeline["pool_size"] == len(router.healthy())
    assert timeline["tier_weights"] == dict(router.tier_weights)
    assert timeline["shed_tiers"] == sorted(router.shed_tiers)
    assert timeline["decisions"] == len(ctl.decisions) - 1


def _fill(reg):
    reg.gauge("serving.slots").set(4, replica="r0")
    reg.gauge("serving.slots").set(4, replica="r1")
    reg.gauge("serving.in_flight").set(3, replica="r0")
    reg.gauge("serving.in_flight").set(1, replica="r1")
    reg.gauge("serving.page_utilization").set(0.75, replica="r0")
    reg.gauge("serving.tier.queue_depth").set(5, tier="gold")
    reg.gauge("serving.tier.queue_depth").set(2, tier="bulk")
    h = reg.histogram("serving.ttft_seconds", unit="s")
    for v in (0.01, 0.2, 0.4, 0.05, 0.9):
        h.observe(v, replica="r0")


def _signals(pkg, with_router):
    _, slo, metrics, autoscale = PKGS[pkg]
    reg = metrics.MetricRegistry()
    _fill(reg)
    router = RoleRouter(["prefill", "decode", "unified"]) \
        if with_router else None
    if router is not None:
        router.replicas[1].inbox = [_Queued()] * 3
    clk = Clock(0.0)
    sm = slo.Ewma(half_life_s=10.0, now_fn=clk)
    q = reg.gauge("serving.queue_depth")
    out = []
    for depth in (20, 0, 20, 0):
        q.set(depth)
        sig = autoscale.autoscale_signals(router, registry=reg,
                                          slo_ttft_s=0.25, smoother=sm)
        autoscale.publish_autoscale(sig, registry=reg)
        out.append({k: v for k, v in sig.items() if k != "ts"})
        clk.advance(1.0)
    gauges = {}
    for m in reg.metrics():
        if m.name.startswith("serving.autoscale."):
            gauges[m.name] = sorted((tuple(sorted(s.labels.items())),
                                     s.value) for s in m.samples())
    return out, gauges


@pytest.mark.parametrize("with_router", [False, True],
                         ids=["registry", "router"])
def test_autoscale_signals_equal_the_reference(with_router):
    port = _signals("port", with_router)
    assert port == _signals("ref", with_router)
    sigs, gauges = port
    assert "serving.autoscale.desired_replicas" in gauges
    assert ("roles" in sigs[0]) == with_router
