"""The port's serving front end against the JAX reference's.

``paddle_tpu_torch.serving`` (the fair-queueing scheduler and the token
streams), ``framework.faults``, ``framework.flags`` and
``RuntimeConfig.from_flags`` are held to their reference modules on the
same operation sequences; the port's ``ContinuousBatchingPredictor`` is
held to the reference's on a tiny Llama (the weights moved with
``convert.load_reference_state_dict``) under tiers, a bounded queue and
both shed policies, deadlines, the ``serve_flood`` and ``decode_wedge``
faults, cancellation, an abandoned stream, ``serve_stream`` and
``set_tier_weight``: the results, ``last_status``, the shared ``stats``
and, request by request, the stream's events (kind, token, index,
status, span; the timestamps aside) must be equal.
"""
import collections
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.framework import faults as ref_faults
from paddle_tpu.framework import runtime_config as ref_rc
from paddle_tpu.serving import ServeRequest as RefServeRequest
from paddle_tpu.serving import scheduler as ref_sched

from paddle_tpu_torch.framework import faults, flags
from paddle_tpu_torch.framework.runtime_config import RuntimeConfig
from paddle_tpu_torch.inference import (ContinuousBatchingPredictor,
                                        DecodeWedgedError)
from paddle_tpu_torch.inference.predictor import _Fetch
from paddle_tpu_torch.serving import (FifoQueue, ServeRequest,
                                      WeightedFairScheduler, scheduler)

from test_torch_predictor import _predictors, _prompts


@pytest.fixture(autouse=True)
def _disarmed():
    yield
    paddle.set_flags({"fault_injection": "",
                      "serve_decode_watchdog_s": 0.0})
    flags.set_flags({"fault_injection": "", "serve_decode_watchdog_s": 0.0})


def _arm(spec):
    paddle.set_flags({"fault_injection": spec})
    flags.set_flags({"fault_injection": spec})


# --------------------------------------------------------------- scheduler --

def _drive(q, rng, n_ops, tiers):
    """A random operation sequence on a queue discipline, from ``rng``;
    returns what every operation gave and the queue's state after it."""
    trace, popped, nxt = [], [], 0
    wfs = isinstance(q, (WeightedFairScheduler,
                         ref_sched.WeightedFairScheduler))
    for _ in range(n_ops):
        op = rng.randint(0, 8)
        if op <= 2:
            tier = tiers[rng.randint(0, len(tiers))]
            q.push(nxt, tier=tier, cost=float(rng.randint(1, 200)))
            got = ("push", nxt)
            nxt += 1
        elif op == 3:
            r = q.pop()
            if r is not None:
                popped.append(r)
            got = ("pop", r)
        elif op == 4 and popped:
            r = popped.pop(rng.randint(0, len(popped)))
            if rng.randint(0, 2):
                q.push_front(r)
                got = ("push_front", r)
            else:
                q.consume(r)
                got = ("consume", r)
        elif op == 5:
            r = int(rng.randint(0, nxt + 1))
            got = ("remove", r, q.remove(r))
            if r in popped:         # a removed entry is forgotten
                popped.remove(r)
        elif op == 6:
            policy = ("newest", "oldest")[rng.randint(0, 2)]
            mq = int(rng.randint(1, 8))
            got = ("shed", policy, mq, q.pick_shed(policy, mq))
        else:
            tier = tiers[rng.randint(0, len(tiers))]
            w = float(rng.randint(1, 10))
            if wfs:
                q.set_weight(tier, w)
            got = ("weight", tier, w)
        state = (len(q), q.ids(), q.depths())
        if wfs:
            state += (q.snapshot(),)
        trace.append((got, state))
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("kind", ["fifo", "wfs"])
def test_scheduler_matches_reference(kind, seed):
    """push, push_front, pop, consume, remove, set_weight and pick_shed
    under both policies: the same pops, sheds, depths and deficits."""
    tiers = ["interactive", "batch", "bulk"]
    weights = {"interactive": 4.0, "batch": 1.0}
    if kind == "fifo":
        port, ref = FifoQueue(), ref_sched.FifoQueue()
    else:
        port = WeightedFairScheduler(weights, quantum=48.0)
        ref = ref_sched.WeightedFairScheduler(weights, quantum=48.0)
    got = _drive(port, np.random.RandomState(seed), 400, tiers)
    want = _drive(ref, np.random.RandomState(seed), 400, tiers)
    assert got == want
    assert scheduler.DEFAULT_TIER == ref_sched.DEFAULT_TIER
    for stage in (None, "prefill", "decode"):
        assert scheduler.stage_cost(100, 30, stage) == \
            ref_sched.stage_cost(100, 30, stage)


# ------------------------------------------------------------------ faults --

FAULT_SPECS = [
    "decode_wedge:sleep=5,serve_flood:n=100",
    "serve_flood:every=3:n=7,decode_wedge",
    "serve_flood:prob=0.4:seed=9,decode_wedge:hit=2:sleep=0.5",
    "ckpt_save:step=3-5:times=2:err,nan_loss:step=5,slow_step:every=4",
]


def _fault_fields(spec):
    return (spec.site, spec.mode, spec.step_lo, spec.step_hi, spec.hit,
            spec.every, spec.times, spec.prob, spec.seed, spec.params,
            spec.text)


@pytest.mark.parametrize("text", FAULT_SPECS)
def test_faults_match_reference(text):
    """FaultSpec.parse and the registry (hit counting, step ranges,
    times, every, the deterministic prob coin) fire at the same checks
    with the same actions."""
    for part in text.split(","):
        assert _fault_fields(faults.FaultSpec.parse(part)) == \
            _fault_fields(ref_faults.FaultSpec.parse(part))
    port, ref = faults.FaultRegistry(), ref_faults.FaultRegistry()
    port.arm(text)
    ref.arm(text)
    assert port.armed and ref.armed
    sites = ["serve_flood", "decode_wedge", "ckpt_save", "nan_loss",
             "slow_step", "other"]
    for i in range(60):
        site, step = sites[i % len(sites)], i // 3
        a, b = port.check(site, step=step), ref.check(site, step=step)
        assert (a is None) == (b is None)
        if a is not None:
            assert (a.site, a.mode, a.params) == (b.site, b.mode, b.params)
    assert port.events() == ref.events()
    port.disarm()
    assert not port.armed and port.check("serve_flood") is None


def test_fault_flag_arms_the_registry():
    """FLAGS_fault_injection's hook arms the module registry; a bad token
    raises as in the reference."""
    flags.set_flags({"fault_injection": "serve_flood:n=5"})
    assert faults.armed()
    act = faults.check("serve_flood")
    assert act.mode == "flood" and act.params == {"n": 5.0}
    assert faults.events()[0]["spec"] == "serve_flood:n=5"
    flags.set_flags({"fault_injection": ""})
    assert not faults.armed()
    for mod in (faults, ref_faults):
        with pytest.raises(ValueError, match="unknown token"):
            mod.FaultSpec.parse("decode_wedge:bogus")


SERVE_FLAGS = {"serve_prefill_chunk_tokens": 64,
               "serve_spec_draft_tokens": 3, "serve_spec_ngram_max": 2,
               "serve_sampling": True, "serve_decode_watchdog_s": 1.5}


def test_runtime_config_from_flags_matches_reference():
    """The serving flags have the reference's defaults and help text, and
    ``from_flags()`` under set flags equals the reference's on every
    field the port has; the four runtime-only fields validate alike."""
    names = list(SERVE_FLAGS) + ["fault_injection"]
    from paddle_tpu.framework import flags as rflags
    for n in names:
        assert flags._REGISTRY[n].default == rflags._REGISTRY[n].default
        assert flags._REGISTRY[n].help == rflags._REGISTRY[n].help
    fields = set(RuntimeConfig().to_dict())

    def shared(rc):
        return {k: v for k, v in rc.to_dict().items() if k in fields}
    assert shared(RuntimeConfig.from_flags()) == \
        shared(ref_rc.RuntimeConfig.from_flags())
    try:
        flags.set_flags(SERVE_FLAGS)
        paddle.set_flags(SERVE_FLAGS)
        got = RuntimeConfig.from_flags()
        assert got.to_dict() == shared(ref_rc.RuntimeConfig.from_flags())
        assert got.decode_watchdog_s == 1.5 and got.sampling_enabled
    finally:
        defaults = {n: flags._REGISTRY[n].default for n in SERVE_FLAGS}
        flags.set_flags(defaults)
        paddle.set_flags(defaults)
    kw = dict(max_queue=7, shed_policy="oldest", decode_watchdog_s=2.0,
              wfs_quantum=32.0)
    assert RuntimeConfig(**kw).to_dict() == shared(ref_rc.RuntimeConfig(**kw))
    for cls in (RuntimeConfig, ref_rc.RuntimeConfig):
        with pytest.raises(ValueError, match="shed_policy"):
            cls(shed_policy="random")
    assert "max_queue" not in ref_rc.COMPILED_FIELDS


# --------------------------------------------------------------- predictor --

def _events(stream, on_event=None):
    """{request: [(kind, token, index, status, span), ...]} of a stream;
    ``on_event(i, ev)`` runs after the stream yields its i-th event."""
    per = collections.defaultdict(list)
    for i, ev in enumerate(stream):
        per[ev.request].append((ev.kind, ev.token, ev.index, ev.status,
                                tuple(ev.span)))
        if on_event is not None:
            on_event(i, ev)
    return dict(per)


def _same(ref, port, got, want):
    assert got == want
    assert port.last_status == ref.last_status
    assert {k: port.stats[k] for k in port.stats} == \
        {k: ref.stats[k] for k in port.stats}


def _stream_pair(ref, port, prompts, on_event=None, **kw):
    """Both predictors' streams of one call: (port events, ref events,
    port results, ref results)."""
    sp = port.generate_stream(prompts, **kw)
    sr = ref.generate_stream(prompts, **kw)
    got = _events(sp, on_event and (lambda i, ev: on_event(i, ev, sp)))
    want = _events(sr, on_event and (lambda i, ev: on_event(i, ev, sr)))
    return got, want, sp.results, sr.results


TIERS6 = ["interactive", "batch"] * 3


def test_tiers_and_weights_match_reference():
    ref, port = _predictors()
    prompts = _prompts(3, (5, 9, 12, 7, 4, 10))
    kw = dict(max_new_tokens=3, tiers=TIERS6,
              tier_weights={"interactive": 8, "batch": 1})
    got, want, gr, wr = _stream_pair(ref, port, prompts, **kw)
    _same(ref, port, (got, gr), (want, wr))
    assert port.last_status == ["ok"] * 6
    assert port._live_sched is not None


@pytest.mark.parametrize("tiered", [False, True], ids=["fifo", "tiers"])
@pytest.mark.parametrize("policy", ["newest", "oldest"])
def test_bounded_queue_sheds_like_reference(policy, tiered):
    """Eight requests into a queue bounded at 3 with one slot: the same
    requests shed (within-share tiers never), the rest served alike."""
    ref, port = _predictors(max_batch_size=1, max_queue=3,
                            shed_policy=policy)
    prompts = _prompts(4, (5, 9, 12, 7, 4, 10, 6, 8))
    kw = dict(max_new_tokens=2)
    if tiered:
        kw.update(tiers=["batch"] * 6 + ["interactive"] * 2,
                  tier_weights={"interactive": 8, "batch": 1})
    got, want, gr, wr = _stream_pair(ref, port, prompts, **kw)
    _same(ref, port, (got, gr), (want, wr))
    assert port.stats["shed_requests"] == 5
    if tiered:
        assert port.last_status[6:] == ["ok", "ok"]


@pytest.mark.parametrize("deadline", ["scalar", "per_request"])
def test_deadlines_match_reference(deadline):
    ref, port = _predictors()
    prompts = _prompts(5, (5, 9, 12, 7))
    dl = 0.0 if deadline == "scalar" else [None, 0.0, 60.0, 0.0]
    got, want, gr, wr = _stream_pair(ref, port, prompts, max_new_tokens=4,
                                     deadline_s=dl)
    _same(ref, port, (got, gr), (want, wr))
    if deadline == "scalar":
        assert gr == [[]] * 4 and port.last_status == ["deadline"] * 4
    else:
        assert port.last_status == ["ok", "deadline", "ok", "deadline"]
    assert port.stats["deadline_evictions"] == (4 if deadline == "scalar"
                                                else 2)


def test_serve_flood_fault_matches_reference():
    """``serve_flood:n=3`` inflates the queue's depth at its first check:
    a queue bounded at 4 sheds all but one of three queued requests."""
    _arm("serve_flood:n=3")
    ref, port = _predictors(max_queue=4)
    prompts = _prompts(6, (5, 9, 12))
    got, want, gr, wr = _stream_pair(ref, port, prompts, max_new_tokens=2)
    _same(ref, port, (got, gr), (want, wr))
    assert port.last_status == ["ok", "shed", "shed"]
    assert faults.events() == ref_faults.events()


def test_decode_watchdog_matches_reference():
    """``decode_wedge:sleep=5`` under a 0.25 s watchdog: the first resolve
    trips it, the call returns well before the wedge ends and every
    pending request ends 'watchdog'. Then, disarmed, a 30 s watchdog
    stays quiet and changes no token."""
    _arm("decode_wedge:sleep=5")
    ref, port = _predictors(decode_watchdog_s=0.25)
    prompts = _prompts(7, (5, 9, 12))
    t0 = time.perf_counter()
    got = port.generate(prompts, max_new_tokens=8)
    assert time.perf_counter() - t0 < 5
    want = ref.generate(prompts, max_new_tokens=8)
    _same(ref, port, got, want)
    assert port.stats["watchdog_trips"] == 1
    assert port.last_status == ["watchdog"] * 3
    _arm("")
    ref, port = _predictors(decode_watchdog_s=30.0)
    plain = _predictors()[1].generate(prompts, max_new_tokens=8)
    got, want, gr, wr = _stream_pair(ref, port, prompts, max_new_tokens=8)
    _same(ref, port, (got, gr), (want, wr))
    assert gr == plain and port.stats["watchdog_trips"] == 0
    assert port._wd_cur == ref._wd_cur == 30.0


def test_watchdog_flag_arms_at_serve_time():
    """No constructor value: FLAGS_serve_decode_watchdog_s is read at
    every serve, as in the reference; 0 disarms."""
    ref, port = _predictors()
    prompts = _prompts(7, (5,))
    port.generate(prompts, max_new_tokens=2)
    assert port._wd_cur is None
    flags.set_flags({"serve_decode_watchdog_s": 12.0})
    paddle.set_flags({"serve_decode_watchdog_s": 12.0})
    port.generate(prompts, max_new_tokens=2)
    ref.generate(prompts, max_new_tokens=2)
    assert port._wd_cur == ref._wd_cur == 12.0


def test_cancellation_matches_reference():
    """Request 2 (queued: two slots) is cancelled at the stream's first
    event and request 0 at its own third token: both streams end them at
    the same event, with the same partial tokens."""
    ref, port = _predictors(enable_prefix_cache=False)
    prompts = _prompts(8, (5, 9, 12))

    def on_event(i, ev, stream):
        if i == 0:
            stream.cancel(2)
        if ev.request == 0 and ev.kind == "token" and ev.index == 3:
            stream.cancel(0)
    got, want, gr, wr = _stream_pair(ref, port, prompts, on_event,
                                     max_new_tokens=10)
    _same(ref, port, (got, gr), (want, wr))
    assert port.last_status == ["cancelled", "ok", "cancelled"]
    assert gr[2] == [] and 3 <= len(gr[0]) < 10
    assert port.stats["cancelled_requests"] == 2
    assert port.pool.free_count == port.capacity


def test_abandoned_stream_matches_reference():
    """A consumer leaving a ``with`` block after three events: every
    pending request ends 'cancelled' and every page returns."""
    ref, port = _predictors(enable_prefix_cache=False)
    prompts = _prompts(9, (5, 9, 12))
    seen = {}
    for name, cb in (("port", port), ("ref", ref)):
        evs = []
        with cb.generate_stream(prompts, max_new_tokens=16) as st:
            for ev in st:
                evs.append((ev.request, ev.kind, ev.token, ev.index))
                if len(evs) == 3:
                    break
        seen[name] = (evs, st.results, list(st.status))
    assert seen["port"] == seen["ref"]
    _same(ref, port, None, None)
    assert port.last_status == ["cancelled"] * 3
    assert port.pool.free_count == port.capacity


def _intake(cls, prompts, per_poll=2, polls=3):
    """An intake handing over ``per_poll`` requests per poll for ``polls``
    polls, then None; each request carries its index as ``meta``, its
    own budget, and a tier."""
    reqs = [cls(p, 3 + r % 3, ("interactive", "batch")[r % 2], None, r)
            for r, p in enumerate(prompts[:per_poll * polls])]
    it = iter(range(polls))

    def intake():
        i = next(it, None)
        if i is None:
            return None
        return reqs[i * per_poll:(i + 1) * per_poll]
    return intake


def _serve_stream_events(cb, cls, prompts, threaded):
    evs = collections.defaultdict(list)
    st = cb.serve_stream(_intake(cls, prompts),
                         tier_weights={"interactive": 4, "batch": 1})

    def consume():
        for ev in st:
            evs[ev.request].append((ev.kind, ev.token, ev.index, ev.status,
                                    tuple(ev.span), ev.meta))
    if threaded:
        th = threading.Thread(target=consume)
        th.start()
        th.join(120)
        assert not th.is_alive()
    else:
        consume()
    return dict(evs), st.results, list(st.status)


@pytest.mark.parametrize("threaded", [False, True],
                         ids=["same_thread", "consumer_thread"])
def test_serve_stream_matches_reference(threaded):
    """A polled intake (2 requests a poll, 3 polls, then None) through
    ``serve_stream``; consumed here or from a second thread (grad mode
    is thread-local: the steps carry their own no_grad)."""
    ref, port = _predictors()
    prompts = _prompts(10, (5, 9, 12, 7, 4, 10))
    got = _serve_stream_events(port, ServeRequest, prompts, threaded)
    want = _serve_stream_events(ref, RefServeRequest, prompts, threaded)
    assert got == want
    _same(ref, port, None, None)
    assert got[2] == ["ok"] * 6
    assert [len(r) for r in got[1]] == [3 + r % 3 for r in range(6)]


def test_set_tier_weight_matches_reference():
    """A live weight shift on the running tiered scheduler (after the
    first event) changes the admission order alike; before any serve
    it is a no-op."""
    ref, port = _predictors(max_batch_size=1)
    port.set_tier_weight("batch", 5)
    assert port._live_sched is None
    prompts = _prompts(11, (5, 9, 12, 7, 4, 10))
    tiers = ["interactive", "interactive", "batch", "batch", "batch",
             "interactive"]

    kw = dict(max_new_tokens=2, tiers=tiers,
              tier_weights={"interactive": 8, "batch": 1})
    sp = port.generate_stream(prompts, **kw)
    sr = ref.generate_stream(prompts, **kw)
    got = _events(sp, lambda i, ev: i == 0 and port.set_tier_weight(
        "batch", 16))
    want = _events(sr, lambda i, ev: i == 0 and ref.set_tier_weight(
        "batch", 16))
    _same(ref, port, (got, sp.results), (want, sr.results))
    assert port._live_sched.weights["batch"] == 16.0


# ------------------------------------------------------- stream parity ----

def _cyclic(n, length):
    rng = np.random.RandomState(0)
    motifs = [rng.randint(2, 256, (3 + s % 4,)).tolist() for s in range(24)]
    return [(motifs[s] * (length // 3 + 1))[:length] for s in (2, 9, 16)][:n]


def _sampling(ref):
    from paddle_tpu.generation.sampling import SamplingParams as RSP
    from paddle_tpu_torch.generation.sampling import SamplingParams
    cls = RSP if ref else SamplingParams
    return [None, cls(temperature=0.8, top_k=20, seed=3),
            cls(temperature=1.0, seed=-5), cls(temperature=0.6, top_p=0.9,
                                               seed=7)]


STREAM_CFGS = {
    "greedy": dict(),
    "chunk_spec": dict(max_seq_len=128, prefill_chunk_tokens=16,
                       spec_draft_tokens=3),
    "sampled": dict(max_seq_len=128, prefill_chunk_tokens=16,
                    sampling_enabled=True),
}


@pytest.mark.parametrize("cfg", list(STREAM_CFGS))
def test_stream_events_match_reference(cfg):
    """Per request, the events (kind, token, index, status, span) equal
    the reference's: one token event per tick, a speculative tick's
    committed tokens in one span, one end event; the concatenated spans
    are the request's result."""
    ref, port = _predictors(**STREAM_CFGS[cfg])
    prompts = _cyclic(3, 20) + [_prompts(12, (40,))[0]]
    kw = dict(max_new_tokens=12)
    if cfg == "sampled":
        sp = port.generate_stream(prompts, sampling=_sampling(False), **kw)
        sr = ref.generate_stream(prompts, sampling=_sampling(True), **kw)
        got, want = _events(sp), _events(sr)
        gr, wr = sp.results, sr.results
    else:
        got, want, gr, wr = _stream_pair(ref, port, prompts, **kw)
    _same(ref, port, (got, gr), (want, wr))
    for r, evs in got.items():
        toks = [t for kind, _, _, _, span in evs if kind == "token"
                for t in span]
        assert toks == gr[r] and evs[-1][0] == "end"
    if cfg == "chunk_spec":
        assert any(len(e[4]) > 1 for evs in got.values() for e in evs)


# ------------------------------------------------------------- port only --

def test_kernel_failure_ends_requests_error_and_reraises(monkeypatch):
    """An exception inside a step ends every pending request 'error'
    (not 'cancelled'), releases their pages and propagates."""
    _, port = _predictors(enable_prefix_cache=False)
    calls = []
    real = ContinuousBatchingPredictor._raw_decode_step

    def failing(self, *a):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("injected step failure")
        return real(self, *a)
    monkeypatch.setattr(ContinuousBatchingPredictor, "_raw_decode_step",
                        failing)
    with pytest.raises(RuntimeError, match="injected"):
        port.generate(_prompts(13, (5, 9, 12)), max_new_tokens=8)
    assert port.last_status == ["error"] * 3
    assert port.stats["cancelled_requests"] == 0
    assert port.pool.free_count == port.capacity


class _Event:
    """A stand-in CUDA event: ready after ``n`` queries."""

    def __init__(self, n):
        self.n, self.queries, self.syncs = n, 0, 0

    def query(self):
        self.queries += 1
        return self.queries > self.n

    def synchronize(self):
        self.syncs += 1


def test_armed_watchdog_polls_without_synchronize():
    """Armed, the wait polls the fetch's event with ``query()`` and never
    blocks in ``synchronize()`` before it is ready; past the deadline it
    raises DecodeWedgedError. Unarmed, it does not poll at all."""
    _, port = _predictors()
    ev = _Event(50)
    step = {"fetch": _Fetch([torch.zeros(2)], ev)}
    port._wd_cur = 5.0
    port._await_step(step)
    assert ev.queries == 51 and ev.syncs == 0
    step["fetch"]()
    assert ev.syncs == 1
    ev = _Event(10 ** 9)
    port._wd_cur = 0.05
    t0 = time.perf_counter()
    with pytest.raises(DecodeWedgedError):
        port._await_step({"fetch": _Fetch([torch.zeros(2)], ev)})
    assert 0.05 <= time.perf_counter() - t0 < 1 and ev.syncs == 0
    port._wd_cur = None
    ev = _Event(0)
    port._await_step({"fetch": _Fetch([torch.zeros(2)], ev)})
    assert ev.queries == 0


def test_constructor_arguments_and_validation():
    """The reference's constructor arguments: fallbacks to the runtime
    config, shed_policy validation, ``name`` kept, ``devices`` accepted
    at tp_degree 1."""
    _, port = _predictors(max_queue=5, shed_policy="oldest", name="r0",
                          devices=["cpu"], decode_watchdog_s=0)
    assert (port.max_queue, port.shed_policy, port.name) == \
        (5, "oldest", "r0")
    rc = RuntimeConfig(max_queue=9, shed_policy="oldest",
                       decode_watchdog_s=3.0)
    cb = ContinuousBatchingPredictor(port.model, device="cpu",
                                     runtime_config=rc, max_batch_size=2,
                                     page_size=8, max_seq_len=64)
    assert (cb.max_queue, cb.shed_policy) == (9, "oldest")
    cb.generate(_prompts(14, (5,)), max_new_tokens=2)
    assert cb._wd_cur == 3.0
    with pytest.raises(ValueError, match="shed_policy"):
        ContinuousBatchingPredictor(port.model, device="cpu",
                                    shed_policy="lifo")
    for k in ("deadline_evictions", "shed_requests", "watchdog_trips",
              "cancelled_requests"):
        assert port.stats[k] == 0


# -------------------------------------------------------------------- card --

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the armed watchdog polls a CUDA "
                    "event")
    return torch.device("cuda")


@pytest.mark.cuda
def test_stream_and_watchdog_on_the_card(cuda):
    """On the card: the stream's spans equal ``generate()``'s tokens, also
    with the watchdog armed at 30 s (it polls the fetch's event); under
    ``decode_wedge:sleep=5`` a 0.5 s watchdog returns within 5 s with
    every request 'watchdog', and the device was never wedged."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.tiny(hidden_size=256, num_attention_heads=2,
                           num_key_value_heads=2, intermediate_size=512,
                           dtype="bfloat16")
    model = LlamaForCausalLM(cfg, device=cuda).init_weights(
        torch.Generator(device=cuda).manual_seed(0))
    geo = dict(max_batch_size=2, page_size=16, max_seq_len=128)
    prompts = _prompts(15, (37, 20, 50))
    want = ContinuousBatchingPredictor(model, device=cuda, **geo).generate(
        prompts, max_new_tokens=12)
    for wd in (None, 30.0):
        st = ContinuousBatchingPredictor(
            model, device=cuda, decode_watchdog_s=wd, **geo).generate_stream(
            prompts, max_new_tokens=12)
        spans = collections.defaultdict(list)
        for ev in st:
            spans[ev.request].extend(ev.span)
        assert [spans[r] for r in range(3)] == want == st.results
        assert st.status == ["ok"] * 3
    _arm("decode_wedge:sleep=5")
    cb = ContinuousBatchingPredictor(model, device=cuda,
                                     decode_watchdog_s=0.5, **geo)
    t0 = time.perf_counter()
    cb.generate(prompts, max_new_tokens=12)
    assert time.perf_counter() - t0 < 5
    assert cb.stats["watchdog_trips"] == 1
    assert cb.last_status == ["watchdog"] * 3
    _arm("")
    torch.cuda.synchronize()
