"""The port's ``Router`` over replicas of one model, against the JAX
reference's.

- Routing: the ``affinity``, ``least_loaded`` and ``random`` policies
  pick the reference's replica and reason for every request of a
  sequence with shared and cold prefixes. The load state is held fixed
  while the sequence is submitted (every replica's intake lock is held,
  so no worker dequeues), then the pool serves it: the tokens equal one
  predictor's.
- Health: a serve loop that raises counts a replica failure and
  re-admits its request once; a second failure ejects the replica; the
  tokens, statuses, attempts and router counters equal the reference's.
- Pool control: ``add_replica``, ``drain_replica`` (never the last
  replica), ``set_tier_weight``, ``set_shed_tiers`` (the shed status at
  the admission edge), ``generate_stream``, ``stats``, ``autoscale`` and
  the context manager, beside the reference's results.
- A shared model: another replica's serving is no weight change, so a
  predictor's prefix cache survives it (``_ensure_ready`` compares
  storage and version counters, which serving never moves).

Exact equality throughout. Every wait is bounded (``result(timeout)``,
``shutdown(timeout)`` in ``finally``). The card cases (``cuda``) run two
replicas on the device against one predictor's tokens, unified and
disaggregated, and warm-start a third replica while two warm ones serve.
"""
import threading

import numpy as np
import pytest
import torch

import paddle_tpu_torch.observability as obs
from paddle_tpu_torch.inference import ContinuousBatchingPredictor
from paddle_tpu_torch.serving import Router

GEOM = dict(max_batch_size=2, page_size=8, max_seq_len=64)
ROUTER = ("serving.router.routed", "serving.router.completed",
          "serving.router.readmissions", "serving.router.ejections",
          "serving.router.replica_failures", "serving.router.shed",
          "serving.router.pool_resizes")


def _observabilities():
    """The port's telemetry and, where it imports, the reference's (the
    card's machine has no JAX: its cases use the port alone)."""
    try:
        import paddle_tpu.observability as ref_obs
    except ImportError:
        return (obs,)
    return (obs, ref_obs)


@pytest.fixture(autouse=True)
def _clean():
    both = _observabilities()
    for o in both:
        o.configure(None)
        o.enabled(True)
        o.get_registry().reset()
    yield
    for o in both:
        o.get_registry().reset()


@pytest.fixture(scope="module")
def models():
    from test_torch_predictor import _pair
    return _pair()


def _ref_obs():
    import paddle_tpu.observability as ref_obs
    return ref_obs


def _series(o):
    out = {}
    for m in o.get_registry().metrics():
        if m.name.startswith(ROUTER):
            out[m.name] = {tuple(sorted(s._labels.items())): s.value
                           for s in m.series()}
    return out


def _router(pkg, models, n=2, **kw):
    ref_m, port_m = models
    if pkg == "ref":
        from paddle_tpu.serving import Router as RefRouter
        return RefRouter([ref_m] * n, seed=0, **GEOM, **kw)
    return Router([port_m] * n, seed=0, device="cpu", **GEOM, **kw)


def _cb_tokens(models, prompts, max_new):
    return ContinuousBatchingPredictor(models[1], device="cpu",
                                       **GEOM).generate(
        prompts, max_new_tokens=max_new)


def _shared_prefix_prompts():
    rng = np.random.RandomState(4)
    a, b = (rng.randint(2, 256, (16,)).tolist() for _ in range(2))
    tail = [rng.randint(2, 256, (n,)).tolist() for n in (3, 5, 2, 7, 4, 6)]
    cold = [rng.randint(2, 256, (n,)).tolist() for n in (9, 20, 5)]
    return [a + tail[0], cold[0], b + tail[1], a + tail[2], cold[1],
            b + tail[3], a + tail[4], cold[2], b + tail[5]]


def _route_sequence(pkg, models, policy, prompts):
    """Submit ``prompts`` with every replica's intake held (a fixed load
    state), then serve them."""
    o = _ref_obs() if pkg == "ref" else obs
    o.get_registry().reset()
    router = _router(pkg, models, n=3, policy=policy)
    try:
        for rep in router.replicas:
            rep.lock.acquire()
        try:
            hs = [router.submit(p, max_new_tokens=4) for p in prompts]
            loads = [rep.load for rep in router.replicas]
        finally:
            for rep in router.replicas:
                rep.lock.release()
        outs = [h.result(timeout=120) for h in hs]
        return ([h.replica for h in hs], loads, outs,
                _series(o)["serving.router.routed"])
    finally:
        router.shutdown(timeout=10)


@pytest.mark.parametrize("policy", ["affinity", "least_loaded", "random"])
def test_routing_equals_the_reference(models, policy):
    prompts = _shared_prefix_prompts()
    got = _route_sequence("port", models, policy, prompts)
    assert got == _route_sequence("ref", models, policy, prompts)
    names, _, outs, routed = got
    assert outs == _cb_tokens(models, prompts, 4)
    reasons = {dict(k)["reason"] for k in routed}
    if policy == "affinity":
        # each shared prefix stays with the replica that first took it
        assert names[0] == names[3] == names[6]
        assert names[2] == names[5] == names[8]
        assert reasons == {"affinity", "least_loaded"}
    else:
        assert reasons == {policy}


def _failures(pkg, models):
    """Replica 0's serve loop raises on its first two steps: the first
    failure re-admits request 1 to replica 1, the second ejects replica 0
    and re-admits request 2; request 3 serves on replica 1."""
    o = _ref_obs() if pkg == "ref" else obs
    o.get_registry().reset()
    router = _router(pkg, models, n=2, eject_after=2)
    try:
        rep0 = router.replicas[0]
        orig = rep0.predictor._resolve_step
        bombs = {"n": 2}

        def bomb(*a, **kw):
            if bombs["n"]:
                bombs["n"] -= 1
                raise RuntimeError("boom")
            return orig(*a, **kw)

        rep0.predictor._resolve_step = bomb
        prompts = [[5, 6, 7, 8, 9], [11, 12, 13], [21, 22, 23, 24]]
        out = []
        for p in prompts:
            h = router.submit(p, max_new_tokens=4)
            out.append((h.result(timeout=120), h.status, h.attempts,
                        h.replica))
        return (out, [r.ejected for r in router.replicas],
                [r.consecutive_failures for r in router.replicas],
                len(router.healthy()), _series(o))
    finally:
        router.shutdown(timeout=10)


def test_readmission_and_ejection_equal_the_reference(models):
    got = _failures("port", models)
    assert got == _failures("ref", models)
    out, ejected, _, healthy, series = got
    assert [o[0] for o in out] == _cb_tokens(
        models, [[5, 6, 7, 8, 9], [11, 12, 13], [21, 22, 23, 24]], 4)
    assert [o[1:] for o in out] == [("ok", 1, "replica1"),
                                   ("ok", 1, "replica1"),
                                   ("ok", 0, "replica1")]
    assert ejected == [True, False] and healthy == 1
    assert sum(series["serving.router.replica_failures"].values()) == 2
    assert sum(series["serving.router.ejections"].values()) == 1


def _pool_control(pkg, models):
    ref_m, port_m = models
    o = _ref_obs() if pkg == "ref" else obs
    o.get_registry().reset()
    router = _router(pkg, models, n=2, tier_weights={"gold": 4.0,
                                                     "bulk": 1.0})
    try:
        if pkg == "ref":
            from paddle_tpu.inference import (
                ContinuousBatchingPredictor as RefCB)
            extra = RefCB(ref_m, name="extra", **GEOM)
        else:
            extra = ContinuousBatchingPredictor(port_m, device="cpu",
                                                name="extra", **GEOM)
        rep = router.add_replica(extra)
        names = [r.name for r in router.healthy()]
        drained = router.drain_replica(name="extra").name
        refused = [router.drain_replica() is not None
                   for _ in range(2)]
        router.set_tier_weight("gold", 8.0)
        router.set_shed_tiers({"bulk"})
        shed = router.submit([3, 4, 5], max_new_tokens=2, tier="bulk")
        kept = router.submit([3, 4, 5], max_new_tokens=2, tier="gold")
        router.set_shed_tiers(())
        stream = [ev.token for ev in router.generate_stream(
            [7, 8, 9, 10], max_new_tokens=3) if ev.kind == "token"]
        outs = router.generate([[1, 2, 3], [4, 5, 6, 7]], max_new_tokens=3,
                               timeout=120)
        stats = router.stats()
        sig = router.autoscale(publish=True)
        return (names, drained, rep.role, refused, router.tier_weights,
                (shed.result(timeout=5), shed.status),
                (kept.result(timeout=120), kept.status), stream, outs,
                router.last_status, sorted(stats),
                {k: sorted(v) for k, v in stats.items()},
                sig["healthy_replicas"], sig["total_replicas"],
                _series(o))
    finally:
        router.shutdown(timeout=10)


def test_pool_control_equals_the_reference(models):
    got = _pool_control("port", models)
    assert got == _pool_control("ref", models)
    assert got[0] == ["replica0", "replica1", "extra"]
    assert got[3] == [True, False]            # the last replica stays
    assert got[5] == ([], "shed") and got[6][1] == "ok"


def test_shared_model_prefix_cache_survives_other_replicas(models):
    """Two predictors over one model object: while and after B serves
    other prompts (in another thread), A's cached prompt is still a full
    prefix hit with no prefill."""
    _, port_m = models
    a = ContinuousBatchingPredictor(port_m, device="cpu", name="a", **GEOM)
    b = ContinuousBatchingPredictor(port_m, device="cpu", name="b", **GEOM)
    prompt = list(range(30, 46))              # two full pages
    first = a.generate([prompt], max_new_tokens=4)
    out = {}
    t = threading.Thread(target=lambda: out.setdefault(
        "b", b.generate([[9, 8, 7, 6, 5], [4, 3, 2, 1, 9, 9]],
                        max_new_tokens=6)))
    t.start()
    again = a.generate([prompt], max_new_tokens=4)
    t.join(timeout=60)
    assert "b" in out and again == first
    third = a.generate([prompt], max_new_tokens=4)
    assert third == first
    assert a.stats["prefix_hits"] == 2 and a.stats["prefills"] == 1


def test_router_builds_predictors_on_the_given_device(models):
    _, port_m = models
    router = Router([port_m, port_m], roles=["prefill", "decode"],
                    device="cpu", enable_prefix_cache=True, **GEOM)
    try:
        assert [r.predictor.device.type for r in router.replicas] == \
            ["cpu", "cpu"]
        assert [r.role for r in router.replicas] == ["prefill", "decode"]
        assert [r.predictor.name for r in router.replicas] == \
            ["replica0", "replica1"]
    finally:
        router.shutdown(timeout=10)
    with pytest.raises(ValueError, match="roles"):
        Router([port_m], roles=["prefill", "decode"], device="cpu")
    with pytest.raises(ValueError, match="policy"):
        Router([port_m], policy="bogus", device="cpu")


# ------------------------------------------------------------------- card --

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _card_model(dev):
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    torch.manual_seed(0)
    return LlamaForCausalLM(LlamaConfig.tiny(
        hidden_size=256, num_attention_heads=2, num_key_value_heads=2,
        intermediate_size=512), device=dev)


def _card_prompts():
    """One prompt per power-of-two bucket: every prefill runs alone in its
    bucket whichever replica and round take it, and decode computes each
    slot's row alone, so the tokens do not depend on the schedule."""
    rng = np.random.RandomState(0)
    return [rng.randint(2, 256, (n,)).tolist() for n in (5, 12, 20, 40, 70)]


@pytest.mark.cuda
@pytest.mark.parametrize("roles", [None, ["prefill", "decode"]],
                         ids=["unified", "disaggregated"])
def test_two_replicas_on_the_card(cuda, roles):
    """Two replica threads on one device serve one predictor's tokens;
    no replica fails; a disaggregated pool hands every request off."""
    model = _card_model(cuda)
    prompts = _card_prompts()
    geo = dict(max_batch_size=4, page_size=16, max_seq_len=256)
    want = ContinuousBatchingPredictor(model, **geo).generate(
        prompts, max_new_tokens=8)
    router = Router([model, model], roles=roles, seed=0, **geo)
    try:
        got = router.generate(prompts, max_new_tokens=8, timeout=120)
    finally:
        router.shutdown(timeout=30)
    assert got == want
    assert router.last_status == ["ok"] * len(prompts)
    series = _series(obs)
    assert not series.get("serving.router.replica_failures")
    if roles:
        m = obs.get_registry().get("serving.handoff.requests")
        assert sum(s.value for s in m.samples()) == len(prompts)


@pytest.mark.cuda
def test_warm_start_beside_a_serving_pool(cuda, tmp_path):
    """Two warm replicas replay their graphs while the main thread
    warm-starts a third from the same bundle (its warm-up and captures
    under the device gate's exclusive side) and adds it to the pool:
    every request keeps one predictor's tokens, no replica fails, and
    the third serves."""
    from paddle_tpu_torch.inference import aot
    model = _card_model(cuda)
    prompts = _card_prompts()
    # one slot a replica and no prefix cache: the bundle holds every
    # signature the traffic takes (no write-back from two replicas)
    geo = dict(max_batch_size=1, page_size=16, max_seq_len=256,
               use_ragged=False, enable_prefix_cache=False)
    want = ContinuousBatchingPredictor(model, device=cuda, **geo).generate(
        prompts, max_new_tokens=8)
    path = str(tmp_path / "bundle")
    aot.EngineBuilder(model, prompt_buckets=(8, 16, 32, 64, 128),
                      batch_sizes=(1,),
                      capture_forward=False, **geo).build(
        path, wire_cache=False)
    preds = [aot.warm_start(model, path, strict=True, wire_cache=False,
                            name=f"w{i}")[0] for i in range(2)]
    router = Router(preds, policy="least_loaded", seed=0)
    try:
        hs = [router.submit(p, max_new_tokens=8) for p in prompts * 3]
        third, _ = aot.warm_start(model, path, strict=True,
                                  wire_cache=False, name="w2")
        rep = router.add_replica(third)
        hs += [router.submit(p, max_new_tokens=8) for p in prompts * 2]
        got = [h.result(timeout=120) for h in hs]
    finally:
        router.shutdown(timeout=30)
    assert got == want * 5
    assert rep.served >= 1
    assert not _series(obs).get("serving.router.replica_failures")
    assert all(p._engine.stats["misses"] == 0 for p in (*preds, third))
