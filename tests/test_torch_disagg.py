"""Disaggregated prefill / decode in the port against the JAX reference:
the KV page span, its handoff through the ``Router``, and per-role AOT
bundles.

- ``KVPageSpan``: identical pages in both packages' pools (float32 and
  bfloat16) export to equal checksum strings and bitwise-equal pages; a
  span exported by either package imports into the port's pool bitwise,
  with the stats (``page_ids``, ``imported``, ``reused``, ``bytes``) the
  reference's import gives; prefix dedup; a corrupted span and a
  geometry mismatch are rejected without touching the pool; an import
  writes in place (every page tensor keeps its object and ``data_ptr``).
- The two-stage router over the tiny Llama (the reference's weights,
  ``convert``): a prefill + decode pool gives the tokens of the
  reference's disaggregated router, of the port's unified pool and of
  each package's predictor; the handoff and router counters are equal
  across the packages; the decode replica runs no prefill forward; an
  export miss, the ``handoff_corrupt`` fault and a decode replica dying
  after the handoff behave as in the reference.
- Roles on the predictor and per-role bundles: the role joins the metric
  labels, the deprecated span aliases warn, a decode bundle refuses a
  prefill warm start with reason ``role``, and a prefill build clamps its
  capture budget to one token.

Exact equality throughout (tokens, bytes, checksum strings, counts).
The card cases (``cuda``) run the span round trip on the device, into
a pool whose pages a captured CUDA graph reads.
"""
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu_torch.observability as obs
from paddle_tpu_torch.framework import flags
from paddle_tpu_torch.framework.runtime_config import RuntimeConfig
from paddle_tpu_torch.generation.kv_cache import (KVPageSpan, PagedKVPool,
                                                  PrefixCache, _page_bytes)
from paddle_tpu_torch.inference import ContinuousBatchingPredictor, aot
from paddle_tpu_torch.serving import Router

GEOM = dict(max_batch_size=2, page_size=8, max_seq_len=64)
POOL = dict(n_layers=2, num_pages=8, page_size=4, n_kv_heads=2, head_dim=2)
HANDOFF = ("serving.handoff.", "serving.router.routed",
           "serving.router.completed", "serving.router.readmissions",
           "serving.router.replica_failures")


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
    flags.set_flags({"fault_injection": ""})
    if len(both) > 1:
        import paddle_tpu as paddle
        paddle.set_flags({"fault_injection": ""})
    for o in both:
        o.get_registry().reset()


def _prompts(n, lens=(9, 12, 17, 7), seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(2, 256, (lens[i % len(lens)],)).tolist()
            for i in range(n)]


def _pair():
    from test_torch_predictor import _pair as pair
    return pair()


def _series(o, prefixes=HANDOFF):
    """{name: {labels: value}}: counter values and histogram counts."""
    out = {}
    for m in o.get_registry().metrics():
        if not m.name.startswith(prefixes) or m.kind == "gauge":
            continue
        for s in m.series():
            key = tuple(sorted(s._labels.items()))
            v = s._count if m.kind == "histogram" else s.value
            out.setdefault(m.name, {})[key] = v
    return out


# ------------------------------------------------------------ KVPageSpan --

def _pools(dtype):
    """A reference pool and a port pool holding the same page bits."""
    from paddle_tpu.generation.kv_cache import PagedKVPool as RefPool
    ref = RefPool(dtype=dtype, **POOL)
    port = PagedKVPool(dtype=dtype, device="cpu", **POOL)
    rng = np.random.RandomState(1)
    for layer in range(POOL["n_layers"]):
        for pages in (ref.k, ref.v):
            vals = rng.randn(*pages[layer].shape).astype(np.float32)
            pages[layer] = pages[layer].at[:].set(
                vals.astype(pages[layer].dtype))
        for src, dst in ((ref.k, port.k), (ref.v, port.v)):
            arr = np.array(src[layer])
            if dtype == "bfloat16":
                arr = arr.view(np.int16)
            dst[layer].copy_(torch.from_numpy(arr).view(dst[layer].dtype))
    return ref, port


def _to_port_span(span):
    """A reference span carried into the port's: its numpy pages as they
    are (a bfloat16 page as a uint16 view of its bits), its checksum
    kept."""
    def host(a):
        return a.view(np.uint16) if a.dtype.name == "bfloat16" else a
    return KVPageSpan(span.prompt, span.next_token, span.page_size,
                      span.n_kv_heads, span.head_dim, span.dtype,
                      span.topology, [host(a) for a in span.k_pages],
                      [host(a) for a in span.v_pages],
                      checksum=span.checksum, trace=span.trace)


def _bits(a):
    return bytes(_page_bytes(a))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_export_checksum_and_pages_equal_the_reference(dtype):
    """A 7-token prompt (one full page and a 3-token partial, page 4):
    equal checksum strings and pages bit for bit, the partial page's
    stale tail zeroed."""
    ref, port = _pools(dtype)
    prompt = list(range(10, 17))
    rs = ref.export_span(prompt, [5, 2], next_token=42)
    ps = port.export_span(prompt, [5, 2], next_token=42)
    assert ps.checksum == rs.checksum and ps.verify()
    assert (ps.n_pages, ps.nbytes, ps.keys, ps.topology) == \
        (rs.n_pages, rs.nbytes, rs.keys, rs.topology) == \
        (2, rs.nbytes, rs.keys, "single")
    for a, b in zip(ps.k_pages + ps.v_pages, rs.k_pages + rs.v_pages):
        assert _bits(a) == _bits(b)
        assert not a[-1, 3:].any()


@pytest.mark.parametrize("source", ["ref", "port"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_span_imports_into_the_port_bitwise(dtype, source):
    """A span exported by either package imports into a port pool with
    the reference import's stats, and the pages land bit for bit."""
    from paddle_tpu.generation.kv_cache import PagedKVPool as RefPool
    from paddle_tpu.generation.kv_cache import PrefixCache as RefPrefix
    ref, port = _pools(dtype)
    prompt = list(range(20, 30))                  # 2 full pages + 2
    rs = ref.export_span(prompt, [1, 6, 3], next_token=9)
    span = _to_port_span(rs) if source == "ref" else \
        port.export_span(prompt, [1, 6, 3], next_token=9)
    assert span.verify() and span.checksum == rs.checksum
    dst_ref = RefPool(dtype=dtype, **POOL)
    dst_ref.alloc(2)                              # not page 0 onwards
    dst = PagedKVPool(dtype=dtype, device="cpu", **POOL)
    dst.alloc(2)
    want = dst_ref.import_span(rs, RefPrefix(4))
    cache = PrefixCache(4)
    got = dst.import_span(span, cache)
    assert got == want
    assert (got["imported"], got["reused"]) == (3, 0)
    for pages, sp in ((dst.k, span.k_pages), (dst.v, span.v_pages)):
        for layer in range(POOL["n_layers"]):
            assert _bits(pages[layer][got["page_ids"]]) == _bits(sp[layer])
    # the trie took the pages and the continuation: a full hit
    assert cache.lookup(prompt)[3] == 9


def test_prefix_dedup_on_import():
    """The reference's dedup sequence (fresh import, a replayed import of
    a resident span moving nothing, a span sharing one page moving only
    the other) gives the reference's stats and free counts."""
    from paddle_tpu.generation.kv_cache import PagedKVPool as RefPool
    from paddle_tpu.generation.kv_cache import PrefixCache as RefPrefix
    ref, port = _pools("float32")
    prompt = list(range(20, 28))
    prompt2 = prompt[:4] + list(range(40, 44))
    got = {}
    for name, src, pool, cache in (
            ("ref", ref, RefPool(**POOL), RefPrefix(4)),
            ("port", port, PagedKVPool(device="cpu", **POOL),
             PrefixCache(4))):
        steps = [pool.import_span(src.export_span(prompt, [0, 1], 7),
                                  cache)]
        steps.append(pool.free_count)
        steps.append(pool.import_span(src.export_span(prompt, [0, 1], 7),
                                      cache))
        steps.append(pool.free_count)
        steps.append(pool.import_span(src.export_span(prompt2, [0, 2], 9),
                                      cache))
        got[name] = steps
    assert got["port"] == got["ref"]
    assert got["port"][2]["bytes"] == 0 and got["port"][4]["reused"] == 1


def test_corrupt_span_and_geometry_mismatch_rejected():
    ref, port = _pools("float32")
    span = port.export_span(list(range(4)), [3], next_token=1)
    span.k_pages[0][0, 0, 0, 0] += 1.0
    assert not span.verify()
    dst = PagedKVPool(device="cpu", **POOL)
    before = dst.free_count
    with pytest.raises(ValueError, match="checksum"):
        dst.import_span(span, PrefixCache(4))
    assert dst.free_count == before
    good = port.export_span(list(range(4)), [3], next_token=1)
    other = PagedKVPool(**dict(POOL, page_size=8, num_pages=4),
                        device="cpu")
    with pytest.raises(ValueError, match="geometry"):
        other.import_span(good)
    with pytest.raises(ValueError, match="geometry"):
        PagedKVPool(**POOL, dtype="bfloat16", device="cpu").import_span(
            good)


def test_import_writes_in_place():
    """The pages are written into the pool's own tensors: a captured
    reader (a CUDA graph reads by address) sees the imported pages."""
    _, port = _pools("float32")
    span = port.export_span(list(range(30, 41)), [4, 7, 0], next_token=3)
    dst = PagedKVPool(device="cpu", **POOL)
    before = [(t, t.data_ptr()) for t in (*dst.k, *dst.v)]
    stats = dst.import_span(span, PrefixCache(4))
    assert all(t is b and t.data_ptr() == p
               for t, (b, p) in zip((*dst.k, *dst.v), before))
    assert _bits(dst.k[1][stats["page_ids"]]) == _bits(span.k_pages[1])


# ---------------------------------------------------------------- router --

def _ref_router(model, **kw):
    from paddle_tpu.serving import Router as RefRouter
    return RefRouter(model, seed=0, **kw)


def _ref_cb(model, **kw):
    from paddle_tpu.inference import ContinuousBatchingPredictor as RefCB
    return RefCB(model, **dict(GEOM, **kw))


def _cb(model, **kw):
    return ContinuousBatchingPredictor(model, device="cpu",
                                       **dict(GEOM, **kw))


def _run(router, prompts, max_new=6):
    try:
        hs = [router.submit(p, max_new_tokens=max_new) for p in prompts]
        return [h.result(timeout=120) for h in hs], hs
    finally:
        router.shutdown(timeout=10)


def test_disaggregated_tokens_and_handoff_counters_equal_the_reference():
    """Prefill + decode: the tokens of the reference's disaggregated
    router, the port's unified pool and both predictors; every request
    hands off once with no fallback and ends on the decode replica in
    stage "decode"; the handoff and router counters equal the
    reference's; the decode replica ran no prefill."""
    import paddle_tpu.observability as ref_obs
    ref_m, port_m = _pair()
    prompts = _prompts(4)
    want = _ref_cb(ref_m).generate(prompts, max_new_tokens=6)
    assert _cb(port_m).generate(prompts, max_new_tokens=6) == want
    ref_obs.get_registry().reset()
    obs.get_registry().reset()
    ref_out, _ = _run(_ref_router([ref_m, ref_m],
                                  roles=["prefill", "decode"], **GEOM),
                      prompts)
    router = Router([port_m, port_m], roles=["prefill", "decode"], seed=0,
                    device="cpu", **GEOM)
    assert router.disaggregated
    out, hs = _run(router, prompts)
    assert out == ref_out == want
    assert all(h.status == "ok" and h.stage == "decode"
               and h.replica == "replica1" and h.first_token_ts is not None
               for h in hs)
    got, ref_got = _series(obs), _series(ref_obs)
    assert got == ref_got
    assert got["serving.handoff.requests"] == {
        (("replica", "replica0"),): 4.0}
    assert "serving.handoff.fallbacks" not in got
    stats = router.stats()
    assert stats["replica1"]["prefills"] == 0
    assert stats["replica1"]["prefix_hits"] == 4
    assert stats["replica0"]["prefills"] == 4
    # the unified pool serves the same tokens
    out_u, _ = _run(Router([port_m, port_m], seed=0, device="cpu", **GEOM),
                    prompts)
    assert out_u == want


def _fallback_case(pkg, case, models):
    """One request through a prefill + decode pool of ``pkg`` under
    ``case``: its tokens, handle fields and counters."""
    import paddle_tpu as paddle
    import paddle_tpu.observability as ref_obs
    ref_m, port_m = models
    o = ref_obs if pkg == "ref" else obs
    o.get_registry().reset()
    prompt = _prompts(1)[0]
    if pkg == "ref":
        make_cb, model = _ref_cb, ref_m
        set_flags, make_router = paddle.set_flags, _ref_router
    else:
        make_cb, model = _cb, port_m
        set_flags = flags.set_flags

        def make_router(ms, **kw):
            return Router(ms, seed=0, **kw)
    if case == "export_miss":
        router = make_router([make_cb(model, name="p0", role="prefill",
                                      enable_prefix_cache=False),
                              make_cb(model, name="d0", role="decode")],
                             roles=["prefill", "decode"])
    else:
        roles = ["prefill", "decode"] + (["decode"] if case == "readmit"
                                         else [])
        router = make_router([model] * len(roles), roles=roles,
                             **(GEOM if pkg == "ref"
                                else dict(GEOM, device="cpu")))
    armed = {"on": case == "readmit"}
    if case == "readmit":
        # whichever decode replica takes the handoff dies on its first
        # step; the re-admitted request replays the kept span elsewhere
        for rep in router.replicas[1:]:
            orig = rep.predictor._resolve_step

            def bomb(*a, _orig=orig, **kw):
                if armed["on"]:
                    armed["on"] = False
                    raise RuntimeError("boom")
                return _orig(*a, **kw)

            rep.predictor._resolve_step = bomb
    if case == "corrupt":
        set_flags({"fault_injection": "handoff_corrupt:times=1"})
    try:
        out, (h,) = _run(router, [prompt])
    finally:
        set_flags({"fault_injection": ""})
    assert not armed["on"]
    final = next(r for r in router.replicas if r.name == h.replica)
    return (out, h.status, h.stage, h.attempts, final.role,
            h.handoff_span is None, _series(o))


@pytest.mark.parametrize("case", ["export_miss", "corrupt", "readmit"])
def test_handoff_fallbacks_equal_the_reference(case):
    """The reference's fallback semantics: an export miss (prefix cache
    off on the prefill side) dispatches without a span, a corrupted span
    is rejected by its checksum, and a decode replica dying after the
    handoff re-admits the request once to the other decode replica,
    which replays the kept span. Each ends in a correct prefill or
    resume: tokens, handle fields and counters equal the reference's."""
    models = _pair()
    want = _ref_cb(models[0]).generate(_prompts(1), max_new_tokens=6)
    got = _fallback_case("port", case, models)
    assert got == _fallback_case("ref", case, models)
    out, status, stage, attempts, role, no_span, series = got
    assert out == want and status == "ok" and stage == "decode"
    assert role == "decode"
    fb = series.get("serving.handoff.fallbacks", {})
    if case == "readmit":
        assert attempts == 1 and not no_span and not fb
        assert sum(series["serving.router.replica_failures"].values()) == 1
        assert sum(series["serving.router.readmissions"].values()) == 1
    else:
        assert attempts == 0
        assert list(fb.values()) == [1.0]
        assert dict(next(iter(fb)))["reason"] == case
        assert no_span == (case == "export_miss")


def test_prefill_role_inserts_chunked_ingest_for_export():
    """A chunked prompt on a prefill replica enters the prefix trie when
    its first token resolves, so its span exports; on a unified replica
    a chunked prompt bypasses the trie and exports nothing."""
    _, port_m = _pair()
    prompt = _prompts(1, lens=(37,))[0]
    spans = {}
    for role in ("prefill", "unified"):
        cb = _cb(port_m, role=role, prefill_chunk_tokens=16)
        first = cb.generate([prompt], max_new_tokens=1)[0]
        assert cb.stats["chunked_requests"] == 1
        spans[role] = cb.export_page_span(prompt)
    assert spans["unified"] is None
    span = spans["prefill"]
    assert span.next_token == first[0] and span.n_pages == 5
    dec = _cb(port_m, role="decode")
    stats = dec.import_page_span(span)
    assert stats["imported"] == 5
    got = dec.generate([prompt], max_new_tokens=6)
    assert dec.stats["prefills"] == 0 and dec.stats["prefix_hits"] == 1
    assert got == _cb(port_m).generate([prompt], max_new_tokens=6)


def test_role_labels_and_deprecated_aliases():
    _, port_m = _pair()
    assert _cb(port_m, name="p")._mlbl == {"replica": "p"}
    cb = _cb(port_m, name="p", role="prefill")
    assert cb._mlbl == {"replica": "p", "role": "prefill"}
    assert _cb(port_m, runtime_config=RuntimeConfig(
        **GEOM).for_role("decode")).role == "decode"
    with pytest.raises(ValueError, match="serve_role"):
        _cb(port_m, role="bogus")
    prompt = _prompts(1)[0]
    cb.generate([prompt], max_new_tokens=1)
    with pytest.warns(DeprecationWarning, match="export_page_span"):
        span = cb.export_request_span(prompt)
    with pytest.warns(DeprecationWarning, match="import_page_span"):
        stats = _cb(port_m).import_request_span(span)
    assert stats["imported"] == 2
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert cb.export_page_span(prompt[:3]) is None   # never served
    with pytest.raises(ValueError, match="prefix cache"):
        _cb(port_m, enable_prefix_cache=False).import_page_span(span)


def test_public_surface_covers_the_reference():
    """Every public name of the reference's predictor, page pool, span
    and ``serving`` package is in the port's."""
    import paddle_tpu.serving as ref_serving
    from paddle_tpu.generation import kv_cache as ref_kv
    from paddle_tpu.inference import ContinuousBatchingPredictor as RefCB
    import paddle_tpu_torch.serving as serving

    def missing(ref, port):
        return sorted(n for n in dir(ref)
                      if not n.startswith("_") and not hasattr(port, n))
    assert missing(RefCB, ContinuousBatchingPredictor) == []
    assert missing(ref_kv.PagedKVPool, PagedKVPool) == []
    assert missing(ref_kv.KVPageSpan, KVPageSpan) == []
    assert sorted(set(ref_serving.__all__) - set(serving.__all__)) == []


# ----------------------------------------------------------- role bundles --

def test_role_mismatch_invalidation(tmp_path):
    """A decode bundle warm-starts clean for decode, refuses a prefill
    warm start with reason ``role`` (strict), and non-strict self-heals
    to the requested role (``aot.invalidations{reason="role"}``)."""
    import json
    _, port_m = _pair()
    rc = RuntimeConfig(max_batch_size=2, page_size=8, max_seq_len=64,
                       prompt_buckets=(8,)).for_role("decode")
    path = str(tmp_path / "bundle")
    aot.EngineBuilder(port_m, batch_sizes=[1], capture_forward=False,
                      runtime_config=rc).build(path, wire_cache=False)
    man = json.load(open(path + "/manifest.json"))
    assert man["geometry"]["role"] == "decode"
    assert man["runtime_config"]["serve_role"] == "decode"
    reg = obs.get_registry()
    reg.reset()
    p, e = aot.warm_start(port_m, path, wire_cache=False, runtime_config=rc)
    assert e.warm and p.role == "decode"
    inv = reg.get("aot.invalidations")
    assert inv is None or not any(s.value for s in inv.samples())
    with pytest.raises(aot.BundleInvalid) as ei:
        aot.warm_start(port_m, path, wire_cache=False, strict=True,
                       role="prefill")
    assert ei.value.reason == "role"
    p2, e2 = aot.warm_start(port_m, path, wire_cache=False, role="prefill")
    assert not e2.warm and p2.role == "prefill"
    assert any(s.labels.get("reason") == "role"
               for s in reg.get("aot.invalidations").samples())
    assert e2.bundle.manifest(refresh=True)["geometry"]["role"] == "prefill"


def test_prefill_build_clamps_capture_budget():
    _, port_m = _pair()
    rc = RuntimeConfig(max_batch_size=2, page_size=8, max_seq_len=64,
                       prompt_buckets=(8,))
    b = aot.EngineBuilder(port_m, batch_sizes=[1], max_new_tokens=16,
                          capture_forward=False,
                          runtime_config=rc.for_role("prefill"))
    assert b.max_new_tokens == 1
    assert aot.EngineBuilder(port_m, batch_sizes=[1], max_new_tokens=16,
                             capture_forward=False, role="prefill"
                             ).max_new_tokens == 1
    b2 = aot.EngineBuilder(port_m, batch_sizes=[1], max_new_tokens=16,
                           capture_forward=False,
                           runtime_config=rc.for_role("decode"))
    assert b2.max_new_tokens == 16


# ------------------------------------------------------------------- card --

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_span_round_trip_under_a_captured_reader(cuda, dtype):
    """Export on the device, import into another device pool whose pages
    a CUDA graph reads: the replay after the import sees the imported
    pages, and they equal the source's bit for bit."""
    from paddle_tpu_torch.framework.graphs import GraphProgram, capture_stream
    torch.manual_seed(0)
    src = PagedKVPool(dtype=dtype, device=cuda, **POOL)
    for t in (*src.k, *src.v):
        t.copy_(torch.randn(t.shape, device=cuda))
    span = src.export_span(list(range(50, 61)), [2, 5, 7], next_token=4)
    dst = PagedKVPool(dtype=dtype, device=cuda, **POOL)
    prog = GraphProgram(lambda: (dst.k[1].float().sum(0),), (),
                        torch.cuda.graph_pool_handle(), capture_stream(cuda))
    stats = dst.import_span(span, PrefixCache(4))
    ids = stats["page_ids"]
    torch.cuda.synchronize()
    for pages, sp in ((dst.k, span.k_pages), (dst.v, span.v_pages)):
        for layer in range(POOL["n_layers"]):
            assert _bits(pages[layer][ids].cpu()) == _bits(sp[layer])
    want = dst.k[1].float().sum(0)
    assert torch.equal(prog()[0], want)
    assert src.span_ops == {"export": 1, "import": 0}
    assert dst.span_ops == {"export": 0, "import": 1}
