"""The port's AOT inference engine (``paddle_tpu_torch.inference.aot``)
against the JAX reference's (``paddle_tpu.inference.aot``).

On the CPU a program is the eager function, so these cases hold the
engine's plumbing: a warm-started port predictor serves the reference's
eager predictor's tokens and stats (the reference's own warm-started
predictor is not the oracle: its serialized XLA:CPU executables load only
on machines with the features they were built for); the port's manifest
names the reference's signature keys, geometry and buckets for the same
arguments; every invalidation has the reference's reason name,
self-heals, and raises under ``strict``; a bucket miss writes back; the
padded span index leaves every page but the trash page as the unpadded
one does. The ``cuda``
cases hold the captured graphs to eager dispatch on the card; the
module imports nothing of JAX (the reference is imported inside fixtures
and cases), so the card runs them.
"""
import json
import os
import shutil

import numpy as np
import pytest
import torch

from paddle_tpu_torch.convert import load_reference_state_dict
from paddle_tpu_torch.framework.runtime_config import RuntimeConfig
from paddle_tpu_torch.generation import sampling as ps
from paddle_tpu_torch.generation.kv_cache import SpanIndex, span_index
from paddle_tpu_torch.inference import ContinuousBatchingPredictor, aot
from paddle_tpu_torch.kernels import _build, launch_counts, \
    reset_launch_counts
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

GEO = dict(max_batch_size=2, page_size=8, max_seq_len=64,
           enable_prefix_cache=False)
BUCKETS = (8, 16)


@pytest.fixture(scope="module")
def models():
    import paddle_tpu as paddle
    from paddle_tpu.models import LlamaConfig as RefConfig
    from paddle_tpu.models import LlamaForCausalLM as RefLlama
    paddle.seed(0)
    ref = RefLlama(RefConfig.tiny(tensor_parallel=False))
    port = LlamaForCausalLM(LlamaConfig.tiny(tensor_parallel=False),
                            device="cpu")
    load_reference_state_dict(
        port, {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()})
    return ref, port


@pytest.fixture(scope="module")
def bundle(models, tmp_path_factory):
    """One port bundle shared by the module; mutating cases copy it."""
    path = str(tmp_path_factory.mktemp("aot") / "engine")
    aot.build_engine(models[1], path, prompt_buckets=BUCKETS,
                     batch_sizes=(1, 2), wire_cache=False, **GEO)
    return path


@pytest.fixture(autouse=True)
def _counters():
    aot.reset_counters()


def _copy(path, tmp_path):
    dst = str(tmp_path / "engine")
    shutil.copytree(path, dst)
    return dst


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def _edit_manifest(path, fn):
    m = _manifest(path)
    fn(m)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(m, f)


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(2, 256, (n,)).tolist() for n in lens]


def _cyclic(n, length):
    rng = np.random.RandomState(0)
    motifs = [rng.randint(2, 256, (3 + s % 4,)).tolist() for s in range(24)]
    return [(motifs[s] * (length // 3 + 1))[:length] for s in (2, 9, 16)][:n]


def _shared(ref, port):
    return {k: ref.stats[k] for k in port.stats}, dict(port.stats)


# --------------------------------------------------- the reference's surface --

def test_compiled_keys_equal_the_reference(models):
    from paddle_tpu.framework import runtime_config as ref_rc
    from paddle_tpu.inference import aot as ref_aot
    from paddle_tpu.inference.aot import engine as ref_engine
    from paddle_tpu_torch.framework import runtime_config as port_rc
    assert aot.COMPILED_GEOMETRY_KEYS == ref_engine.COMPILED_GEOMETRY_KEYS
    assert port_rc.COMPILED_FIELDS == ref_rc.COMPILED_FIELDS
    assert (aot.MANIFEST, aot.FORMAT) == (ref_aot.MANIFEST, ref_aot.FORMAT)
    rc, ref = RuntimeConfig(), ref_rc.RuntimeConfig()
    assert rc.to_dict() == ref.to_dict()
    assert RuntimeConfig.from_dict(rc.to_dict()) == rc
    assert rc.config_hash() == ref.config_hash()
    with pytest.raises(ValueError, match="tp_degree"):
        RuntimeConfig(tp_degree=2)
    with pytest.raises(ValueError, match="serve_role"):
        RuntimeConfig(serve_role="bogus")
    with pytest.raises(ValueError, match="unknown"):
        RuntimeConfig.from_dict({**rc.to_dict(), "bogus_field": 3})


MANIFEST_CFGS = {
    "greedy": dict(GEO),
    "chunk_spec_sampled": dict(GEO, max_seq_len=128,
                               prefill_chunk_tokens=16, spec_draft_tokens=3,
                               sampling_enabled=True),
}


@pytest.mark.parametrize("cfg", list(MANIFEST_CFGS))
def test_manifest_matches_the_reference(models, tmp_path, cfg):
    """The same build arguments give the reference's signature keys,
    geometry and buckets (the kinds prefill, decode / decode_sample,
    mixed, spec and forward among them)."""
    from paddle_tpu.inference import aot as ref_aot
    ref, port = models
    kw = MANIFEST_CFGS[cfg]
    want = ref_aot.build_engine(ref, str(tmp_path / "ref"),
                                prompt_buckets=BUCKETS, batch_sizes=(1, 2),
                                wire_cache=False, **kw)
    got = aot.build_engine(port, str(tmp_path / "port"),
                           prompt_buckets=BUCKETS, batch_sizes=(1, 2),
                           wire_cache=False, **kw)
    assert set(got["artifacts"]) == set(want["artifacts"])
    assert got["geometry"] == want["geometry"]
    assert got["buckets"] == want["buckets"]
    assert {r["kind"] for r in got["artifacts"].values()} == \
        {r["kind"] for r in want["artifacts"].values()}
    for key, rec in got["artifacts"].items():
        assert aot.EngineBundle(str(tmp_path / "port")).load_artifact(
            key) is not None
        assert rec["kind"] == want["artifacts"][key]["kind"]


# ------------------------------------------------- warm start == reference --

def _mix(ref):
    from paddle_tpu.generation.sampling import SamplingParams as RSP
    cls = RSP if ref else ps.SamplingParams
    return [None, cls(temperature=0.8, top_k=20, seed=3),
            cls(temperature=1.0, seed=-5),
            cls(temperature=0.6, top_p=0.9, seed=7)]


def _sampled_prompts():
    rng = np.random.RandomState(0)
    motifs = [rng.randint(2, 256, (3 + s % 4,)).tolist() for s in range(24)]
    return [(motifs[2] * 30)[:70], (motifs[9] * 8)[:20],
            (motifs[16] * 8)[:20], rng.randint(2, 256, (11,)).tolist()]


# (port-only predictor arguments, shared geometry, prompt buckets, prompts,
#  max_new_tokens, sampled): greedy block-table with the prefix cache (its
# suffix prefill calibrated by traffic); chunked + speculative + ragged;
# sampling-enabled and chunked, greedy and sampled requests mixed
SERVE_CFGS = {
    "greedy_table": (dict(use_ragged=False),
                     dict(max_batch_size=2, page_size=8, max_seq_len=64),
                     (8, 16, 32), None, 8, False),
    "chunk_spec_ragged": (dict(use_ragged=True),
                          dict(GEO, max_seq_len=128, prefill_chunk_tokens=16,
                               spec_draft_tokens=3),
                          (32,), None, 12, False),
    "sampled": (dict(use_ragged=False),
                dict(GEO, max_seq_len=128, prefill_chunk_tokens=16,
                     sampling_enabled=True),
                (16, 32), None, 12, True),
}


def _serve_prompts(cfg):
    if cfg == "greedy_table":
        # the extension is admitted once the base is cached: a partial hit
        base = _prompts(5, (11,))[0]
        p9, p4 = _prompts(2, (9, 4))
        return [base, p9, base + _prompts(6, (6,))[0], p4]
    if cfg == "chunk_spec_ragged":
        return _cyclic(3, 20) + [_prompts(7, (40,))[0]]
    return _sampled_prompts()


@pytest.mark.parametrize("cfg", list(SERVE_CFGS))
def test_warm_start_equals_reference_eager(models, tmp_path, cfg):
    """A warm-started port predictor serves every program from its bundle
    (no miss) and gives the reference eager predictor's tokens and
    stats."""
    from paddle_tpu.inference import ContinuousBatchingPredictor as Ref
    ref, port = models
    port_only, geo, buckets, _, max_new, sampled = SERVE_CFGS[cfg]
    prompts = _serve_prompts(cfg)
    path = str(tmp_path / "engine")
    b = aot.EngineBuilder(port, prompt_buckets=buckets, **port_only, **geo)
    if cfg == "greedy_table":
        # the prefix cache's suffix prefill: no bucket steers it
        b.add_traffic(prompts, max_new_tokens=2)
    b.build(path, wire_cache=False)
    pred, eng = aot.warm_start(port, path, wire_cache=False)
    assert pred.use_ragged == port_only["use_ragged"]
    kw = dict(max_new_tokens=max_new)
    got = pred.generate(prompts, **kw,
                        **(dict(sampling=_mix(False)) if sampled else {}))
    want_cb = Ref(ref, **geo)
    want = want_cb.generate(prompts, **kw,
                            **(dict(sampling=_mix(True)) if sampled else {}))
    assert got == want
    assert pred.last_status == ["ok"] * len(prompts)
    want_s, got_s = _shared(want_cb, pred)
    assert got_s == want_s
    assert eng.stats["misses"] == 0 and eng.stats["hits"] > 0
    assert sum(aot.counters["bucket_misses"].values()) == 0
    assert sum(aot.counters["bundle_hits"].values()) == eng.stats["hits"]
    if cfg == "greedy_table":
        assert pred.stats["prefix_partial_hits"] >= 1
        assert aot.counters["bundle_hits"]["suffix"] >= 1
    if cfg == "chunk_spec_ragged":
        assert pred.stats["spec_ticks"] > 0 and pred.stats["mixed_steps"] > 0
    if sampled:
        assert aot.counters["bundle_hits"]["decode_sample"] > 0
        assert pred.sampling_stats["sampled_requests"] == 3


def test_eager_path_unchanged_without_an_engine(models):
    """No engine: ``_jit_call`` is the eager call (and the same tokens)."""
    _, port = models
    cb = ContinuousBatchingPredictor(port, device="cpu", **GEO)
    calls = []
    cb._raw_decode_step = lambda *a: calls.append(a) or \
        ContinuousBatchingPredictor._raw_decode_step(cb, *a)
    prompts = _prompts(3, (8, 16))
    out = cb.generate(prompts, max_new_tokens=4)
    assert calls and cb._engine is None
    assert out == ContinuousBatchingPredictor(
        port, device="cpu", **GEO).generate(prompts, max_new_tokens=4)


# ------------------------------------------------------------ invalidation --

def _corrupt_record(path):
    m = _manifest(path)
    rec = next(r for r in m["artifacts"].values() if r["kind"] == "decode")
    f = os.path.join(path, rec["file"])
    blob = open(f, "rb").read()
    open(f, "wb").write(blob[:-2] + b"]]")


def _corrupt_kernel(path):
    """A kernel library recorded in the bundle, then altered."""
    b = aot.EngineBundle(path)
    os.makedirs(b.kernel_dir, exist_ok=True)
    lib = os.path.join(b.kernel_dir, "libsampling-0123456789abcdef.so")
    open(lib, "wb").write(b"\x7fELF library bytes")
    b.add_kernels({})
    assert "libsampling-0123456789abcdef.so" in _manifest(path)["kernels"]
    open(lib, "ab").write(b"tail")


def _fingerprint(path):
    _edit_manifest(path, lambda m: m["fingerprint"].update(torch="0.0.1"))


def _topology(path):
    _edit_manifest(path, lambda m: m["geometry"].update(
        tp_degree=2, mesh_topology="model=2"))


def _role(path):
    _edit_manifest(path, lambda m: m["geometry"].update(role="prefill"))


# reason -> (how the bundle is spoiled, warm_start arguments, whether the
# whole bundle is reset)
INVALIDATIONS = {
    "manifest": (lambda p: open(os.path.join(p, "manifest.json"),
                                "w").write("{not json"), {}, True),
    "digest": (_corrupt_record, {}, False),
    "kernel_digest": (_corrupt_kernel, {}, True),
    "fingerprint": (_fingerprint, {}, True),
    "model": (None, {}, True),
    "geometry": (None, dict(page_size=16), True),
    "runtime_config": (None, dict(runtime_config=RuntimeConfig(
        max_batch_size=2, page_size=8, max_seq_len=64, prompt_buckets=(8,))),
        True),
    "topology": (_topology, dict(tp_degree=1), True),
    "role": (_role, dict(role="unified"), True),
}


@pytest.mark.parametrize("case", list(INVALIDATIONS))
def test_invalidation_reason_and_self_heal(models, bundle, tmp_path, case):
    """Each invalidation is counted under the reference's reason name; the
    bundle is reset (a corrupt program record: only that program misses)
    and the predictor serves, its misses written back; ``strict=True``
    raises with the same reason."""
    _, port = models
    spoil, kw, reset = INVALIDATIONS[case]
    reason = "digest" if case == "kernel_digest" else case
    path = _copy(bundle, tmp_path)
    if spoil is not None:
        spoil(path)
    model = port
    if case == "model":
        torch.manual_seed(2)
        model = LlamaForCausalLM(LlamaConfig.tiny(
            num_hidden_layers=1, tensor_parallel=False), device="cpu")
    if reset:
        strict_path = str(tmp_path / "strict")
        shutil.copytree(path, strict_path)
        with pytest.raises(aot.BundleInvalid) as ei:
            aot.warm_start(model, strict_path, strict=True,
                           wire_cache=False, **kw)
        assert ei.value.reason == reason
        aot.reset_counters()
    pred, eng = aot.warm_start(model, path, wire_cache=False, **kw)
    assert aot.counters["invalidations"][reason] >= 1
    out = pred.generate(_prompts(5, (8,)), max_new_tokens=3)
    assert len(out[0]) == 3
    m = _manifest(path)
    if reset:
        assert not eng.warm
        assert m["fingerprint"] == aot.runtime_fingerprint("cpu")
        assert m["model"] == aot.model_fingerprint(model)
        assert m["kernels"] == {}
    else:
        assert eng.warm and eng.stats["misses"] >= 1
    # self-healed: what was served is recorded again, digests verify
    assert m["artifacts"] and eng.stats["write_backs"] >= 1
    b = aot.EngineBundle(path)
    for key in m["artifacts"]:
        assert b.load_artifact(key) is not None
    pred2, eng2 = aot.warm_start(model, path, wire_cache=False, **kw)
    pred2.generate(_prompts(5, (8,)), max_new_tokens=3)
    assert eng2.stats["misses"] == 0 and eng2.stats["hits"] > 0


def test_load_engine_rejects_a_model_mismatch(bundle):
    torch.manual_seed(2)
    other = LlamaForCausalLM(LlamaConfig.tiny(
        num_hidden_layers=1, tensor_parallel=False), device="cpu")
    with pytest.raises(aot.BundleInvalid) as ei:
        aot.load_engine(bundle, model=other, wire_cache=False)
    assert ei.value.reason == "model"
    assert aot.counters["invalidations"]["model"] == 1


# -------------------------------------------------------------- bucket miss --

def test_bucket_miss_writes_back_then_hits(models, bundle, tmp_path):
    """An uncalibrated prompt bucket misses once, is served (the eager
    tokens), captured and written back; the next warm start hits it."""
    _, port = models
    path = _copy(bundle, tmp_path)
    prompts = _prompts(4, (32,))
    want = ContinuousBatchingPredictor(port, device="cpu", **GEO).generate(
        prompts, max_new_tokens=2)
    pred, eng = aot.warm_start(port, path, wire_cache=False)
    assert pred.generate(prompts, max_new_tokens=2) == want
    assert eng.stats["misses"] >= 1 and eng.stats["write_backs"] >= 1
    assert aot.counters["bucket_misses"]["prefill"] == 1
    assert any("(1, 32)" in k for k in _manifest(path)["artifacts"])
    aot.reset_counters()
    pred2, eng2 = aot.warm_start(port, path, wire_cache=False)
    assert pred2.generate(prompts, max_new_tokens=2) == want
    assert eng2.stats["misses"] == 0
    assert aot.counters["bundle_hits"]["prefill"] >= 1


def test_reference_report_tool_verifies_a_port_bundle(bundle, tmp_path):
    """``tools/aot_report.py --verify --json`` (the reference's stdlib
    inspector, unedited) reads a bundle the port wrote: every program
    record re-hashes, the runtime config hash verifies; a corrupted
    record fails the check."""
    import subprocess
    import sys
    tool = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "aot_report.py")
    path = _copy(bundle, tmp_path)

    def report():
        r = subprocess.run([sys.executable, "-I", tool, path, "--verify",
                            "--json"], capture_output=True, text=True,
                           timeout=120)
        return r.returncode, json.loads(r.stdout)
    rc, out = report()
    assert rc == 0 and out["verify_failures"] == []
    m = _manifest(path)
    assert out["artifacts"].keys() == m["artifacts"].keys() != set()
    assert out["geometry"] == m["geometry"]
    assert out["runtime_config_hash"] == m["runtime_config_hash"]
    key, rec = sorted(m["artifacts"].items())[0]
    with open(os.path.join(path, rec["file"]), "ab") as f:
        f.write(b"x")
    rc, out = report()
    assert rc == 1 and out["verify_failures"] == [[key, "digest mismatch"]]


def test_wire_kernel_cache_redirects_builds(tmp_path, monkeypatch):
    """The bundle's kernel directory becomes the build directory (the
    libraries' paths) and Triton's cache; a directory written by another
    runtime is wiped."""
    monkeypatch.setenv("TRITON_CACHE_DIR", "unchanged")
    d = tmp_path / "k"
    prev = aot.wire_kernel_cache(str(d), "cpu")
    try:
        assert _build.library_path("sampling").parent == d
        assert os.environ["TRITON_CACHE_DIR"] == str(d / "triton")
        (d / "stale.so").write_bytes(b"x")
        with open(d / ".cache_fingerprint.json", "w") as f:
            json.dump({"torch": "other"}, f)
        aot.wire_kernel_cache(str(d), "cpu")
        assert not (d / "stale.so").exists()
        assert aot.counters["invalidations"]["fingerprint"] == 1
    finally:
        _build.restore_build_dir(prev)
    assert os.environ["TRITON_CACHE_DIR"] == "unchanged"
    assert _build.BUILD_DIR == prev[0]


def test_rebinding_a_weight_after_capture_refuses_to_serve(models, bundle,
                                                           tmp_path):
    _, port = models
    pred, eng = aot.warm_start(port, _copy(bundle, tmp_path),
                               wire_cache=False)
    w = port.lm_head.weight
    try:
        port.lm_head.weight = torch.nn.Parameter(w.detach().clone())
        with pytest.raises(RuntimeError, match="rebound"):
            pred.generate(_prompts(5, (8,)), max_new_tokens=2)
    finally:
        port.lm_head.weight = w
    port.load_state_dict(port.state_dict())      # in place: still serves
    assert len(pred.generate(_prompts(5, (8,)), max_new_tokens=2)[0]) == 2


def _load_in_place(model, seed):
    """Every weight replaced in place (``copy_``) by a seeded draw of
    the same model: the version counters move, the addresses stay."""
    other = LlamaForCausalLM(model.config, device=model.device).init_weights(
        torch.Generator(device=model.device).manual_seed(seed))
    with torch.no_grad():
        for p, q in zip(model.parameters(), other.parameters()):
            p.copy_(q)


def test_weight_change_flushes_prefix_cache_under_engine(models, bundle,
                                                         tmp_path):
    """An in-place load between two serves of a warm-started predictor
    flushes its prefix cache: the second serve misses the cache and
    gives a fresh predictor's tokens on the new weights."""
    _, port = models
    saved = {k: v.clone() for k, v in port.state_dict().items()}
    try:
        pred, eng = aot.warm_start(port, _copy(bundle, tmp_path),
                                   wire_cache=False,
                                   enable_prefix_cache=True)
        prompts = _prompts(5, (13,))
        pred.generate(prompts, max_new_tokens=4)
        _load_in_place(port, 3)
        got = pred.generate(prompts, max_new_tokens=4)
        want = ContinuousBatchingPredictor(port, device="cpu",
                                           **GEO).generate(prompts, 4)
        assert got == want and pred.stats["prefix_hits"] == 0
        assert eng.stats["misses"] == 0
    finally:
        port.load_state_dict(saved)


def test_streams_through_the_engine_equal_eager(models, bundle, tmp_path):
    """generate_stream with a cancellation and an expired deadline through
    a warm-started predictor: the eager predictor's events, results and
    stats, and no bucket miss."""
    _, port = models
    pred, eng = aot.warm_start(port, _copy(bundle, tmp_path),
                               wire_cache=False)
    prompts = _prompts(3, (8, 16, 5))

    def run(cb):
        st = cb.generate_stream(prompts, max_new_tokens=6,
                                deadline_s=[None, None, 0.0])
        evs = []
        for ev in st:
            evs.append((ev.request, ev.kind, ev.token, ev.index, ev.status,
                        ev.span))
            if ev.request == 0 and ev.index == 2:
                st.cancel(0)
        return evs, st.results, list(st.status)
    eager = ContinuousBatchingPredictor(port, device="cpu", **GEO)
    got = run(pred)
    assert got == run(eager)
    assert got[2] == ["cancelled", "ok", "deadline"]
    assert pred.stats == eager.stats
    assert eng.stats["misses"] == 0 and eng.stats["hits"] > 0


# --------------------------------------------------------- padded spans --

@pytest.mark.parametrize("ragged", [False, True], ids=["table", "ragged"])
def test_padded_span_index_matches_unpadded(models, ragged):
    """A mixed step and a verify step with the span index padded to B * Qb
    over the trash page leave every other page as the unpadded index
    does, and give the same outputs."""
    from paddle_tpu_torch.kernels.paged_attention import RaggedMetaBuilder
    _, port = models
    cb = ContinuousBatchingPredictor(port, device="cpu", max_batch_size=2,
                                     page_size=8, max_seq_len=64,
                                     use_ragged=ragged, spec_draft_tokens=3)
    g = torch.Generator().manual_seed(0)
    for t in cb.pool.k + cb.pool.v:
        t.copy_(torch.randn(t.shape, generator=g))
    tables = np.full((2, cb.pages_per_seq), cb._trash, np.int32)
    tables[0, :2], tables[1, :3] = [1, 2], [3, 4, 5]
    ctx = np.asarray([5, 22], np.int32)
    q_lens = np.asarray([4, 1], np.int32)
    span_ids = np.asarray([[7, 1, 1, 1], [9, 0, 0, 0]], np.int64)
    meta = None
    if ragged:
        mb = RaggedMetaBuilder(2, cb.pages_per_seq, cb.page, cb._trash)
        for b in range(2):
            mb.set_slot(b, tables[b], int(ctx[b] + q_lens[b]))
        meta = torch.from_numpy(mb.stacked())
    ops = [torch.from_numpy(a) for a in (tables, ctx, span_ids, q_lens)]
    tok = torch.tensor([7, 9], dtype=torch.int32)
    start = [t.clone() for t in cb.pool.k + cb.pool.v]
    outs, pools = {}, {}
    for step in ("mixed", "spec"):
        fn = cb._raw_mixed_step if step == "mixed" else cb._raw_spec_step
        for padded in (False, True):
            for t, s in zip(cb.pool.k + cb.pool.v, start):
                t.copy_(s)
            span = cb._span(tables, ctx, q_lens, 4 if padded else None)
            outs[step, padded] = fn(*ops, tok, span, meta)
            pools[step, padded] = [t.clone() for t in cb.pool.k + cb.pool.v]
        for a, b in zip(outs[step, False], outs[step, True]):
            assert torch.equal(a, b)
        keep = torch.ones(cb.pool.num_pages, dtype=torch.bool)
        keep[cb._trash] = False
        for a, b in zip(pools[step, False], pools[step, True]):
            assert torch.equal(a[keep], b[keep])
    pad = span_index(*ops[:2], ops[3], 8, 4, cb._trash)
    assert isinstance(pad, SpanIndex) and pad.rows.shape == (4, 8)
    real = pad.rows[1] >= 0
    assert int(real.sum()) == 5
    assert (pad.rows[2][~real] == cb._trash).all()


# ------------------------------------------------------------------- card --

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    return torch.device("cuda")


def _card_model(dev, dtype="bfloat16"):
    cfg = LlamaConfig.tiny(hidden_size=256, num_attention_heads=2,
                           num_key_value_heads=2, intermediate_size=512,
                           dtype=dtype)
    return LlamaForCausalLM(cfg, device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(0))


CARD_CFGS = {
    "table": dict(use_ragged=False, max_batch_size=2, page_size=16,
                  max_seq_len=128),
    "chunk_spec_ragged": dict(use_ragged=True, max_batch_size=2,
                              page_size=16, max_seq_len=128,
                              prefill_chunk_tokens=32, spec_draft_tokens=3,
                              enable_prefix_cache=False),
    "sampled": dict(use_ragged=True, max_batch_size=2, page_size=16,
                    max_seq_len=128, prefill_chunk_tokens=32,
                    spec_draft_tokens=3, sampling_enabled=True,
                    enable_prefix_cache=False),
}


def _card_prompts():
    base = _prompts(5, (37,))[0]
    return [base, base + _prompts(6, (10,))[0]] + _cyclic(2, 24) + \
        _prompts(7, (70,))


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", list(CARD_CFGS))
def test_capture_equals_eager_bitwise(cuda, tmp_path, cfg):
    """Every program kind replayed from its graph gives the eager tokens,
    stats and, bit for bit, the pages (the trash page aside); the
    captured forward gives the eager logits bit for bit; warm_start
    leaves every page but the trash page untouched."""
    model = _card_model(cuda)
    kw = CARD_CFGS[cfg]
    prompts = _card_prompts()
    sampling = [None, ps.SamplingParams(temperature=0.8, top_k=20, seed=3),
                None, ps.SamplingParams(temperature=1.0, seed=5),
                None] if kw.get("sampling_enabled") else None
    b = aot.EngineBuilder(model, prompt_buckets=(16, 32, 64), **kw)
    b.add_traffic(prompts, max_new_tokens=2, sampling=sampling)
    b.build(str(tmp_path / "e"))
    pred, eng = aot.warm_start(model, str(tmp_path / "e"))
    keep = torch.ones(pred.pool.num_pages, dtype=torch.bool)
    keep[pred._trash] = False
    assert all(not t[keep].any() for t in pred.pool.k + pred.pool.v)
    eager = ContinuousBatchingPredictor(model, device=cuda, **kw)
    want = eager.generate(prompts, max_new_tokens=16, sampling=sampling)
    got = pred.generate(prompts, max_new_tokens=16, sampling=sampling)
    assert got == want and pred.stats == eager.stats
    assert eng.stats["misses"] == 0 and eng.stats["hits"] > 0
    for a, b_ in zip(pred.pool.k + pred.pool.v, eager.pool.k + eager.pool.v):
        assert torch.equal(a[keep], b_[keep])
    ids = torch.randint(2, 256, (1, 16), device=cuda)
    fwd = eng.program(("forward", (1, 16)))
    assert torch.equal(fwd(ids), pred._raw_forward(ids))


@pytest.mark.cuda
def test_replay_adds_the_captured_launch_counts(cuda, tmp_path):
    model = _card_model(cuda)
    aot.build_engine(model, str(tmp_path / "e"), prompt_buckets=(16,),
                     batch_sizes=(1,), use_ragged=True, max_batch_size=2,
                     page_size=16, max_seq_len=64, sampling_enabled=True)
    pred, eng = aot.warm_start(model, str(tmp_path / "e"))
    sig = next(s for s in eng._table if s[0] == "decode_sample")
    prog = eng.program(sig)
    assert prog.launches["categorical_rows"] == 1
    assert prog.launches["rms_norm"] == 2 * 2 + 1
    assert prog.launches["ragged_decode"] == 2
    fn, args = pred._idle_program(sig)
    reset_launch_counts()
    prog(*args)
    torch.cuda.synchronize()
    assert {k: n for k, n in launch_counts.items() if n} == prog.launches


@pytest.mark.cuda
def test_weight_change_flushes_prefix_cache_on_the_card(cuda, tmp_path):
    """Through replayed graphs: two prompts served (one extends the
    other), the weights loaded in place, the prompts served again: a
    fresh eager predictor's tokens and prefix-cache hits and misses on
    the new weights (the graphs read the weights by address, so the
    in-place load needs only the flush)."""
    model = _card_model(cuda)
    kw = CARD_CFGS["table"]
    prompts = _card_prompts()[:2]
    b = aot.EngineBuilder(model, prompt_buckets=(16, 32, 64), **kw)
    b.add_traffic(prompts, max_new_tokens=2)
    b.build(str(tmp_path / "e"))
    pred, eng = aot.warm_start(model, str(tmp_path / "e"))
    pred.generate(prompts, max_new_tokens=8)
    before = dict(pred.stats)
    _load_in_place(model, 1)
    got = pred.generate(prompts, max_new_tokens=8)
    fresh = ContinuousBatchingPredictor(model, device=cuda, **kw)
    want = fresh.generate(prompts, max_new_tokens=8)
    assert got == want
    for k in ("prefix_hits", "prefix_partial_hits", "prefix_misses"):
        assert pred.stats[k] - before[k] == fresh.stats[k]
    assert eng.stats["misses"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", ["table", "chunk_spec_ragged"])
def test_stream_evictions_through_graphs_equal_eager(cuda, tmp_path, cfg):
    """A cancellation and an expired deadline in a stream through replayed
    graphs: a slot freed while its next step is in flight (the step still
    writes one K/V row into the freed pages, on the same stream, before
    the next owner's prefill) leaves the eager events, results, stats and
    pages (the trash page aside) bit for bit."""
    model = _card_model(cuda)
    kw = CARD_CFGS[cfg]
    prompts = _card_prompts()
    b = aot.EngineBuilder(model, prompt_buckets=(16, 32, 64), **kw)
    b.add_traffic(prompts, max_new_tokens=2)
    b.build(str(tmp_path / "e"))
    pred, eng = aot.warm_start(model, str(tmp_path / "e"))
    eager = ContinuousBatchingPredictor(model, device=cuda, **kw)

    def run(cb):
        st = cb.generate_stream(prompts, max_new_tokens=16,
                                deadline_s=[None, None, 0.0, None, None])
        evs = []
        for ev in st:
            evs.append((ev.request, ev.kind, ev.token, ev.index, ev.status,
                        ev.span))
            if ev.request == 0 and ev.kind == "token" and ev.index >= 3:
                st.cancel(0)
        return evs, st.results, list(st.status)
    got, want = run(pred), run(eager)
    assert got == want
    assert got[2][0] == "cancelled" and got[2][2] == "deadline"
    assert pred.stats == eager.stats and eng.stats["misses"] == 0
    keep = torch.ones(pred.pool.num_pages, dtype=torch.bool)
    keep[pred._trash] = False
    for a, b_ in zip(pred.pool.k + pred.pool.v, eager.pool.k + eager.pool.v):
        assert torch.equal(a[keep], b_[keep])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,kv", [("float16", None),
                                      ("bfloat16", "float32")],
                         ids=["f16", "bf16_kv_f32"])
def test_capture_f16_and_mixed_pool_equal_eager(cuda, tmp_path, dtype, kv):
    """An f16 model with its default pool, and a bf16 model over f32
    pages (block-table decode, chunked + speculative steps, a suffix
    prefill): replayed graphs give eager's tokens, stats and pages bit
    for bit, and replay eager's launches kernel by kernel and instance
    by instance (q dtype, page dtype)."""
    from paddle_tpu_torch.kernels import dtype_launch_counts
    model = _card_model(cuda, dtype)
    kw = dict(CARD_CFGS["table"], prefill_chunk_tokens=32,
              spec_draft_tokens=3, kv_dtype=kv)
    prompts = _card_prompts()
    b = aot.EngineBuilder(model, prompt_buckets=(16, 32, 64), **kw)
    b.add_traffic(prompts, max_new_tokens=2)
    b.build(str(tmp_path / "e"))
    pred, eng = aot.warm_start(model, str(tmp_path / "e"))
    eager = ContinuousBatchingPredictor(model, device=cuda, **kw)
    assert pred.pool.dtype == eager.pool.dtype == (kv or dtype)
    counts = []
    for cb in (eager, pred):
        reset_launch_counts()
        out = cb.generate(prompts, max_new_tokens=16)
        torch.cuda.synchronize()
        counts.append((out, dict(launch_counts), dict(dtype_launch_counts)))
    assert counts[1] == counts[0]
    assert pred.stats == eager.stats and eng.stats["misses"] == 0
    pages = kv or dtype
    assert counts[0][2][("paged_varq", dtype, pages)] > 0
    assert all((q, p) == (dtype, pages) for (name, q, p) in counts[0][2]
               if name in ("paged_decode", "paged_varq"))
    keep = torch.ones(pred.pool.num_pages, dtype=torch.bool)
    keep[pred._trash] = False
    for a, b_ in zip(pred.pool.k + pred.pool.v, eager.pool.k + eager.pool.v):
        assert torch.equal(a[keep], b_[keep])
