"""float16 models and KV pools of another dtype than the model's, against
the JAX reference.

The same tiny Llama (the reference's weights moved with ``convert``, then
both cast with ``.astype(dtype)`` / ``.to(dtype)``, which round alike)
serves the same prompts through the reference's and the port's
``ContinuousBatchingPredictor`` for each (model dtype, ``kv_dtype``) pair
below: greedy tokens and the stats both keep must be equal. The plain
kernel versions take f16 and mixed q / page dtypes; each is held to a
named reference path per pair: the reference's XLA path rounds P to V's
dtype before P.V (as the plain paged, span and flash versions do), its
Pallas kernels (interpret mode) keep P in f32 (as the plain ragged
version does), so a pair with 16-bit pages is held to the other path
within the narrower dtype's tolerance.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import ContinuousBatchingPredictor as RefPredictor
from paddle_tpu.models import LlamaConfig as RefConfig
from paddle_tpu.models import LlamaForCausalLM as RefLlama

from paddle_tpu_torch.convert import (export_reference_state_dict,
                                      load_reference_state_dict)
from paddle_tpu_torch.generation.kv_cache import (PagedCacheEntry,
                                                  PagedKVPool,
                                                  decode_index,
                                                  paged_cache_update_attend)
from paddle_tpu_torch.inference import ContinuousBatchingPredictor
from paddle_tpu_torch.kernels import attention as A
from paddle_tpu_torch.kernels import paged_attention as P
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

GEOM = dict(max_batch_size=2, page_size=8, max_seq_len=128)
# (model dtype, kv_dtype): f16 with its default pool, and four mixed pools
PAIRS = [("float16", None), ("bfloat16", "float32"), ("float32", "bfloat16"),
         ("float16", "float32"), ("bfloat16", "float16")]
# the port's arguments (the reference serves its XLA block-table route)
CONFIGS = {"table": dict(use_ragged=False),
           "ragged": dict(use_ragged=True),
           "chunk_spec": dict(use_ragged=True, prefill_chunk_tokens=16,
                              spec_draft_tokens=4)}
# plain version vs a reference path: the same math with sums in another
# order, rounded to the output's dtype (f16: ~4 ulps of 2^-10, bf16: as
# chip_smoke.py's bf16 tolerance); where the two round P differently, the
# narrower dtype's
TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "float16": dict(atol=1e-3, rtol=4e-3),
       "bfloat16": dict(atol=5e-3, rtol=2e-2)}
_WIDTH = {"float32": 0, "float16": 1, "bfloat16": 2}


def _narrow(*dts):
    return max(dts, key=_WIDTH.__getitem__)


_MODELS = {}


def _pair(dtype):
    """(reference, port) tiny Llamas with equal weights in ``dtype``,
    built once per dtype."""
    if dtype not in _MODELS:
        paddle.seed(0)
        ref = RefLlama(RefConfig.tiny(tensor_parallel=False))
        port = LlamaForCausalLM(LlamaConfig.tiny(tensor_parallel=False),
                                device="cpu")
        load_reference_state_dict(port, {k: np.asarray(v.numpy()) for k, v
                                         in ref.state_dict().items()})
        if dtype != "float32":
            ref.astype(dtype)
            port.to(getattr(torch, dtype))
        _MODELS[dtype] = (ref, port)
    return _MODELS[dtype]


def _predictors(dtype, kv, **kw):
    ref, port = _pair(dtype)
    g = dict(GEOM, **kw)
    port_cb = ContinuousBatchingPredictor(port, device="cpu", kv_dtype=kv,
                                          **g)
    g.pop("use_ragged", None)
    return RefPredictor(ref, kv_dtype=kv, **g), port_cb


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(2, 256, (n,)).tolist() for n in lens]


def _cyclic(n, length):
    """Tiled-motif prompts: the drafter finds matches in them."""
    rng = np.random.RandomState(0)
    motifs = [rng.randint(2, 256, (3 + s % 4,)).tolist() for s in range(24)]
    return [(motifs[s] * (length // 3 + 1))[:length] for s in (2, 9, 16)][:n]


def _shared(ref, port):
    return {k: ref.stats[k] for k in port.stats}, dict(port.stats)


def _ids(pairs):
    return [f"{m}-kv_{kv or 'default'}" for m, kv in pairs]


# -------------------------------------------------------------- serving --

@pytest.mark.parametrize("cfg", list(CONFIGS))
@pytest.mark.parametrize("dtype,kv", PAIRS, ids=_ids(PAIRS))
def test_predictor_matches_reference(dtype, kv, cfg):
    """Block-table, ragged, and chunked + speculative serving: tokens and
    shared stats equal the reference's; the pool has ``kv_dtype``."""
    ref, port = _predictors(dtype, kv, **CONFIGS[cfg])
    prompts = (_prompts(2, (9, 4, 13)) if cfg != "chunk_spec"
               else [_prompts(3, (40,))[0]] + _cyclic(2, 24))
    want = ref.generate(prompts, max_new_tokens=10)
    assert port.generate(prompts, max_new_tokens=10) == want
    assert port.last_status == ["ok"] * len(prompts)
    want_s, got_s = _shared(ref, port)
    assert got_s == want_s
    assert port.pool.dtype == ref.pool.dtype == (kv or dtype)
    assert all(t.dtype == getattr(torch, kv or dtype)
               for t in port.pool.k + port.pool.v)
    if cfg == "chunk_spec":
        assert got_s["chunked_requests"] == len(prompts)
        assert got_s["spec_accepted"] > 0


@pytest.mark.parametrize("dtype,kv", PAIRS, ids=_ids(PAIRS))
def test_suffix_prefill_matches_reference(dtype, kv):
    """A cached prompt extended: the suffix prefill concatenates cached
    pages (``kv_dtype``) with the suffix's K/V (the model's dtype),
    promoted as the reference's concat promotes, then attends (q and K/V
    of different dtypes where they differ)."""
    ref, port = _predictors(dtype, kv, max_seq_len=64)
    base = _prompts(5, (11,))[0]
    ext = base + _prompts(6, (6,))[0]
    for batch in ([base], [ext], [base, ext]):
        assert port.generate(batch, max_new_tokens=7) == ref.generate(
            batch, max_new_tokens=7)
        want_s, got_s = _shared(ref, port)
        assert got_s == want_s
    assert port.stats["prefix_partial_hits"] >= 1


def test_f16_sampled_serving_matches_reference():
    """An f16 model, ragged + chunked + speculative with two of three
    requests sampled: f16 logits reach the draws as f32, as the
    reference casts them."""
    from paddle_tpu.generation.sampling import SamplingParams as RSP
    from paddle_tpu_torch.generation.sampling import SamplingParams
    ref, port = _predictors("float16", None, sampling_enabled=True,
                            **CONFIGS["chunk_spec"])
    prompts = [_prompts(3, (40,))[0]] + _cyclic(2, 24)
    mix = [None, dict(temperature=0.8, top_k=20, seed=3),
           dict(temperature=0.6, top_p=0.9, seed=7)]
    want = ref.generate(prompts, max_new_tokens=10, sampling=[
        None if m is None else RSP(**m) for m in mix])
    got = port.generate(prompts, max_new_tokens=10, sampling=[
        None if m is None else SamplingParams(**m) for m in mix])
    assert got == want and port.last_status == ["ok"] * 3
    want_s, got_s = _shared(ref, port)
    assert got_s == want_s
    assert port.sampling_stats["sampled_requests"] == 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_kv_dtype_defaults_to_the_weights(dtype):
    ref, port = _predictors(dtype, None, max_seq_len=64)
    assert port.kv_dtype == port.pool.dtype == ref.pool.dtype == dtype
    assert port.pool.k[0].dtype == getattr(torch, dtype)
    with pytest.raises(ValueError, match="KV pages"):
        ContinuousBatchingPredictor(_pair(dtype)[1], device="cpu",
                                    kv_dtype="float64", **GEOM)


def test_page_writes_cast_to_the_pool():
    """The decode write casts bf16 K/V into f32 pages (indexed assignment
    refuses another dtype); the pool takes a name or a torch dtype."""
    pool = PagedKVPool(1, 4, 4, 2, 64, dtype=torch.float32)
    assert pool.dtype == "float32"
    tables = torch.tensor([[0, 1]], dtype=torch.int32)
    ctx = torch.tensor([5], dtype=torch.int32)
    rs = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rs.randn(1, 1, h, 64).astype(np.float32))
               .bfloat16() for h in (4, 2, 2))
    entry = PagedCacheEntry(pool.k[0], pool.v[0], tables, ctx,
                            decode_index(tables, ctx, 4))
    out, _ = paged_cache_update_attend(entry, q, k, v)
    assert out.dtype == torch.bfloat16
    assert torch.equal(pool.k[0][1, 1], k[0, 0].float())
    assert torch.equal(pool.v[0][1, 1], v[0, 0].float())
    pool.write(0, torch.tensor([2]), torch.tensor([3]), k[:, 0], v[:, 0])
    assert torch.equal(pool.k[0][2, 3], k[0, 0].float())
    assert PagedKVPool(1, 2, 4, 2, 64, dtype="float16").k[0].dtype == \
        torch.float16


def test_aot_kv_dtype_override_invalidates_geometry(tmp_path):
    """A bundle built with ``kv_dtype`` records it; a warm start that
    overrides it is a geometry invalidation, and one that repeats it (as
    a torch dtype) serves the eager tokens."""
    from paddle_tpu_torch.inference import aot
    _, port = _pair("bfloat16")
    kw = dict(GEOM, max_seq_len=64, enable_prefix_cache=False)
    path = str(tmp_path / "e")
    aot.build_engine(port, path, prompt_buckets=(8, 16), batch_sizes=(1,),
                     wire_cache=False, kv_dtype="float32", **kw)
    assert aot.EngineBundle(path).manifest()["geometry"]["kv_dtype"] == \
        "float32"
    with pytest.raises(aot.BundleInvalid) as ei:
        aot.warm_start(port, path, strict=True, wire_cache=False,
                       kv_dtype="bfloat16")
    assert ei.value.reason == "geometry"
    pred, _ = aot.warm_start(port, path, strict=True, wire_cache=False,
                             kv_dtype=torch.float32)
    assert pred.pool.dtype == "float32"
    prompts = _prompts(4, (9, 5))
    eager = ContinuousBatchingPredictor(port, device="cpu",
                                        kv_dtype="float32", **kw)
    assert pred.generate(prompts, max_new_tokens=6) == eager.generate(
        prompts, max_new_tokens=6)


# ------------------------------------------------------------- models --

def test_llama_config_dtype_divergence():
    """Pinned divergence: ``LlamaConfig(dtype=...)`` builds parameters of
    that dtype in the port and f32 ones in the reference (which reads
    no dtype from its config; ``.astype`` casts a built model)."""
    port = LlamaForCausalLM(LlamaConfig.tiny(dtype="float16"), device="cpu")
    assert {p.dtype for p in port.parameters()} == {torch.float16}
    paddle.seed(0)
    ref = RefLlama(RefConfig.tiny(dtype="float16"))
    assert {str(p.dtype) for p in ref.parameters()} == {"float32"}
    # a cast model keeps its RoPE tables in the model's dtype in both
    ref.astype("float16")
    port_cast = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu").to(
        torch.float16)
    assert str(ref.llama.rope_cos.dtype) == "float16"
    assert port_cast.llama.rope_cos.dtype == torch.float16


def test_f16_state_dict_round_trip_and_logits():
    """f16 weights move both ways (numpy keeps float16), and the f16
    forward gives the reference's f16 logits."""
    ref, port = _pair("float16")
    state = export_reference_state_dict(port)
    want = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    assert set(state) == set(want)
    for k, a in state.items():
        assert a.dtype == np.float16 and np.array_equal(a, want[k])
    fresh = LlamaForCausalLM(LlamaConfig.tiny(tensor_parallel=False,
                                              dtype="float16"), device="cpu")
    load_reference_state_dict(fresh, want)
    ids = np.asarray(_prompts(8, (12,)), np.int64)
    with torch.no_grad():
        got = fresh(torch.from_numpy(ids)).float().numpy()
    ref_lg = np.asarray(ref(paddle.to_tensor(ids)).numpy(), np.float32)
    np.testing.assert_allclose(got, ref_lg, **TOL["float16"])
    assert (got.argmax(-1) == ref_lg.argmax(-1)).all()


def test_f16_static_generate_matches_reference():
    """``generate()``'s static-cache route on an f16 model: a left-padded
    batch greedy, token for token."""
    ref, port = _pair("float16")
    ids = np.asarray(_prompts(9, (7, 7)), np.int64)
    mask = np.ones_like(ids)
    mask[1, :3] = 0
    want, _ = ref.generate(paddle.to_tensor(ids),
                           attention_mask=paddle.to_tensor(mask),
                           max_new_tokens=6)
    got, _ = port.generate(torch.from_numpy(ids),
                           attention_mask=torch.from_numpy(mask),
                           max_new_tokens=6)
    assert np.array_equal(got.numpy(), np.asarray(want.numpy()))


def test_f16_llm_predictor_matches_reference():
    """``LLMPredictor`` (buckets, micro-batches, the static route) on the
    f16 model gives the reference's f16 tokens."""
    from paddle_tpu.inference import LLMPredictor as RefLLM
    from paddle_tpu_torch.inference import LLMPredictor
    ref, port = _pair("float16")
    prompts = [[5, 6, 7], [8, 9, 10, 11, 12], [13], [4] * 11]
    want = RefLLM(ref, max_batch_size=2).generate(prompts, max_new_tokens=5)
    assert LLMPredictor(port, max_batch_size=2).generate(
        prompts, max_new_tokens=5) == want


# ------------------------------------------------------ plain kernels --

def _j(a, dt):
    import jax.numpy as jnp
    return jnp.asarray(a).astype(dt)


def _t(a, dt):
    return torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dt))


def _f(x):
    if torch.is_tensor(x):
        return x.float().numpy()
    import jax.numpy as jnp
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.fixture(params=["xla", "pallas_interpret"])
def ref_mode(request):
    from paddle_tpu.framework.flags import get_flags, set_flags
    if request.param == "xla":
        yield "xla"
        return
    old = get_flags(["use_pallas_kernels", "pallas_interpret"])
    set_flags({"use_pallas_kernels": True, "pallas_interpret": True})
    try:
        yield "pallas_interpret"
    finally:
        set_flags({k.removeprefix("FLAGS_"): v for k, v in old.items()})


KPAIRS = [("float16", "float16"), ("bfloat16", "float32"),
          ("float32", "bfloat16"), ("float16", "float32"),
          ("bfloat16", "float16")]


def _pool_case(rs, page=4, npg=20):
    """H = Hkv = 8, D = 128 (the Pallas kernels' geometry): q [4, 8, 128],
    pages [20, 4, 8, 128], shuffled tables, contexts across pages."""
    q = (rs.randn(4, 8, 128) * 0.5).astype(np.float32)
    kp = (rs.randn(npg, page, 8, 128) * 0.5).astype(np.float32)
    vp = rs.randn(npg, page, 8, 128).astype(np.float32)
    tables = rs.permutation(npg)[:16].reshape(4, 4).astype(np.int32)
    return q, kp, vp, tables


def _meta(tables, lens, page):
    from paddle_tpu_torch.kernels.paged_attention import build_ragged_meta
    m = build_ragged_meta(tables, lens, page)
    return m, torch.from_numpy(np.stack([m[k] for k in
                                         P.RaggedMetaBuilder.FIELDS]))


def _path_tol(ref_mode, qd, kd, p_rounded):
    """The plain version rounds P to V's dtype (``p_rounded``) or keeps
    it f32; the reference's XLA path rounds it, its Pallas kernels keep
    it: on the same path, q's tolerance, across, the narrower one's."""
    same = (ref_mode == "xla") == p_rounded or kd == "float32"
    return TOL[qd] if same else TOL[_narrow(qd, kd)]


@pytest.mark.parametrize("qd,kd", KPAIRS, ids=[f"{a}-{b}" for a, b in KPAIRS])
def test_paged_plain_dtypes_match_reference(ref_mode, qd, kd):
    from paddle_tpu.kernels.paged_attention import paged_attention as ref
    import jax.numpy as jnp
    rs = np.random.RandomState(3)
    q, kp, vp, tables = _pool_case(rs)
    lens = np.asarray([5, 16, 1, 11], np.int32)
    want = _f(ref(_j(q, qd), _j(kp, kd), _j(vp, kd), jnp.asarray(tables),
                  jnp.asarray(lens), interpret=ref_mode != "xla"))
    got = P.paged_attention(_t(q, qd), _t(kp, kd), _t(vp, kd),
                            torch.from_numpy(tables), torch.from_numpy(lens))
    assert got.dtype == getattr(torch, qd)
    np.testing.assert_allclose(_f(got), want,
                               **_path_tol(ref_mode, qd, kd, True))


@pytest.mark.parametrize("qd,kd", KPAIRS, ids=[f"{a}-{b}" for a, b in KPAIRS])
def test_ragged_plain_dtypes_match_reference(ref_mode, qd, kd):
    """Against the interpret-mode ``_ragged_kernel`` (P in f32 in both),
    and against the reference's XLA block-table path."""
    import jax.numpy as jnp
    from paddle_tpu.kernels import paged_attention as R
    rs = np.random.RandomState(4)
    q, kp, vp, tables = _pool_case(rs)
    lens = np.asarray([5, 16, 1, 11], np.int32)
    meta, mt = _meta(tables, lens, 4)
    if ref_mode == "xla":
        want = R._paged_attention_xla(_j(q, qd), _j(kp, kd), _j(vp, kd),
                                      jnp.asarray(tables), jnp.asarray(lens),
                                      128 ** -0.5)
    else:
        want = R.paged_attention_ragged(
            _j(q, qd), _j(kp, kd), _j(vp, kd), jnp.asarray(lens),
            {k: jnp.asarray(v) for k, v in meta.items()}, interpret=True)
    got = P.paged_attention_ragged(_t(q, qd), _t(kp, kd), _t(vp, kd),
                                   torch.from_numpy(lens), mt)
    assert got.dtype == getattr(torch, qd)
    np.testing.assert_allclose(_f(got), _f(want),
                               **_path_tol(ref_mode, qd, kd, False))


@pytest.mark.parametrize("qd,kd", KPAIRS, ids=[f"{a}-{b}" for a, b in KPAIRS])
def test_varq_plain_dtypes_match_reference(ref_mode, qd, kd):
    """Spans of 6 / 1 / 3 / 2 rows: against ``_paged_attention_varq_xla``
    and the interpret-mode ``_ragged_varq_kernel``, on the real rows.
    Slot 2's span starts at key 0, so its first row rests on one key (the
    output is one V row, as the card's f32-page instance must give it)."""
    import jax.numpy as jnp
    from paddle_tpu.kernels import paged_attention as R
    rs = np.random.RandomState(5)
    _, kp, vp, tables = _pool_case(rs)
    q = (rs.randn(4, 6, 8, 128) * 0.5).astype(np.float32)
    ql = np.asarray([6, 1, 3, 2], np.int32)
    kl = np.asarray([10, 16, 3, 7], np.int32)
    meta, mt = _meta(tables, kl, 4)
    if ref_mode == "xla":
        want = R.paged_attention_varq(_j(q, qd), _j(kp, kd), _j(vp, kd),
                                      jnp.asarray(tables), jnp.asarray(kl),
                                      jnp.asarray(ql))
    else:
        want = R.paged_attention_ragged_varq(
            _j(q, qd), _j(kp, kd), _j(vp, kd), jnp.asarray(kl),
            jnp.asarray(ql), {k: jnp.asarray(v) for k, v in meta.items()},
            interpret=True)
    rows = np.arange(6)[None, :] < ql[:, None]
    for got in (P.paged_attention_varq(_t(q, qd), _t(kp, kd), _t(vp, kd),
                                       torch.from_numpy(tables),
                                       torch.from_numpy(kl),
                                       torch.from_numpy(ql)),
                P.paged_attention_ragged_varq(_t(q, qd), _t(kp, kd),
                                              _t(vp, kd),
                                              torch.from_numpy(kl),
                                              torch.from_numpy(ql), mt)):
        assert got.dtype == getattr(torch, qd)
        np.testing.assert_allclose(_f(got)[rows], _f(want)[rows],
                                   **_path_tol(ref_mode, qd, kd, True))


@pytest.mark.parametrize("qd,kd", KPAIRS, ids=[f"{a}-{b}" for a, b in KPAIRS])
def test_flash_plain_dtypes_match_reference(ref_mode, qd, kd):
    """The suffix prefill's attention: q [2, 8, 4, 64] over 20 keys of
    2 KV heads under a mask (causal by the mask, key padding on one
    row): against the reference's XLA path and its Pallas forward."""
    from paddle_tpu.kernels.attention import flash_attention_jax
    import jax.numpy as jnp
    rs = np.random.RandomState(6)
    sq, sk = 8, 20
    q = rs.randn(2, sq, 4, 64).astype(np.float32)
    k, v = (rs.randn(2, sk, 2, 64).astype(np.float32) for _ in range(2))
    j = np.arange(sk)[None, :] - (sk - sq)
    mask = np.where(j <= np.arange(sq)[:, None], 0.0, -1e30)
    mask = np.broadcast_to(mask.astype(np.float32), (2, 1, sq, sk)).copy()
    mask[1, ..., :5] = -1e30
    want = flash_attention_jax(_j(q, qd), _j(k, kd), _j(v, kd),
                               mask=jnp.asarray(mask))
    got = A.flash_attention_bshd(_t(q, qd), _t(k, kd), _t(v, kd),
                                 attn_mask=torch.from_numpy(mask))
    assert got.dtype == getattr(torch, qd)
    np.testing.assert_allclose(_f(got), _f(want),
                               **_path_tol(ref_mode, qd, kd, True))


def test_kernel_wrappers_refuse_f64_and_split_kv_dtypes():
    """On a CUDA tensor the wrappers check before launching: f64, and K
    and V pages of different dtypes, raise (no device is needed to see
    the refusal: the check comes first)."""
    q = torch.zeros(1, 8, 2, 64, dtype=torch.float64)
    with pytest.raises((TypeError, ValueError)):
        A.flash_attention_kernel(q, q, q, 0.1)
    kp = torch.zeros(3, 4, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        P._check_paged("paged_decode", torch.zeros(1, 2, 64), kp,
                       kp.float(), 3, ())
    with pytest.raises(TypeError):
        P._check_paged("paged_decode", torch.zeros(1, 2, 64,
                                                   dtype=torch.float64),
                       kp, kp, 3, ())
    with pytest.raises(TypeError, match="q's"):
        A._check("flash_bwd_dq", torch.zeros(1, 8, 2, 64),
                 kp[:1, :, :, :].reshape(1, 4, 2, 64),
                 kp[:1].reshape(1, 4, 2, 64), None, None,
                 dtypes=A._BWD_DTYPES, mixed=False)


def test_jit_save_exports_an_f16_llama(tmp_path):
    """The custom ops (plain, fake) take f16 and q over K/V of another
    dtype, so ``jit.save`` exports an f16 Llama and the artifact gives
    the live model's logits."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.inference import Config, create_predictor
    p = LlamaForCausalLM(LlamaConfig.tiny(dtype="float16"), device="cpu")
    p.init_weights(torch.Generator().manual_seed(0)).eval()
    path = str(tmp_path / "llama16")
    jit.save(p, path, input_spec=[jit.InputSpec([1, 12], "int64")])
    ids = torch.randint(1, 256, (1, 12))
    cfg = Config(path + ".pdmodel")
    cfg.disable_gpu()
    got = create_predictor(cfg).run([ids.numpy()])[0]
    with torch.no_grad():
        want = p(ids).float().numpy()
    np.testing.assert_array_equal(np.asarray(got, np.float32), want)
    ops = torch.ops.paddle_tpu_torch
    q = torch.randn(2, 3, 4, 64).bfloat16().to("meta")
    k = torch.randn(2, 7, 2, 64).to("meta")
    out, lse = ops.flash_fwd(q, k, k, None, None, 0.125, False)
    assert (out.dtype, lse.dtype) == (torch.bfloat16, torch.float32)
    x = torch.randn(5, 64).half()
    assert ops.rms_norm(x, torch.ones(64).half(), 1e-6).dtype == torch.float16
