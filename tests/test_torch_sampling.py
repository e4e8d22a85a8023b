"""On-device sampling of the port (``paddle_tpu_torch/kernels/sampling.py``,
``generation/sampling.py``, the sampling paths of
``ContinuousBatchingPredictor`` and ``GenerationMixin.generate``) against
the reference package run on the CPU.

The key stream is jax's threefry (``jax_threefry_partitionable``), so key
words, random bits and uniforms (f32, and the f64 acceptance uniforms the
reference draws with x64 on) must equal the reference's bit for bit, and
sampled tokens token for token. Tolerances: the Gumbel noise within atol
= rtol = 1e-6 (the two CPU ``log`` implementations differ by an f32 ulp,
4.8e-7 at |g| ~ 5, and near g = 0 the inner log's ulp is all there is);
filtered logits atol = rtol = 1e-6 (softmax and cumsum sum in other
orders); log-probabilities 1e-5.

The ``cuda`` cases hold the kernel's two entry points to the plain
version on the card and skip without one; the module imports nothing of
JAX (the reference is imported inside fixtures), so the card runs them
with ``python -m pytest --noconftest -m cuda tests/test_torch_sampling.py``.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.generation import sampling as ps
from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts
from paddle_tpu_torch.kernels import sampling as ks

GUMBEL_TOL = dict(rtol=1e-6, atol=1e-6)
LOGIT_TOL = dict(rtol=1e-6, atol=1e-6)
SEEDS = (0, 7, -3, 2 ** 31 - 1)


@pytest.fixture(scope="module")
def jr():
    """The reference package (sets jax_enable_x64) and jax.random."""
    import jax
    import paddle_tpu  # noqa: F401
    return jax


def _jkey(jax, seed, counter):
    return jax.random.fold_in(jax.random.key(np.uint32(seed & 0xFFFFFFFF)),
                              np.uint32(counter))


# ----------------------------------------------------------- key stream --
@pytest.mark.parametrize("seed", SEEDS)
def test_key_words_and_bits_bitwise(jr, seed):
    import jax.numpy as jnp
    for c in (0, 5, 123456):
        k = _jkey(jr, seed, c)
        pk = ks.fold_in(ks.key(seed), c)
        assert [int(pk[0]), int(pk[1])] == \
            np.asarray(jr.random.key_data(k)).tolist()
        for shape in ((3, 1000), (7,)):
            want = np.asarray(jr.random.bits(k, shape, jnp.uint32))
            got = ks.random_bits(pk, shape).numpy()
            np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_uniforms_bitwise(jr, seed):
    import jax.numpy as jnp
    k = _jkey(jr, seed, 3)
    pk = ks.fold_in(ks.key(seed), 3)
    want = np.asarray(jr.random.uniform(k, (3, 100), jnp.float32))
    got = ks.uniform(pk, (3, 100)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # the reference enables x64: a uniform with no dtype is f64
    want = np.asarray(jr.random.uniform(k, (9,)))
    assert want.dtype == np.float64
    got = ks.uniform(pk, (9,), torch.float64).numpy()
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))


def test_gumbel(jr):
    import jax.numpy as jnp
    for seed in SEEDS:
        k = _jkey(jr, seed, 1)
        want = np.asarray(jr.random.gumbel(k, (3, 1000), jnp.float32))
        got = ks.gumbel(ks.fold_in(ks.key(seed), 1), (3, 1000)).numpy()
        np.testing.assert_allclose(got, want, **GUMBEL_TOL)


def _row_draws(jax, logits, seed, counter, offset=None):
    """The reference's per-row draw: vmap of categorical over rows, each
    with fold_in(key(seed), counter) (and fold_in(., offset))."""
    import jax.numpy as jnp
    keys = jax.vmap(lambda s, c: jax.random.fold_in(jax.random.key(s), c))(
        jnp.asarray(seed, jnp.uint32), jnp.asarray(counter, jnp.uint32))
    if offset is not None:
        keys = jax.vmap(jax.random.fold_in)(keys,
                                            jnp.asarray(offset, jnp.uint32))
    return keys, np.asarray(jax.vmap(
        lambda k, lg: jax.random.categorical(k, lg))(keys,
                                                     jnp.asarray(logits)))


@pytest.mark.parametrize("with_offset", [False, True])
def test_categorical_rows_token_for_token(jr, with_offset):
    rng = np.random.RandomState(0)
    n, v = 12, 3000
    logits = rng.randn(n, v).astype(np.float32)
    logits[3] = 0.0                        # a row of ties: noise decides
    seed = rng.randint(-2 ** 31, 2 ** 31 - 1, n).astype(np.int32)
    ctr = rng.randint(0, 500, n).astype(np.int32)
    off = np.arange(n, dtype=np.int32) if with_offset else None
    keys, want = _row_draws(jr, logits, seed, ctr, off)
    t = torch.from_numpy
    got = ks.categorical_rows(t(logits), t(seed), t(ctr),
                              None if off is None else t(off))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the single-key plain functions agree with the row wrapper
    k = ks.row_keys(t(seed[:1]), t(ctr[:1]), None if off is None
                    else t(off[:1]))
    assert int(ks.categorical((k[0][0], k[1][0]), t(logits[0]))) == want[0]


def test_flat_index_is_the_column_within_the_row(jr):
    """Every draw in the reference is vmapped per row: element j of row n
    is keyed by column j alone. Drawing the same key over the flattened
    [N, V] shape gives other noise for every row but the first."""
    import jax.numpy as jnp
    n, v = 3, 500
    logits = np.zeros((n, v), np.float32)
    seed = np.full(n, 11, np.int32)
    ctr = np.zeros(n, np.int32)
    got = ks.categorical_rows(torch.from_numpy(logits), torch.from_numpy(seed),
                              torch.from_numpy(ctr)).numpy()
    # one key for every row: the per-row draws all equal row 0's
    assert (got == got[0]).all()
    g_flat = np.asarray(jr.random.gumbel(_jkey(jr, 11, 0), (n, v),
                                         jnp.float32))
    assert g_flat[0].argmax() == got[0]
    assert (g_flat[1:].argmax(-1) != got[0]).any()


def test_uniform64_rows_bitwise(jr):
    rng = np.random.RandomState(1)
    n = 40
    seed = rng.randint(-2 ** 31, 2 ** 31 - 1, n).astype(np.int32)
    ctr = rng.randint(0, 500, n).astype(np.int32)
    off = rng.randint(0, 15, n).astype(np.int32)
    keys, _ = _row_draws(jr, np.zeros((n, 2), np.float32), seed, ctr, off)
    want = np.asarray(jr.vmap(jr.random.uniform)(keys))
    t = torch.from_numpy
    got = ks.uniform64_rows(t(seed), t(ctr), t(off)).numpy()
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))


# ------------------------------------------------------------- filters --
def _logit_cases():
    rng = np.random.RandomState(3)
    lg = rng.randn(6, 64).astype(np.float32)
    tied = np.round(rng.randn(6, 64) * 2).astype(np.float32) / 2
    return [("random", lg), ("tied", tied)]


@pytest.mark.parametrize("name,lg", _logit_cases(), ids=["random", "tied"])
def test_filters_match_reference(name, lg):
    from paddle_tpu.generation import sampling as rs
    temp = np.asarray([1.0, 0.7, 1.3, 0.0, 0.5, 1.0], np.float32)
    topk = np.asarray([0, 5, 1, 64, 7, 0], np.int32)
    topp = np.asarray([1.0, 0.8, 0.5, 0.9, 1.0, 0.3], np.float32)
    t = torch.from_numpy
    np.testing.assert_allclose(ps.topk_mask(t(lg), t(topk)).numpy(),
                               np.asarray(rs.topk_mask(lg, topk)), **LOGIT_TOL)
    np.testing.assert_allclose(ps.topk_mask(t(lg), 5).numpy(),
                               np.asarray(rs.topk_mask(lg, 5)), **LOGIT_TOL)
    np.testing.assert_allclose(ps.topp_mask(t(lg), t(topp)).numpy(),
                               np.asarray(rs.topp_mask(lg, topp)), **LOGIT_TOL)
    np.testing.assert_allclose(
        ps.processed_logits(t(lg), t(temp), t(topk), t(topp)).numpy(),
        np.asarray(rs.processed_logits(lg, temp, topk, topp)), **LOGIT_TOL)
    # disabled knobs are the identity
    assert torch.equal(ps.topk_mask(t(lg), 0), t(lg))
    assert torch.equal(ps.topp_mask(t(lg), 1.0), t(lg))
    if name == "random":
        # the one-sort pipeline equals the sequential filters (no ties)
        scaled = t(lg) / torch.where(t(temp) <= 0, 1.0, t(temp))[:, None]
        assert torch.equal(
            ps.processed_logits(t(lg), t(temp), t(topk), t(topp)),
            ps.topp_mask(ps.topk_mask(scaled, t(topk)), t(topp)))


def test_sampling_operands_match_reference():
    from paddle_tpu.generation import sampling as rs
    mix = [None, (0.8, 50, 0.95, 11), (1.0, 0, 1.0, -5), (0.0, 3, 0.5, 7)]
    want = rs.sampling_operands([None if m is None else rs.SamplingParams(*m)
                                 for m in mix])
    got = ps.sampling_operands([None if m is None else ps.SamplingParams(*m)
                                for m in mix])
    assert want.keys() == got.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_logits_processors_match_reference():
    import jax.numpy as jnp
    from paddle_tpu.generation import logits_process as rlp
    from paddle_tpu_torch.generation import logits_process as plp
    rng = np.random.RandomState(4)
    lg = rng.randn(3, 32).astype(np.float32)
    jlg = jnp.asarray(lg)
    counts = rng.randint(0, 3, (3, 32)).astype(np.int32)
    t = torch.from_numpy
    pairs = [
        (plp.top_k_filter(t(lg), 5), rlp.top_k_filter(lg, 5)),
        (plp.top_p_filter(t(lg), 0.7), rlp.top_p_filter(lg, 0.7)),
        (plp.repetition_penalty(t(lg), t(counts), 1.3),
         rlp.repetition_penalty(lg, counts, 1.3)),
        (plp.min_length_mask(t(lg), 1, 3, 4),
         rlp.min_length_mask(jlg, 1, 3, 4)),
        (plp.min_length_mask(t(lg), 3, 3, 4),
         rlp.min_length_mask(jlg, 3, 3, 4)),
        (plp.apply_temperature(t(lg), 0.7), rlp.apply_temperature(lg, 0.7)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    assert torch.equal(plp.top_k_filter(t(lg), 0), t(lg))


# ---------------------------------------------------- sample and verify --
def _operands(b, rng):
    temp = np.where(np.arange(b) % 3 == 0, 0.0,
                    rng.uniform(0.5, 1.5, b)).astype(np.float32)
    topk = rng.choice([0, 5, 20], b).astype(np.int32)
    topp = rng.choice([1.0, 0.9, 0.6], b).astype(np.float32)
    seed = rng.randint(-2 ** 31, 2 ** 31 - 1, b).astype(np.int32)
    ctr = rng.randint(0, 50, b).astype(np.int32)
    return temp, topk, topp, seed, ctr


def test_sample_tokens_matches_reference():
    from paddle_tpu.generation import sampling as rs
    rng = np.random.RandomState(5)
    b, v = 9, 256
    lg = (rng.randn(b, v) * 3).astype(np.float32)
    ops = _operands(b, rng)
    want_tok, want_lp = rs.sample_tokens(lg, *ops)
    tok, lp = ps.sample_tokens(torch.from_numpy(lg), *ops)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(want_tok))
    np.testing.assert_allclose(lp.numpy(), np.asarray(want_lp), rtol=1e-5,
                               atol=1e-5)
    # greedy rows are bitwise the raw argmax
    g = ops[0] <= 0
    np.testing.assert_array_equal(tok.numpy()[g], lg.argmax(-1)[g])


@pytest.mark.parametrize("sampled_mode", [False, True])
def test_verify_spans_matches_reference(sampled_mode):
    from paddle_tpu.generation import sampling as rs
    rng = np.random.RandomState(6)
    b, qb, v = 10, 5, 64
    lg = (rng.randn(b, qb, v) * 2).astype(np.float32)
    g = lg.argmax(-1)
    span = rng.randint(0, v, (b, qb)).astype(np.int32)
    # drafts the model accepts at several depths, for greedy and sampled
    for i in range(b):
        depth = i % qb
        span[i, 1:1 + depth] = g[i, :depth]
    q_lens = (np.arange(b) % qb + 1).astype(np.int32)
    ops = _operands(b, rng)
    want = rs.verify_spans(lg, span, q_lens, *ops, sampled_mode=sampled_mode)
    got = ps.verify_spans(torch.from_numpy(lg), torch.from_numpy(span),
                          torch.from_numpy(q_lens), *ops,
                          sampled_mode=sampled_mode)
    for w, t in zip(want, got):
        np.testing.assert_array_equal(t.numpy(), np.asarray(w))
    if not sampled_mode:
        for w, t in zip(want, ps.verify_spans_greedy(
                *(torch.from_numpy(a) for a in (lg, span, q_lens)))):
            np.testing.assert_array_equal(t.numpy(), np.asarray(w))


def test_rejection_sampling_preserves_target_distribution():
    """With a deterministic drafter the first emitted token is
    distributed as p: P(tok) = p(d) 1[tok = d] + (1 - p(d)) residual."""
    n, v = 8000, 4
    row = np.array([2.0, 1.0, 0.5, -1.0], np.float32)
    lgs = torch.from_numpy(np.tile(row, (n, 2, 1)))           # Qb = 2
    p = torch.softmax(torch.from_numpy(row), -1).numpy()
    acc, bon = ps.verify_spans(
        lgs, torch.zeros(n, 2, dtype=torch.int64),
        torch.full((n,), 2), np.ones(n, np.float32), np.zeros(n, np.int32),
        np.ones(n, np.float32), np.arange(n, dtype=np.int32),
        np.zeros(n, np.int32))
    first = np.where(acc.numpy() >= 1, 0, bon.numpy())
    emp = np.bincount(first, minlength=v) / n
    assert np.abs(emp - p).max() < 0.03, (emp.tolist(), p.tolist())


def test_temp0_is_bitwise_argmax_and_keys_drive_the_stream():
    rng = np.random.RandomState(0)
    lg = torch.from_numpy(rng.randn(5, 64).astype(np.float32))
    z, o = np.zeros(5, np.int32), np.ones(5, np.float32)
    tok, _ = ps.sample_tokens(lg, np.zeros(5, np.float32), z, o,
                              np.arange(5, dtype=np.int32), z)
    assert torch.equal(tok, lg.argmax(-1).to(torch.int32))
    b, v = 64, 500
    flat = torch.zeros(b, v)
    ones, zk = np.ones(b, np.float32), np.zeros(b, np.int32)

    def draw(seed, ctr):
        return ps.sample_tokens(flat, ones, zk, ones, seed, ctr)[0]
    a = draw(zk, zk)
    assert torch.equal(a, draw(zk, zk))                      # same key
    assert not torch.equal(a, draw(zk, np.ones(b, np.int32)))   # counter
    assert len(set(draw(np.arange(b, dtype=np.int32), zk).tolist())) > b // 2


# ----------------------------------------------------------- serve loop --
GEOM = dict(max_batch_size=2, page_size=8, max_seq_len=256,
            sampling_enabled=True)


@pytest.fixture(scope="module")
def models():
    import paddle_tpu as paddle
    from paddle_tpu.models import LlamaConfig as RefConfig
    from paddle_tpu.models import LlamaForCausalLM as RefLlama
    from paddle_tpu_torch.convert import load_reference_state_dict
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    paddle.seed(0)
    ref = RefLlama(RefConfig.tiny(tensor_parallel=False))
    port = LlamaForCausalLM(LlamaConfig.tiny(tensor_parallel=False),
                            device="cpu")
    load_reference_state_dict(port, {k: np.asarray(v.numpy())
                                     for k, v in ref.state_dict().items()})
    return ref, port


def _cb(model, **kw):
    from paddle_tpu_torch.inference import ContinuousBatchingPredictor
    g = dict(GEOM, **kw)
    if isinstance(model, torch.nn.Module):
        return ContinuousBatchingPredictor(model, device="cpu", **g)
    from paddle_tpu.inference import ContinuousBatchingPredictor as Ref
    g.pop("use_ragged", None)
    return Ref(model, **g)


def _prompts():
    """A 70-token prompt (chunked at 16), two tiled-motif prompts (the
    drafter finds matches) and a random one."""
    rng = np.random.RandomState(0)
    motifs = [rng.randint(2, 256, (3 + s % 4,)).tolist() for s in range(24)]
    return [(motifs[2] * 30)[:70], (motifs[9] * 8)[:20],
            (motifs[16] * 8)[:20], rng.randint(2, 256, (11,)).tolist()]


def _mix(ref):
    from paddle_tpu.generation.sampling import SamplingParams as RSP
    cls = RSP if ref else ps.SamplingParams
    return [None, cls(temperature=0.8, top_k=20, seed=3),
            cls(temperature=1.0, seed=-5),
            cls(temperature=0.6, top_p=0.9, seed=7)]


def _pool_baseline(cb):
    if cb.prefix_cache is not None:
        cb.prefix_cache.clear(cb.pool)
    return len(cb.pool._free) == cb.pool.num_pages - 1


SHARED_STATS = ("prefills", "prefill_batches", "decode_steps", "evictions",
                "prefix_hits", "prefix_misses", "spec_ticks", "spec_proposed",
                "spec_accepted", "prefill_chunks", "chunked_requests",
                "mixed_steps")


SERVE_CFGS = {"plain": {}, "chunked": dict(prefill_chunk_tokens=16),
              "chunk_spec": dict(prefill_chunk_tokens=16, spec_draft_tokens=3)}


@pytest.mark.parametrize("ragged", [False, True], ids=["table", "ragged"])
@pytest.mark.parametrize("cfg", list(SERVE_CFGS))
def test_serve_loop_matches_reference(models, ragged, cfg):
    """Greedy and sampled requests in one batch (B = 2 < 4 requests, so
    slots recycle), prefix cache on: tokens and stats equal the
    reference's; the greedy row equals a greedy-only run. Without
    speculation a sampled request's stream does not depend on its
    batch (paused slots consume no counter); with it, whether a tick
    verifies (other keys) depends on the other slots' drafts."""
    ref_m, port_m = models
    kw = dict(enable_prefix_cache=True, **SERVE_CFGS[cfg])
    prompts = _prompts()
    ref = _cb(ref_m, **kw)
    port = _cb(port_m, use_ragged=ragged, **kw)
    want = ref.generate(prompts, max_new_tokens=12, sampling=_mix(True))
    got = port.generate(prompts, max_new_tokens=12, sampling=_mix(False))
    assert got == want
    assert port.last_status == ["ok"] * 4
    assert {k: port.stats[k] for k in SHARED_STATS} == \
        {k: ref.stats[k] for k in SHARED_STATS}
    assert port.sampling_stats["sampled_requests"] == 3
    if cfg != "plain":
        assert port.stats["chunked_requests"] == 3
        assert port.sampling_stats["paused_slots"] > 0
    if cfg == "chunk_spec":
        assert port.sampling_stats["sampled_spec_proposed"] > 0
    greedy = _cb(port_m, use_ragged=ragged, **kw).generate(
        prompts[:1], max_new_tokens=12)
    assert got[0] == greedy[0]
    if cfg != "chunk_spec":
        # a sampled request served alone emits the same stream
        alone = _cb(port_m, use_ragged=ragged, **kw).generate(
            prompts[1:2], max_new_tokens=12, sampling=_mix(False)[1])
        assert alone[0] == got[1]
    assert _pool_baseline(port)


def test_temp0_greedy_bitwise_and_seed_sensitivity(models):
    _, port_m = models
    prompts = _prompts()[1:]
    want = _cb(port_m, sampling_enabled=False).generate(prompts,
                                                        max_new_tokens=10)
    cb = _cb(port_m)
    assert cb.generate(prompts, max_new_tokens=10,
                       sampling=ps.SamplingParams(temperature=0.0)) == want
    sp = ps.SamplingParams(temperature=0.9, top_k=20, seed=11)
    a = cb.generate(prompts, max_new_tokens=10, sampling=sp)
    assert a == cb.generate(prompts, max_new_tokens=10, sampling=sp)
    assert a != cb.generate(prompts, max_new_tokens=10,
                            sampling=sp._replace(seed=12))
    assert _pool_baseline(cb)


def test_sampled_stream_survives_slot_recycling(models):
    """A sampled request admitted into a slot whose previous request's
    last step is still in flight starts its key counter at 0: staggered
    budgets, B = 2 < 3 requests; the third equals its solo run and the
    reference's."""
    ref_m, port_m = models
    prompts = _prompts()[1:]
    budgets = [4, 24, 12]
    want = _cb(ref_m).generate(
        prompts, max_new_tokens=12,
        sampling=_mix(True)[1])                  # reference: one budget
    cb = _cb(port_m)
    sp = _mix(False)[1]
    out = cb.generate(prompts, max_new_tokens=budgets, sampling=sp)
    solo = cb.generate(prompts[2:], max_new_tokens=12, sampling=sp)[0]
    assert out[2] == solo == want[2]
    assert [len(o) for o in out] == budgets
    assert _pool_baseline(cb)


def test_sampling_disabled_predictor_rejects(models):
    _, port_m = models
    cb = _cb(port_m, sampling_enabled=False)
    sp = ps.SamplingParams(temperature=0.8)
    with pytest.raises(ValueError, match="sampling_enabled"):
        cb.generate(_prompts()[1:2], max_new_tokens=4, sampling=sp)
    with pytest.raises(ValueError, match="entries"):
        cb.generate(_prompts()[1:3], max_new_tokens=4, sampling=[sp])
    out = cb.generate(_prompts()[1:3], max_new_tokens=4, strict=False,
                      sampling=[sp, None])
    assert out[0] == [] and len(out[1]) == 4
    assert cb.last_status == ["rejected_sampling_disabled", "ok"]
    # temperature 0 is greedy: served without sampling
    assert cb.generate(_prompts()[2:3], max_new_tokens=4,
                       sampling=ps.SamplingParams(temperature=0.0)) \
        == [out[1]]


# ------------------------------------------------------------ generate --
GEN_KW = dict(max_new_tokens=4, decode_strategy="sampling", temperature=0.8,
              top_k=12, top_p=0.9, seed=7)


def test_generate_matches_reference_and_serve_loop(models):
    """The eager generate() against the reference's generate() (ragged
    rows; sampling, greedy, and sampling with a repetition penalty, min
    length and eos), and the cross-path promise: a seed gives the serve
    loop's tokens. The reference runs its jitted static-cache route,
    which its own tests pin to its eager route token for token (its
    eager route compiles op by op here, ~18 s)."""
    ref_m, port_m = models
    rng = np.random.RandomState(0)
    ids = rng.randint(2, 256, (2, 7))
    ragged = np.ones((2, 7), np.int32)
    ragged[1, :3] = 0
    for kw, mask in ((GEN_KW, ragged),
                     (dict(decode_strategy="greedy_search",
                           max_new_tokens=4), ragged),
                     (dict(GEN_KW, temperature=1.0, seed=-4,
                           repetition_penalty=1.3, min_new_tokens=2,
                           eos_token_id=5), None)):
        want, want_s = ref_m.generate(ids, attention_mask=mask, **kw)
        got, got_s = port_m.generate(torch.from_numpy(ids),
                                     attention_mask=mask, use_cache=False,
                                     **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want.numpy()))
        np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s.numpy()),
                                   rtol=1e-5, atol=1e-5)
    prompt = ids[0].tolist()
    serve = _cb(port_m).generate(
        [prompt], max_new_tokens=4,
        sampling=ps.SamplingParams(temperature=0.8, top_k=12, top_p=0.9,
                                   seed=7))[0]
    eager = port_m.generate(np.asarray([prompt]), **GEN_KW)[0][0].tolist()
    assert serve == eager
    # beam search no longer raises: it gives the reference's beams
    beam = dict(decode_strategy="beam_search", num_beams=2, max_new_tokens=4)
    want, want_s = ref_m.generate(ids, attention_mask=ragged, **beam)
    got, got_s = port_m.generate(ids, attention_mask=ragged, **beam)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.numpy()))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s.numpy()),
                               rtol=1e-4, atol=1e-4)


def test_generate_without_seed_draws_from_the_generation_stream(models):
    from paddle_tpu_torch.framework import random as prandom
    _, port_m = models
    ids = np.random.RandomState(1).randint(2, 256, (2, 5))
    kw = dict(GEN_KW, seed=None)
    prandom.seed(3)
    a = port_m.generate(ids, **kw)[0]
    prandom.seed(3)
    assert torch.equal(a, port_m.generate(ids, **kw)[0])


# ----------------------------------------------------------------- card --
@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,v,with_offset", [(4, 32000, False),
                                             (20, 32000, True),
                                             (3, 7, True), (5, 1000, False)])
def test_categorical_rows_kernel_matches_plain(cuda, n, v, with_offset):
    """Kernel vs plain version on the card: tokens equal on every row
    (the noise is the same f32 ops: logf, no fast math), ties included."""
    g = torch.Generator(device=cuda).manual_seed(n * v)
    logits = torch.randn(n, v, device=cuda, generator=g) * 3
    logits[0] = 0.0                         # ties: the noise decides
    seed = torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), device=cuda,
                         generator=g, dtype=torch.int64).to(torch.int32)
    ctr = torch.randint(0, 10000, (n,), device=cuda, generator=g,
                        dtype=torch.int64).to(torch.int32)
    off = torch.arange(n, device=cuda, dtype=torch.int32) + 5 \
        if with_offset else None
    reset_launch_counts()
    got = ks.categorical_rows(logits, seed, ctr, off)
    assert launch_counts["categorical_rows"] == 1
    want = ks.categorical_rows_plain(logits, seed, ctr, off)
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.device == logits.device
    assert torch.equal(got, want)
    assert torch.equal(ks.categorical_rows(logits, seed, ctr, off), got)


@pytest.mark.cuda
def test_uniform64_rows_kernel_bitwise(cuda):
    n = 300
    seed = torch.arange(-150, 150, device=cuda, dtype=torch.int32) * 7919
    ctr = torch.arange(n, device=cuda, dtype=torch.int32)
    off = torch.arange(n, device=cuda, dtype=torch.int32) % 15
    for o in (off, None):
        reset_launch_counts()
        got = ks.uniform64_rows(seed, ctr, o)
        assert launch_counts["uniform64_rows"] == 1
        want = ks.uniform64_rows_plain(seed, ctr, o)
        torch.cuda.synchronize()
        assert got.dtype == torch.float64
        assert torch.equal(got.view(torch.int64), want.view(torch.int64))


@pytest.mark.cuda
def test_sampled_decode_step_launches_one_draw(cuda):
    """The sampling decode tick draws in one kernel launch; verify takes
    one per family (normal, residual) and one uniform launch."""
    from paddle_tpu_torch.generation.sampling import sample_tokens
    b, v = 4, 32000
    lg = torch.randn(b, v, device=cuda)
    ops = [torch.as_tensor(a, device=cuda) for a in (
        np.asarray([0.0, 0.8, 1.0, 0.6], np.float32),
        np.asarray([0, 50, 0, 0], np.int32),
        np.asarray([1.0, 0.95, 1.0, 0.9], np.float32),
        np.arange(4, dtype=np.int32), np.zeros(4, np.int32))]
    reset_launch_counts()
    tok, _ = sample_tokens(lg, *ops, with_logp=False)
    assert launch_counts["categorical_rows"] == 1
    assert int(tok[0]) == int(lg[0].argmax())
    span = torch.randint(0, v, (b, 5), device=cuda)
    reset_launch_counts()
    ps.verify_spans(torch.randn(b, 5, v, device=cuda), span,
                    torch.full((b,), 5, device=cuda), *ops)
    assert (launch_counts["categorical_rows"],
            launch_counts["uniform64_rows"]) == (2, 1)
