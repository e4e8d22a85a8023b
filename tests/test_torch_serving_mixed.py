"""The port's chunked prefill and greedy speculative decoding against the
JAX reference predictor.

Both predictors serve the same tiny Llama (weights moved with
``convert.load_reference_state_dict``); greedy tokens must be equal
token for token and the stats both keep must agree. The port runs with
``use_ragged`` off and on (on the CPU the ragged entries take their
plain versions); one case drives the reference through its ragged
Pallas kernels in interpret mode.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import ContinuousBatchingPredictor as RefPredictor
from paddle_tpu.models import LlamaConfig as RefConfig
from paddle_tpu.models import LlamaForCausalLM as RefLlama

from paddle_tpu_torch.convert import load_reference_state_dict
from paddle_tpu_torch.generation import sampling as port_sampling
from paddle_tpu_torch.inference import ContinuousBatchingPredictor
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

GEOM = dict(max_batch_size=2, page_size=8, max_seq_len=128,
            enable_prefix_cache=False)


def _pair(**kw):
    paddle.seed(0)
    ref = RefLlama(RefConfig.tiny(**kw))
    port = LlamaForCausalLM(LlamaConfig.tiny(**kw), device="cpu")
    load_reference_state_dict(
        port, {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()})
    return ref, port


@pytest.fixture(scope="module")
def models():
    return _pair(tensor_parallel=False)


def _cb(model, **kw):
    g = dict(GEOM, **kw)
    if isinstance(model, LlamaForCausalLM):
        return ContinuousBatchingPredictor(model, device="cpu", **g)
    return RefPredictor(model, **g)


def _cyclic_prompts(vocab, n=3, length=20):
    """Tiled-motif prompts (tests/test_spec_decode.py's): the workload
    where prompt lookup finds drafts."""
    rng = np.random.RandomState(0)
    motifs = [rng.randint(2, vocab, (3 + s % 4,)).tolist()
              for s in range(24)]
    return [(motifs[s] * (length // 3 + 1))[:length]
            for s in (2, 9, 16)][:n]


def _pool_baseline(cb):
    """Free pages with nothing admitted: everything but the trash page."""
    if cb.prefix_cache is not None:
        cb.prefix_cache.clear(cb.pool)
    return len(cb.pool._free) == cb.pool.num_pages - 1


def _shared(ref, port, keys):
    return ({k: ref.stats[k] for k in keys}, {k: port.stats[k] for k in keys})


CHUNK_STATS = ("chunked_requests", "prefill_chunks", "mixed_steps",
               "decode_steps", "prefix_misses")
SPEC_STATS = ("spec_ticks", "spec_proposed", "spec_accepted", "decode_steps")


@pytest.mark.parametrize("ragged", [False, True], ids=["table", "ragged"])
def test_chunked_prefill_matches_reference_and_unchunked(models, ragged):
    ref_m, port_m = models
    rng = np.random.RandomState(3)
    prompts = [rng.randint(2, 256, (n,)).tolist() for n in (40, 5, 23, 9)]
    plain = _cb(port_m, use_ragged=ragged).generate(prompts,
                                                    max_new_tokens=8)
    ref = _cb(ref_m, prefill_chunk_tokens=16, max_batch_size=3)
    port = _cb(port_m, prefill_chunk_tokens=16, max_batch_size=3,
               use_ragged=ragged)
    want = ref.generate(prompts, max_new_tokens=8)
    assert port.generate(prompts, max_new_tokens=8) == want == plain
    assert port.last_status == ["ok"] * 4
    want_s, got_s = _shared(ref, port, CHUNK_STATS)
    assert got_s == want_s
    assert got_s["chunked_requests"] == 2 and got_s["mixed_steps"] >= 2
    # TTFT of a chunked request lands when its final chunk resolves
    assert all(t is not None and t > 0 for t in port.last_ttft_s)
    assert _pool_baseline(port)


def test_chunked_prefill_bypasses_the_prefix_cache(models):
    """Chunked prompts skip the prefix cache; short ones still use it.
    Same tokens and shared stats as the reference, prefix cache on."""
    ref_m, port_m = models
    rng = np.random.RandomState(4)
    long_p = rng.randint(2, 256, (37,)).tolist()
    short = long_p[:11]
    g = dict(prefill_chunk_tokens=16, enable_prefix_cache=True)
    ref, port = _cb(ref_m, **g), _cb(port_m, **g)
    for batch in ([short], [long_p, short], [short]):
        assert port.generate(batch, max_new_tokens=6) == ref.generate(
            batch, max_new_tokens=6)
    want_s, got_s = _shared(ref, port, CHUNK_STATS + ("prefix_hits",))
    assert got_s == want_s and got_s["prefix_hits"] >= 1
    assert port._chunk_max == 16
    assert _cb(port_m, prefill_chunk_tokens=40)._chunk_max == 32


@pytest.mark.parametrize("ragged", [False, True], ids=["table", "ragged"])
def test_greedy_spec_matches_reference(models, ragged):
    ref_m, port_m = models
    prompts = _cyclic_prompts(256)
    plain = _cb(port_m)
    base = plain.generate(prompts, max_new_tokens=24)
    ref = _cb(ref_m, spec_draft_tokens=4)
    port = _cb(port_m, spec_draft_tokens=4, use_ragged=ragged)
    want = ref.generate(prompts, max_new_tokens=24)
    assert port.generate(prompts, max_new_tokens=24) == want == base
    want_s, got_s = _shared(ref, port, SPEC_STATS)
    assert got_s == want_s
    assert got_s["spec_accepted"] > 0
    assert got_s["decode_steps"] < plain.stats["decode_steps"]
    assert _pool_baseline(port)


def _garbage(h, k, ngram_max=3, window=4096):
    return [1] * k if k > 0 else []


def test_forced_garbage_drafts_stay_greedy(models, monkeypatch):
    """All-rejected drafts: the output still equals plain greedy and the
    pool returns to baseline."""
    _, port_m = models
    prompts = _cyclic_prompts(256)
    want = _cb(port_m).generate(prompts, max_new_tokens=12)
    monkeypatch.setattr(port_sampling, "propose_ngram_drafts", _garbage)
    for ragged in (False, True):
        cb = _cb(port_m, spec_draft_tokens=3, use_ragged=ragged)
        assert cb.generate(prompts, max_new_tokens=12) == want
        assert cb.stats["spec_proposed"] > 0
        assert cb.stats["spec_accepted"] <= cb.stats["spec_proposed"] / 4
        assert _pool_baseline(cb)


def test_rollback_restores_page_contents(models, monkeypatch):
    """Rejected span positions' K/V is restored: after a run with forced
    garbage drafts (every draft is written, then rejected), the pages
    past the committed tokens hold exactly what a plain greedy run left
    there, bit for bit, and the committed positions hold the same K/V
    (same allocator order, so the same page ids). Committed K/V written
    by a span forward may differ from the decode forward's in the last
    f32 bit (CPU GEMM blocking depends on the row count): atol 1e-6."""
    _, port_m = models
    prompts = _cyclic_prompts(256, n=1)
    cb_a = _cb(port_m, max_batch_size=1)
    out_a = cb_a.generate(prompts, max_new_tokens=8)
    monkeypatch.setattr(port_sampling, "propose_ngram_drafts", _garbage)
    cb_b = _cb(port_m, max_batch_size=1, spec_draft_tokens=3)
    assert cb_b.generate(prompts, max_new_tokens=8) == out_a
    assert cb_b.stats["spec_proposed"] > cb_b.stats["spec_accepted"]
    # committed region: prompt + generated tokens but the last (the
    # final bonus token's K/V is never written)
    n = len(prompts[0]) + len(out_a[0]) - 1
    for pa, pb in zip(cb_a.pool.k + cb_a.pool.v, cb_b.pool.k + cb_b.pool.v):
        fa = pa[1:].reshape(-1, *pa.shape[2:])   # pages 1.. in order
        fb = pb[1:].reshape(-1, *pb.shape[2:])
        torch.testing.assert_close(fb[:n], fa[:n], atol=1e-6, rtol=0)
        assert torch.equal(fa[n:], fb[n:])


@pytest.mark.parametrize("ragged", [False, True], ids=["table", "ragged"])
def test_spec_step_rolls_back_rejected_positions(models, ragged):
    """One verify step on a pool of random K/V: the positions of the
    rejected drafts (accepted < i < q_lens) hold their pre-step contents
    bit for bit in every layer, the kept positions were written, and
    nothing else changed."""
    from paddle_tpu_torch.kernels.paged_attention import RaggedMetaBuilder
    _, port_m = models
    cb = _cb(port_m, spec_draft_tokens=3)
    g = torch.Generator().manual_seed(0)
    for t in cb.pool.k + cb.pool.v:
        t.copy_(torch.randn(t.shape, generator=g))
    before = [t.clone() for t in cb.pool.k + cb.pool.v]
    tables = np.full((2, cb.pages_per_seq), cb._trash, np.int32)
    tables[0, :2], tables[1, :2] = [1, 2], [3, 4]
    ctx = np.asarray([5, 9], np.int32)
    q_lens = np.asarray([4, 1], np.int32)
    span_ids = np.asarray([[7, 1, 1, 1], [9, 0, 0, 0]], np.int64)
    meta = None
    if ragged:
        builder = RaggedMetaBuilder(2, cb.pages_per_seq, cb.page, cb._trash)
        for b in range(2):
            builder.set_slot(b, tables[b], int(ctx[b] + q_lens[b]))
        meta = torch.from_numpy(builder.stacked())
    bonus, acc = cb._raw_spec_step(
        *(torch.from_numpy(a) for a in (tables, ctx, span_ids, q_lens)),
        torch.tensor([7, 9], dtype=torch.int32),
        cb._span(tables, ctx, q_lens), meta)
    a = int(acc[0])
    assert int(acc[1]) == 0 and a < 3       # token 1 is not the argmax
    written = {(int(tables[b, p // 8]), p % 8)
               for b, p in [(0, 5 + i) for i in range(a + 1)] + [(1, 9)]}
    for old, new in zip(before, cb.pool.k + cb.pool.v):
        for pid in range(old.shape[0]):
            for off in range(old.shape[1]):
                same = torch.equal(old[pid, off], new[pid, off])
                assert same != ((pid, off) in written), (pid, off)


def test_eos_inside_span_strips_and_evicts(models):
    ref_m, port_m = models
    prompts = _cyclic_prompts(256, n=2)
    base = _cb(port_m).generate(prompts, max_new_tokens=24)
    eos = base[0][5]
    ref = _cb(ref_m, eos_token_id=eos, spec_draft_tokens=4)
    port = _cb(port_m, eos_token_id=eos, spec_draft_tokens=4)
    want = ref.generate(prompts, max_new_tokens=24)
    assert port.generate(prompts, max_new_tokens=24) == want
    assert want == _cb(port_m, eos_token_id=eos).generate(prompts,
                                                          max_new_tokens=24)
    assert eos not in want[0] and len(want[0]) < 24
    assert _pool_baseline(port)


def test_chunked_spec_against_reference_interpret_ragged_route():
    """The reference through its ragged Pallas kernels in interpret mode
    (use_ragged on, the 2-layer hidden-1024 model of
    tests/test_mixed_step.py), chunked prefill plus speculation, against
    the port's ragged route (plain versions on the CPU)."""
    from paddle_tpu.framework.flags import get_flags, set_flags
    ref_m, port_m = _pair(hidden_size=1024, num_attention_heads=8,
                          num_key_value_heads=8, intermediate_size=256,
                          num_hidden_layers=2)
    rng = np.random.RandomState(4)
    prompts = [rng.randint(2, 256, (n,)).tolist() for n in (20, 4)]
    prompts[1] = (prompts[1] * 4)[:14]
    kw = dict(max_seq_len=64, prefill_chunk_tokens=8, spec_draft_tokens=2)
    old = get_flags(["use_pallas_kernels", "pallas_interpret"])
    set_flags({"use_pallas_kernels": True, "pallas_interpret": True})
    try:
        ref = _cb(ref_m, **kw)
        assert ref.use_ragged
        want = ref.generate(prompts, max_new_tokens=6)
    finally:
        set_flags({k.removeprefix("FLAGS_"): v for k, v in old.items()})
    port = _cb(port_m, use_ragged=True, **kw)
    assert port.generate(prompts, max_new_tokens=6) == want
    want_s, got_s = _shared(ref, port, CHUNK_STATS + SPEC_STATS)
    assert got_s == want_s and got_s["chunked_requests"] == 2
    assert got_s["spec_proposed"] > 0


def test_runtime_config_fields_and_validation():
    from paddle_tpu.framework.runtime_config import RuntimeConfig as RefRC
    from paddle_tpu_torch.framework.runtime_config import RuntimeConfig
    rc, ref = RuntimeConfig(), RefRC()
    for k in ("prefill_chunk_tokens", "spec_draft_tokens", "spec_ngram_max"):
        assert getattr(rc, k) == getattr(ref, k)
    with pytest.raises(ValueError):
        RuntimeConfig(spec_draft_tokens=-1)
    with pytest.raises(ValueError):
        RuntimeConfig(spec_ngram_max=0)
    _, port_m = _pair()
    cb = ContinuousBatchingPredictor(
        port_m, device="cpu", runtime_config=RuntimeConfig(
            prefill_chunk_tokens=24, spec_draft_tokens=2, page_size=8))
    assert (cb._chunk_max, cb._spec_k, cb.use_ragged) == (16, 2, False)


def test_verify_and_drafter_match_reference():
    from paddle_tpu.generation.sampling import (propose_ngram_drafts,
                                                verify_spans)
    rng = np.random.RandomState(0)
    lg = rng.randn(4, 5, 64).astype(np.float32)
    span = rng.randint(0, 64, (4, 5)).astype(np.int32)
    g = lg.argmax(-1)
    span[0, 1:] = g[0, :-1]                  # all accepted
    span[1, 1:3] = g[1, :2]                  # two accepted
    ql = np.asarray([5, 5, 1, 3], np.int32)
    z = np.zeros(4, np.int32)
    want = verify_spans(lg, span, ql, z.astype(np.float32), z,
                        np.ones(4, np.float32), z, z, sampled_mode=False)
    got = port_sampling.verify_spans_greedy(*(torch.from_numpy(a) for a in
                                              (lg, span, ql)))
    for w, t in zip(want, got):
        np.testing.assert_array_equal(t.numpy(), np.asarray(w))
    for h, k in (([1, 2, 3, 4, 5, 1, 2, 3], 3), ([1, 2, 9, 1, 2, 7, 1, 2], 2),
                 ([7, 8, 9], 3), ([1, 2, 1], 0)):
        assert port_sampling.propose_ngram_drafts(h, k) == \
            propose_ngram_drafts(h, k)
