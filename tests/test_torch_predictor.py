"""The port's ContinuousBatchingPredictor against the JAX reference's.

Both predictors serve the same tiny Llama (weights moved with
``convert.load_reference_state_dict``) on the same prompts; the greedy
tokens must be equal token for token, and the stats the two share must
agree (same batches, same prefix-cache decisions). Also: the page pool
and prefix cache units, strict rejection, and that the port stays free
of JAX and refuses to fall back to the CPU unasked.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import ContinuousBatchingPredictor as RefPredictor
from paddle_tpu.models import LlamaConfig as RefConfig
from paddle_tpu.models import LlamaForCausalLM as RefLlama

from paddle_tpu_torch.convert import load_reference_state_dict
from paddle_tpu_torch.generation.kv_cache import (PagedKVPool, PrefixCache,
                                                  prefix_page_keys)
from paddle_tpu_torch.inference import ContinuousBatchingPredictor
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

REPO = Path(__file__).resolve().parent.parent
GEOM = dict(max_batch_size=2, page_size=8, max_seq_len=64)


def _pair(**kw):
    paddle.seed(0)
    ref = RefLlama(RefConfig.tiny(**kw))
    port = LlamaForCausalLM(LlamaConfig.tiny(**kw), device="cpu")
    load_reference_state_dict(
        port, {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()})
    return ref, port


def _predictors(model_kw=None, **geom):
    ref, port = _pair(**(model_kw or {}))
    g = dict(GEOM, **geom)
    return RefPredictor(ref, **g), ContinuousBatchingPredictor(
        port, device="cpu", **g)


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(2, 256, (n,)).tolist() for n in lens]


def _shared_stats(ref, port):
    return {k: ref.stats[k] for k in port.stats}, dict(port.stats)


@pytest.mark.parametrize("prefix_cache", [True, False])
def test_greedy_parity(prefix_cache):
    ref, port = _predictors(enable_prefix_cache=prefix_cache)
    prompts = _prompts(2, (9, 4, 13))
    want = ref.generate(prompts, max_new_tokens=10)
    assert port.generate(prompts, max_new_tokens=10) == want
    assert port.last_status == ["ok"] * 3
    want_s, got_s = _shared_stats(ref, port)
    assert got_s == want_s


def test_partial_hit_suffix_prefill_and_copy_on_write():
    """A cached 11-token prompt (one full page + a 3-token partial page)
    extended by 6 tokens: the second request reuses the full page, copies
    the partial page before appending (copy-on-write) and prefills only
    its suffix; then the first prompt again is a full hit."""
    ref, port = _predictors()
    base = _prompts(5, (11,))[0]
    ext = base + _prompts(6, (6,))[0]
    for batch in ([base], [ext], [base, ext]):
        assert port.generate(batch, max_new_tokens=7) == ref.generate(
            batch, max_new_tokens=7)
        want_s, got_s = _shared_stats(ref, port)
        assert got_s == want_s
    assert port.stats["prefix_partial_hits"] >= 1
    assert port.stats["prefix_hits"] >= 1


def test_full_hit_runs_no_forward():
    ref, port = _predictors()
    prompts = _prompts(7, (16,))             # page-aligned: two full pages
    first = port.generate(prompts, max_new_tokens=5)
    assert first == ref.generate(prompts, max_new_tokens=5)
    prefills = port.stats["prefills"]
    again = port.generate(prompts, max_new_tokens=5)
    assert again == first == ref.generate(prompts, max_new_tokens=5)
    assert port.stats["prefills"] == prefills
    assert port.stats["prefix_hits"] == ref.stats["prefix_hits"] == 1


def test_batched_same_bucket_prefill_equal_stats():
    ref, port = _predictors(max_batch_size=4, enable_prefix_cache=False)
    prompts = _prompts(1, (5, 7, 6, 8))
    assert port.generate(prompts, max_new_tokens=6) == ref.generate(
        prompts, max_new_tokens=6)
    want_s, got_s = _shared_stats(ref, port)
    assert got_s == want_s
    assert got_s["prefill_batches"] == 1 and got_s["prefills"] == 4


def test_tuned_prompt_buckets_parity():
    """A tuned bucket table (RuntimeConfig.prompt_buckets) forms the same
    batches as the reference's; lengths past the table fall back to
    power-of-two buckets."""
    from paddle_tpu.framework.runtime_config import RuntimeConfig as RefRC
    from paddle_tpu_torch.framework.runtime_config import RuntimeConfig
    ref, port = _pair()
    g = dict(GEOM, max_batch_size=4, enable_prefix_cache=False)
    rp = RefPredictor(ref, runtime_config=RefRC(prompt_buckets=(12, 24)),
                      **g)
    pp = ContinuousBatchingPredictor(
        port, device="cpu", runtime_config=RuntimeConfig(
            prompt_buckets=(12, 24)), **g)
    assert [pp._bucket_len(n) for n in (3, 12, 13, 30)] == [12, 12, 24, 32]
    prompts = _prompts(4, (3, 11, 14, 30))
    assert pp.generate(prompts, max_new_tokens=5) == rp.generate(
        prompts, max_new_tokens=5)
    want_s, got_s = _shared_stats(rp, pp)
    assert got_s == want_s and got_s["prefill_batches"] == 3


def test_gqa_parity_with_admission_mid_flight():
    """GQA model; five prompts of mixed buckets through two slots, so
    requests join while others decode."""
    ref, port = _predictors({"num_key_value_heads": 2})
    prompts = _prompts(3, (6, 10, 20, 3, 17))
    assert port.generate(prompts, max_new_tokens=6) == ref.generate(
        prompts, max_new_tokens=6)
    want_s, got_s = _shared_stats(ref, port)
    assert got_s == want_s


def test_eos_stops_and_is_stripped():
    ref, port = _predictors()
    prompts = _prompts(2, (9, 4, 13))
    free = ref.generate(prompts, max_new_tokens=10)
    eos = free[1][3]
    ref2, port2 = _predictors(eos_token_id=eos)
    want = ref2.generate(prompts, max_new_tokens=10)
    assert port2.generate(prompts, max_new_tokens=10) == want
    assert eos not in want[1]


def test_strict_rejection():
    _, port = _predictors()
    ok, too_long = _prompts(8, (5, 60))
    with pytest.raises(ValueError):
        port.generate([ok, too_long], max_new_tokens=8)
    out = port.generate([ok, too_long], max_new_tokens=8, strict=False)
    assert out[1] == [] and len(out[0]) == 8
    assert port.last_status == ["ok", "rejected_over_max_seq_len"]
    small = ContinuousBatchingPredictor(port.model, device="cpu",
                                        num_pages=2, **GEOM)
    small.generate([ok, _prompts(9, (30,))[0]], max_new_tokens=8,
                   strict=False)
    assert small.last_status == ["ok", "rejected_over_pool_capacity"]


def _perturbed(ref):
    """Every reference weight + 0.5 * N(0, 1), from one seed."""
    rng = np.random.RandomState(7)
    return {k: (np.asarray(v.numpy()) + 0.5 * rng.standard_normal(
        v.shape)).astype(np.float32) for k, v in ref.state_dict().items()}


@pytest.mark.parametrize("load", ["in_place", "rebind"])
def test_weight_change_flushes_prefix_cache(load):
    """A prompt served, every weight changed, the same prompt served
    again: the cached K/V was computed with the old weights, so the
    second serve must not hit the prefix cache and must give the
    reference's tokens on the new weights. The port loads in place
    (``copy_``: the version counter moves) or rebinds each parameter's
    storage (``p.data =``: the data pointer moves)."""
    ref, port = _predictors()
    prompt = _prompts(2, (17,))
    assert port.generate(prompt, max_new_tokens=8) == ref.generate(
        prompt, max_new_tokens=8)
    new = _perturbed(ref.model)
    ref.model.set_state_dict(new)
    if load == "in_place":
        load_reference_state_dict(port.model, new)
    else:
        fresh = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
        load_reference_state_dict(fresh, new)
        with torch.no_grad():
            for p, q in zip(port.model.parameters(), fresh.parameters()):
                p.data = q.detach().clone()
    want = ref.generate(prompt, max_new_tokens=8)
    assert port.generate(prompt, max_new_tokens=8) == want
    assert port.stats["prefix_hits"] == ref.stats["prefix_hits"] == 0
    want_s, got_s = _shared_stats(ref, port)
    assert got_s == want_s
    # unchanged weights keep the cache: the third serve is a full hit
    assert port.generate(prompt, max_new_tokens=8) == ref.generate(
        prompt, max_new_tokens=8)
    assert port.stats["prefix_hits"] == ref.stats["prefix_hits"] == 1


# ---------------------------------------------------------- cache units --

def test_pool_refcount_and_copy_on_write():
    pool = PagedKVPool(n_layers=2, num_pages=4, page_size=4, n_kv_heads=1,
                       head_dim=2)
    a, b = pool.alloc(2)
    assert pool.free_count == 2
    pool.retain([a])
    pool.release([a])
    assert pool.free_count == 2              # still held once
    pool.k[0][a] = 7.0
    pool.v[1][a] = 3.0
    pool.copy_into(a, b)
    assert torch.equal(pool.k[0][b], torch.full((4, 1, 2), 7.0))
    assert torch.equal(pool.v[1][b], torch.full((4, 1, 2), 3.0))
    pool.release([a])
    pool.release([b])
    assert pool.free_count == 4 and pool.ref_count(a) == 0
    assert pool.alloc(5) is None


def test_prefix_cache_lookup_partial_and_lru_reclaim():
    pool = PagedKVPool(1, 6, 4, 1, 2)
    cache = PrefixCache(4)
    pool.reclaimer = cache
    p1 = list(range(10))                     # two full pages + 2 tokens
    ids = pool.alloc(3)
    cache.insert(p1, ids, list(range(100, 110)), pool)
    pool.release(ids)                        # only the trie holds them
    assert prefix_page_keys(p1, 4) == (tuple(range(4)), tuple(range(4, 8)))
    assert cache.lookup(p1) == (ids[:2], 8, (ids[2], 2), 109)
    assert cache.lookup(p1[:8]) == (ids[:2], 8, None, 107)
    pages, covered, partial, nt = cache.lookup(p1[:9] + [77])
    assert (pages, covered, partial, nt) == (ids[:2], 8, None, None)
    assert pool.free_count == 6              # 3 free + 3 reclaimable
    got = pool.alloc(5)                      # forces LRU reclaim
    assert got is not None and len(got) == 5
    assert cache.lookup(p1)[1] < 10          # something was dropped


# ------------------------------------------------------ isolation, device --

def test_port_imports_no_jax():
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.inference, "
            "paddle_tpu_torch.inference.aot, "
            "paddle_tpu_torch.framework.integrity, "
            "paddle_tpu_torch.convert, paddle_tpu_torch.trainer, "
            "paddle_tpu_torch.optimizer, paddle_tpu_torch.jit, "
            "paddle_tpu_torch.distributed, paddle_tpu_torch.nn, "
            "paddle_tpu_torch.models, paddle_tpu_torch.incubate.nn, "
            "paddle_tpu_torch.examples.bert_finetune, "
            "paddle_tpu_torch.serving, paddle_tpu_torch.framework.faults, "
            "paddle_tpu_torch.framework.flags, "
            "paddle_tpu_torch.inference.api, paddle_tpu_torch.inference.llm, "
            "paddle_tpu_torch.jit.api, paddle_tpu_torch.nn.quant, "
            "paddle_tpu_torch.framework_io, paddle_tpu_torch.models.gpt, "
            "paddle_tpu_torch.examples.llm_serve, "
            "paddle_tpu_torch.framework.graphs, "
            "paddle_tpu_torch.observability, "
            "paddle_tpu_torch.utils.tbwriter, paddle_tpu_torch.tensor, "
            "paddle_tpu_torch.framework.dtype, "
            "paddle_tpu_torch.framework.place, paddle_tpu_torch.autograd, "
            "paddle_tpu_torch.io._worker, paddle_tpu_torch._native, "
            "paddle_tpu_torch.vision.transforms, "
            "paddle_tpu_torch.vision.transforms_functional, "
            "paddle_tpu_torch.vision.datasets, "
            "paddle_tpu_torch.vision.models, "
            "paddle_tpu_torch.ops.manipulation; "
            "bad = lambda: 'jax' in sys.modules or any("
            "m == 'paddle_tpu' or m.startswith('paddle_tpu.') "
            "for m in sys.modules); "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not bad(), 'paddle_tpu imported'; "
            # the worker entry point: each worker reports its own modules
            "import numpy as np, paddle_tpu_torch.io as pio; "
            "Probe = type('Probe', (pio.Dataset,), {"
            "'__len__': lambda s: 4, "
            "'__getitem__': lambda s, i: np.array([int(bad())])}); "
            "got = [b.tolist() for b in pio.DataLoader(Probe(), "
            "places='cpu', batch_size=2, num_workers=2)]; "
            "assert got == [[[0], [0]], [[0], [0]]], got; "
            "assert not bad(), 'jax or paddle_tpu imported by a worker'")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=str(REPO), timeout=120)


def test_port_sources_never_name_the_reference_package():
    files = sorted((REPO / "paddle_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    bad = re.compile(r"^\s*(import|from)\s+(jax|paddle_tpu)\b(?!_torch)|"
                     r"\bpaddle_tpu\.|import jax", re.M)
    for f in files:
        hits = [m.group(0) for m in bad.finditer(f.read_text())]
        assert not hits, f"{f.relative_to(REPO)} names {hits}"


def test_default_device_requires_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(LlamaConfig.tiny())
    _, port = _pair()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousBatchingPredictor(port)
