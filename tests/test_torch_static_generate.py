"""The static-cache route of the port's ``generate()``
(``paddle_tpu_torch/generation/__init__.py`` ``_generate_static``,
``_make_cache_runner``, ``_cache_prefill``, ``_build_static_fn``; the
``StaticCacheEntry`` branch of ``models/llama.py``) against the
reference's jitted static route, on the CPU.

Weights move across with ``convert.load_reference_state_dict``; prompts
come from a numpy seed, ragged through ``attention_mask`` (left-padded
by ``generate``). Tokens must be equal token for token; scores (the mean
log-probability of the emitted tokens) within atol = rtol = 1e-4 (f32
sums in other orders over a tiny vocab). The ``cuda`` cases hold the
route on the card to the CPU's tokens and count its kernel launches; the
module imports nothing of JAX (the reference is imported in a fixture),
so the card runs them with ``python -m pytest --noconftest -m cuda
tests/test_torch_static_generate.py``.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.convert import load_reference_state_dict
from paddle_tpu_torch.generation import (GenerationMixin, StaticCacheEntry,
                                         static_cache_update)
from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts
from paddle_tpu_torch.kernels.attention import flash_attention_plain
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

SCORE_TOL = dict(atol=1e-4, rtol=1e-4)
SAMPLED = dict(decode_strategy="sampling", temperature=0.8, top_k=12,
               top_p=0.9)


@pytest.fixture(scope="module")
def models():
    import paddle_tpu as paddle
    from paddle_tpu.models import LlamaConfig as RefConfig
    from paddle_tpu.models import LlamaForCausalLM as RefLlama
    paddle.seed(0)
    ref = RefLlama(RefConfig.tiny(tensor_parallel=False))
    ref.eval()
    port = LlamaForCausalLM(LlamaConfig.tiny(tensor_parallel=False),
                            device="cpu")
    load_reference_state_dict(
        port, {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()})
    return ref, port.eval()


def _batch(seed, b=3, s=9):
    rng = np.random.RandomState(seed)
    ids = rng.randint(2, 256, (b, s))
    mask = np.ones_like(ids)
    mask[1, :4] = 0            # left padding
    mask[2, s - 3:] = 0        # right padding: generate left-pads it
    return ids, mask


def _check(ref, port, ids, mask, **kw):
    want, want_s = ref.generate(ids, attention_mask=mask, **kw)
    got, got_s = port.generate(torch.from_numpy(ids), attention_mask=mask,
                               **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.numpy()))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s.numpy()),
                               **SCORE_TOL)
    return got.numpy()


CASES = {
    "greedy": dict(max_new_tokens=6),
    "greedy_one_token": dict(max_new_tokens=1),
    "sampled": dict(SAMPLED, max_new_tokens=6, seed=3),
    "sampled_negative_seed": dict(SAMPLED, max_new_tokens=5, seed=-4),
    "repetition_min_new": dict(max_new_tokens=7, repetition_penalty=1.3,
                               min_new_tokens=3, eos_token_id=5),
    "sampled_repetition": dict(max_new_tokens=6, decode_strategy="sampling",
                               temperature=1.0, seed=11,
                               repetition_penalty=0.7),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_static_route_matches_reference(models, case):
    ref, port = models
    ids, mask = _batch(len(case))
    _check(ref, port, ids, mask, **CASES[case])


@pytest.mark.parametrize("sampled", [False, True])
def test_eos_stops_rows_and_pads_the_tail(models, sampled):
    ref, port = models
    ids, mask = _batch(1)
    kw = dict(SAMPLED, seed=5) if sampled else {}
    first = port.generate(ids, attention_mask=mask, max_new_tokens=8,
                          **kw)[0].numpy()
    eos = int(first[0, 2])      # row 0's third token
    got = _check(ref, port, ids, mask, max_new_tokens=8, eos_token_id=eos,
                 pad_token_id=1, **kw)
    stop = list(got[0]).index(eos)
    assert stop <= 2 and (got[0, stop + 1:] == 1).all()
    # min_new_tokens holds eos back on every row
    got = _check(ref, port, ids, mask, max_new_tokens=8, eos_token_id=eos,
                 min_new_tokens=8, **kw)
    assert eos not in got


def test_routes_follow_use_cache(models, monkeypatch):
    ref, port = models
    ids, mask = _batch(2)
    routes = []
    for name in ("_generate_static", "_generate_eager"):
        real = getattr(GenerationMixin, name)

        def spy(self, *a, _real=real, _name=name):
            routes.append(_name)
            return _real(self, *a)
        monkeypatch.setattr(GenerationMixin, name, spy)
    static = port.generate(ids, attention_mask=mask, max_new_tokens=5)[0]
    assert routes == ["_generate_static"]
    eager = port.generate(ids, attention_mask=mask, max_new_tokens=5,
                          use_cache=False)[0]
    assert routes[1:] == ["_generate_eager"] * (1 + ids.shape[0])
    # the two routes emit the same stream, as the reference's do
    assert torch.equal(static, eager)
    assert LlamaForCausalLM.supports_static_cache


def test_ragged_batch_equals_solo_runs(models):
    _, port = models
    ids = np.array([[7, 8, 9, 10, 11], [3, 4, 5, 0, 0]])
    mask = np.array([[1, 1, 1, 1, 1], [1, 1, 1, 0, 0]])
    batched = port.generate(ids, attention_mask=mask, max_new_tokens=5)[0]
    solo0 = port.generate(ids[0:1], max_new_tokens=5)[0]
    solo1 = port.generate(ids[1:2, :3], max_new_tokens=5)[0]
    assert torch.equal(batched[0], solo0[0])
    assert torch.equal(batched[1], solo1[0])


def test_static_cache_update_writes_in_place():
    k = torch.zeros(2, 6, 1, 4)
    v = torch.zeros(2, 6, 1, 4)
    entry = StaticCacheEntry(k, v, 3)
    nk, nv = torch.ones(2, 2, 1, 4), torch.full((2, 2, 1, 4), 2.0)
    ck, cv, e = static_cache_update(entry, nk, nv)
    assert ck.data_ptr() == k.data_ptr() and e is entry
    assert (k[:, 3:5] == 1).all() and (v[:, 3:5] == 2).all()
    assert (k[:, :3] == 0).all() and (k[:, 5:] == 0).all()


def test_pad_query_rows_are_finite():
    """A left-pad query row of the prefill sees no valid key: the plain
    version (and the kernel, held to it on the card) gives the uniform
    average of the cached values, finite, which later steps never read."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 4, 2, 64, generator=g)
    k = torch.randn(2, 7, 2, 64, generator=g)
    v = torch.randn(2, 7, 2, 64, generator=g)
    keep = torch.ones(2, 1, 4, 7, dtype=torch.bool)
    keep[1, :, :2] = False                  # two rows with no valid key
    mask = torch.where(keep, 0.0, -1e30)
    out = flash_attention_plain(q, k, v, 0.125, mask=mask)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out[1, :2],
                               v[1].mean(0, keepdim=True).expand(2, 2, 64))


# ------------------------------------------------------------------- card --

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _card_pair(dev):
    """An f32 model with head_dim 128 (the flash kernel's) on the card and
    its copy on the CPU."""
    cfg = LlamaConfig.tiny(hidden_size=256, num_attention_heads=2,
                           num_key_value_heads=2, intermediate_size=512)
    cpu = LlamaForCausalLM(cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    card = LlamaForCausalLM(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    return cpu, card


@pytest.mark.cuda
@pytest.mark.parametrize("sampled", [False, True])
def test_static_route_on_the_card_equals_cpu(cuda, sampled):
    cpu, card = _card_pair(cuda)
    ids, mask = _batch(4, b=4, s=12)
    kw = dict(SAMPLED, seed=9) if sampled else {}
    want = cpu.generate(ids, attention_mask=mask, max_new_tokens=8, **kw)
    reset_launch_counts()
    got = card.generate(ids, attention_mask=mask, max_new_tokens=8, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], **SCORE_TOL)
    layers = card.config.num_hidden_layers
    assert launch_counts["rms_norm"] == 8 * (2 * layers + 1)
    assert launch_counts["flash_fwd"] == 8 * layers
    assert launch_counts["categorical_rows"] == (8 if sampled else 0)
