"""Beam search of the port's ``generate()`` (``paddle_tpu_torch/
generation/__init__.py`` ``_generate_beam``, ``_build_beam_fn``,
``_generate_beam_eager``) against the reference's, on the CPU, for Llama
and GPT, and the static route's one program per signature
(``_gen_cache``, CUDA graphs on the card).

Weights move across with ``convert.load_reference_state_dict``; prompts
come from a numpy seed, ragged through ``attention_mask``. Tokens must be
equal; scores (the best beam's log-probability over the length penalty)
within atol = rtol = 1e-4. The module imports nothing of JAX (the
reference is imported in a fixture), so the card runs its ``cuda`` cases
with ``python -m pytest --noconftest -m cuda tests/test_torch_beam.py``:
a replayed graph equals the eager first call bit for bit and adds the
eager call's launch counts, a rebound weight re-captures, and the old
weight is freed though a signature captured against it is never called
again.
"""
import gc
import weakref

import numpy as np
import pytest
import torch

import paddle_tpu_torch.generation as G
from paddle_tpu_torch.convert import load_reference_state_dict
from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts
from paddle_tpu_torch.models import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                     LlamaForCausalLM)

SCORE_TOL = dict(atol=1e-4, rtol=1e-4)
BEAM = dict(decode_strategy="beam_search")


def _reference(family, init=None, edit=None):
    """(reference model, port model) with equal weights; ``edit`` may
    change the reference's numpy state dict before both load it."""
    import paddle_tpu as paddle
    from paddle_tpu.models import GPTConfig as RefGPTConfig
    from paddle_tpu.models import GPTForCausalLM as RefGPT
    from paddle_tpu.models import LlamaConfig as RefLlamaConfig
    from paddle_tpu.models import LlamaForCausalLM as RefLlama
    paddle.seed(0)
    if family == "llama":
        ref = RefLlama(RefLlamaConfig.tiny(tensor_parallel=False))
        port = LlamaForCausalLM(LlamaConfig.tiny(tensor_parallel=False),
                                device="cpu")
    else:
        # a wider initializer than GPT's 0.02: the tiny model's greedy
        # text then does not repeat one token
        kw = dict(tensor_parallel=False, initializer_range=init or 0.3)
        ref = RefGPT(RefGPTConfig.tiny(**kw))
        port = GPTForCausalLM(GPTConfig.tiny(**kw), device="cpu")
    state = {k: np.array(v.numpy()) for k, v in ref.state_dict().items()}
    if edit is not None:
        edit(state)
        ref.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    load_reference_state_dict(port, state)
    ref.eval()
    return ref, port.eval()


@pytest.fixture(scope="module", params=["llama", "gpt"])
def models(request):
    return request.param, *_reference(request.param)


def _batch(seed, vocab, b=3, s=9):
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, vocab, (b, s))
    mask = np.ones_like(ids)
    mask[1, :4] = 0            # left padding
    if b > 2:
        mask[2, s - 3:] = 0    # right padding: generate left-pads it
    return ids, mask


def _check(ref, port, ids, mask, **kw):
    want, want_s = ref.generate(ids, attention_mask=mask, **kw)
    got, got_s = port.generate(torch.from_numpy(ids), attention_mask=mask,
                               **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.numpy()))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s.numpy()),
                               **SCORE_TOL)
    return got.numpy()


def _eos(port, ids, mask, col=2):
    """A token the port's greedy text emits at column ``col`` of row 0:
    an eos that some beams reach."""
    return int(port.generate(ids, attention_mask=mask,
                             max_new_tokens=col + 1)[0][0, col])


CASES = {
    "k1": dict(num_beams=1, max_new_tokens=6),
    "k4": dict(num_beams=4, max_new_tokens=6),
    "k4_one_token": dict(num_beams=4, max_new_tokens=1),
    "k4_eos": dict(num_beams=4, max_new_tokens=7, eos=True, pad_token_id=1),
    "k4_min_new": dict(num_beams=4, max_new_tokens=7, eos=True,
                       min_new_tokens=3),
    "k3_length_penalty": dict(num_beams=3, max_new_tokens=6, eos=True,
                              length_penalty=0.6),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_static_beam_matches_reference(models, case):
    _, ref, port = models
    ids, mask = _batch(len(case), port.config.vocab_size)
    kw = dict(CASES[case])
    if kw.pop("eos", False):
        kw["eos_token_id"] = _eos(port, ids, mask)
    got = _check(ref, port, ids, mask, **BEAM, **kw)
    if kw.get("min_new_tokens"):
        assert (got[:, :kw["min_new_tokens"]] != kw["eos_token_id"]).all()


@pytest.mark.parametrize("case", ["k4_eos_padded", "k2_min_new"])
def test_eager_beam_matches_reference(models, case):
    """``use_cache=False``: beams from [0, NEG, ...], the stop once every
    beam finished, and a padded batch run row by row."""
    _, ref, port = models
    ids, mask = _batch(7, port.config.vocab_size, b=2, s=6)
    eos = _eos(port, ids, mask, col=1)
    kw = (dict(num_beams=4, max_new_tokens=4, eos_token_id=eos)
          if case == "k4_eos_padded" else
          dict(num_beams=2, max_new_tokens=4, eos_token_id=eos,
               min_new_tokens=2, length_penalty=0.6))
    _check(ref, port, ids, mask, use_cache=False, **BEAM, **kw)


def test_static_and_eager_beam_agree(models):
    _, _, port = models
    ids, mask = _batch(11, port.config.vocab_size)
    kw = dict(BEAM, num_beams=3, max_new_tokens=5)
    s, ss = port.generate(ids, attention_mask=mask, **kw)
    e, es = port.generate(ids, attention_mask=mask, use_cache=False, **kw)
    assert torch.equal(s, e)
    torch.testing.assert_close(ss, es, **SCORE_TOL)


def test_one_beam_equals_greedy(models):
    _, _, port = models
    ids, mask = _batch(5, port.config.vocab_size)
    g = port.generate(ids, attention_mask=mask, max_new_tokens=6)[0]
    b = port.generate(ids, attention_mask=mask, max_new_tokens=6, num_beams=1,
                      **BEAM)[0]
    assert torch.equal(g, b)


def test_num_beams_requires_beam_search(models):
    _, _, port = models
    ids, _ = _batch(0, port.config.vocab_size)
    with pytest.raises(ValueError, match="num_beams"):
        port.generate(ids, num_beams=2)
    with pytest.raises(ValueError, match="num_beams"):
        port.generate(ids, num_beams=2, decode_strategy="sampling")


EOS = 5


def _eos_magnet(family):
    """A state-dict edit that makes ``EOS`` the model's next token from
    the second position on: a shared direction d in every input (token
    or position) embedding reaches the last hidden state, and EOS's
    output row points along it."""
    def edit(state):
        rng = np.random.RandomState(3)
        if family == "llama":
            emb = state["llama.embed_tokens.weight"]
            d = rng.randn(emb.shape[1]).astype(np.float32)
            d /= np.linalg.norm(d)
            emb += d
            state["lm_head.weight"][:, EOS] = 2.0 * d
        else:
            wpe, wte = state["gpt.wpe.weight"], state["gpt.wte.weight"]
            d = rng.randn(wpe.shape[1]).astype(np.float32)
            d -= d.mean()            # LayerNorm keeps a zero-mean d
            d /= np.linalg.norm(d)
            wpe += 8.0 * d
            wte[EOS] += 8.0 * d
    return edit


@pytest.mark.parametrize("family", ["llama", "gpt"])
def test_all_finished_steps_are_identities(family, monkeypatch):
    """Every beam finishes long before N: the reference skips the model
    from then on (``lax.cond``); the port runs each such step as an exact
    identity, and the result is the reference's."""
    ref, port = _reference(family, init=0.05, edit=_eos_magnet(family))
    ids, mask = _batch(2, port.config.vocab_size)
    all_done = []
    real = G._beam_select

    def spy(scores, fin, logp, pad):
        all_done.append(bool(fin.all()))
        return real(scores, fin, logp, pad)
    monkeypatch.setattr(G, "_beam_select", spy)
    got = _check(ref, port, ids, mask, max_new_tokens=8, num_beams=4,
                 eos_token_id=EOS, min_new_tokens=1, length_penalty=0.6,
                 **BEAM)
    assert (got[:, 1] == EOS).all() and (got[:, 2:] == 0).all()
    # steps t >= 1 of 7 ran over a batch whose every beam had finished
    assert all_done[1:] == [True] * 6 and not all_done[0]


def test_gen_cache_keys_are_the_reference_signatures(models):
    _, ref, port = models
    ids, mask = _batch(4, port.config.vocab_size, s=7)   # a shape of its own
    ref_before = set(getattr(ref, "_gen_cache", {}))
    port_before = set(port.__dict__.get("_gen_cache", {}))
    for kw in (dict(max_new_tokens=3),
               dict(max_new_tokens=3, decode_strategy="sampling", seed=1,
                    top_k=5),
               dict(max_new_tokens=3, num_beams=2, length_penalty=0.6,
                    **BEAM)):
        ref.generate(ids, attention_mask=mask, **kw)
        port.generate(ids, attention_mask=mask, **kw)
    new = set(port._gen_cache) - port_before
    assert new == set(ref._gen_cache) - ref_before and len(new) == 3
    assert all(callable(f) for f in port._gen_cache.values())


# ------------------------------------------------------------------- card --

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _card_model(family, dev, seed=0):
    """An f32 model with head_dim 64 or 128 (the flash kernel's)."""
    if family == "llama":
        cfg = LlamaConfig.tiny(hidden_size=256, num_attention_heads=2,
                               num_key_value_heads=2, intermediate_size=512)
        cls = LlamaForCausalLM
    else:
        cfg = GPTConfig.tiny(hidden_size=128, num_attention_heads=2,
                             initializer_range=0.3)
        cls = GPTForCausalLM
    return cls(cfg, device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(seed))


ROUTES = {"greedy": {},
          "sampled": dict(decode_strategy="sampling", temperature=0.8,
                          top_k=20, top_p=0.9, seed=4, repetition_penalty=1.2),
          "beam": dict(BEAM, num_beams=4, length_penalty=0.6)}


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["llama", "gpt"])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_replay_equals_the_eager_first_call(cuda, family, route):
    model = _card_model(family, cuda)
    ids, mask = _batch(6, model.config.vocab_size, b=4, s=12)
    kw = dict(ROUTES[route], max_new_tokens=8)
    before = dict(G.graph_stats)
    reset_launch_counts()
    eager = model.generate(ids, attention_mask=mask, **kw)
    torch.cuda.synchronize()
    eager_counts = dict(launch_counts)
    assert G.graph_stats["captures"] == before["captures"] + 1
    for _ in range(2):
        reset_launch_counts()
        replay = model.generate(ids, attention_mask=mask, **kw)
        torch.cuda.synchronize()
        assert torch.equal(replay[0], eager[0])
        assert torch.equal(replay[1], eager[1])      # bit for bit
        assert dict(launch_counts) == eager_counts
    assert G.graph_stats["replays"] == before["replays"] + 2
    layers = model.config.num_hidden_layers
    norm = "rms_norm" if family == "llama" else "layer_norm"
    assert eager_counts[norm] == 8 * (2 * layers + 1)
    assert eager_counts["flash_fwd"] == 8 * layers
    assert eager_counts["categorical_rows"] == (8 if route == "sampled"
                                                else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_rebound_weight_recaptures(cuda, route):
    model = _card_model("llama", cuda)
    fresh = _card_model("llama", cuda, seed=1)
    ids, mask = _batch(8, model.config.vocab_size, b=2, s=10)
    kw = dict(ROUTES[route], max_new_tokens=6)
    model.generate(ids, attention_mask=mask, **kw)
    want = fresh.generate(ids, attention_mask=mask, **kw)
    # a load in place keeps every address: the graph replays
    before = dict(G.graph_stats)
    with torch.no_grad():
        for p, q in zip(model.parameters(), fresh.parameters()):
            p.copy_(q)
    got = model.generate(ids, attention_mask=mask, **kw)
    assert G.graph_stats["replays"] == before["replays"] + 1
    assert G.graph_stats["recaptures"] == before["recaptures"]
    assert torch.equal(got[0], want[0])
    # a rebound weight: the graph would read the old storage, so the
    # signature is captured again, and gives a freshly built model's tokens
    model.lm_head.weight = torch.nn.Parameter(
        model.lm_head.weight.detach().flip(0).clone())
    built = _card_model("llama", cuda, seed=1)
    built.lm_head.weight = torch.nn.Parameter(
        built.lm_head.weight.detach().flip(0).clone())
    want = built.generate(ids, attention_mask=mask, **kw)
    got = model.generate(ids, attention_mask=mask, **kw)
    assert G.graph_stats["recaptures"] == before["recaptures"] + 1
    assert torch.equal(got[0], want[0])
    assert torch.equal(model.generate(ids, attention_mask=mask, **kw)[0],
                       want[0])


@pytest.mark.cuda
def test_rebind_frees_the_old_weight(cuda):
    """The graphs read the weights by address and hold no reference to
    them: after a rebind the old weight goes with its last other owner,
    though one of the two signatures captured against it is never called
    again."""
    model = _card_model("llama", cuda)
    ids, mask = _batch(8, model.config.vocab_size, b=2, s=10)
    for n in (5, 6):
        model.generate(ids, attention_mask=mask, max_new_tokens=n)
    old = weakref.ref(model.lm_head.weight)
    model.lm_head.weight = torch.nn.Parameter(
        model.lm_head.weight.detach().flip(0).clone())
    before = dict(G.graph_stats)
    model.generate(ids, attention_mask=mask, max_new_tokens=6)
    assert G.graph_stats["recaptures"] == before["recaptures"] + 1
    gc.collect()
    assert old() is None
