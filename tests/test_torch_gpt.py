"""The port's GPT (``paddle_tpu_torch/models/gpt.py``: ``GPTConfig``,
``GPTBlock``, ``GPTModel``, ``GPTForCausalLM``, the HuggingFace GPT-2
import) and ``paddle_tpu_torch/examples/llm_serve.py`` against the
reference, on the CPU.

Weights move across with ``convert``; prompts come from a numpy seed,
ragged through ``attention_mask``. f32 logits within atol = rtol = 1e-5
(causal, and decoded one token at a time through the static cache and
through the tuple cache); tokens equal; scores within 1e-4. The module
imports nothing of JAX (the reference is imported in a fixture): the card
runs its ``cuda`` case, GPT-2 XL widths at 2 layers on the card against
the CPU, with ``python -m pytest --noconftest -m cuda
tests/test_torch_gpt.py``.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu_torch.convert import (export_reference_state_dict,
                                      load_reference_state_dict)
from paddle_tpu_torch.generation import StaticCacheEntry, StaticKVCache
from paddle_tpu_torch.models import GPTConfig, GPTForCausalLM

REPO = Path(__file__).resolve().parents[1]
LOGIT_TOL = dict(atol=1e-5, rtol=1e-5)
SCORE_TOL = dict(atol=1e-4, rtol=1e-4)
SAMPLED = dict(decode_strategy="sampling", temperature=0.8, top_k=40,
               top_p=0.9)
INIT = 0.3      # wider than GPT's 0.02: the tiny model's text varies


def _ref_state(ref):
    return {k: np.array(v.numpy()) for k, v in ref.state_dict().items()}


@pytest.fixture(scope="module")
def models():
    import paddle_tpu as paddle
    from paddle_tpu.models import GPTConfig as RefConfig
    from paddle_tpu.models import GPTForCausalLM as RefGPT
    paddle.seed(0)
    ref = RefGPT(RefConfig.tiny(tensor_parallel=False,
                                initializer_range=INIT))
    ref.eval()
    port = GPTForCausalLM(GPTConfig.tiny(initializer_range=INIT),
                          device="cpu")
    load_reference_state_dict(port, _ref_state(ref))
    return ref, port.eval()


def _ref_logits(ref, ids):
    import paddle_tpu as paddle
    out = ref(paddle.to_tensor(ids))
    return np.asarray((out[0] if isinstance(out, tuple) else out).numpy())


def test_causal_logits_match_reference(models):
    ref, port = models
    ids = np.random.RandomState(0).randint(5, 500, (2, 9))
    with torch.no_grad():
        got = port(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, _ref_logits(ref, ids), **LOGIT_TOL)


def test_tuple_cache_decode_matches_reference(models):
    """HF-style incremental decoding with tuple caches (the reference's
    ``test_gpt_tuple_cache_incremental_decode``): prefill 4 tokens, then
    one at a time; each step's logits equal the reference's full forward
    and its own tuple-cache step."""
    import paddle_tpu as paddle
    ref, port = models
    ids = np.random.RandomState(1).randint(5, 500, (1, 7))
    full = _ref_logits(ref, ids)
    r_logits, r_caches = ref(paddle.to_tensor(ids[:, :4]), use_cache=True)
    with torch.no_grad():
        logits, caches = port(torch.from_numpy(ids[:, :4]), use_cache=True)
        np.testing.assert_allclose(logits.numpy(), full[:, :4], **LOGIT_TOL)
        for t in range(4, 7):
            r_logits, r_caches = ref(paddle.to_tensor(ids[:, t:t + 1]),
                                     past_key_values=r_caches,
                                     use_cache=True)
            logits, caches = port(torch.from_numpy(ids[:, t:t + 1]),
                                  past_key_values=caches, use_cache=True)
            np.testing.assert_allclose(logits.numpy()[:, -1], full[:, t],
                                       **LOGIT_TOL)
            np.testing.assert_allclose(logits.numpy(),
                                       np.asarray(r_logits.numpy()),
                                       **LOGIT_TOL)
    assert caches[0][0].shape == (1, 7, 4, 16)


def test_static_cache_decode_matches_reference(models):
    """The ``StaticCacheEntry`` branch: an in-place write at ``pos`` and a
    bool key mask over the whole buffer, positions from ``position_ids``;
    each decoded step's logits equal the reference's full forward."""
    ref, port = models
    ids = np.random.RandomState(2).randint(5, 500, (2, 8))
    full = _ref_logits(ref, ids)
    cfg = port.config
    ml, s0 = 10, 5
    kv = [torch.zeros(2, ml, cfg.num_attention_heads,
                      cfg.hidden_size // cfg.num_attention_heads)
          for _ in range(2 * cfg.num_hidden_layers)]
    keys = torch.zeros(2, ml, dtype=torch.bool)

    def step(lo, hi):
        keys[:, lo:hi] = True
        q = torch.arange(lo, hi)[:, None]
        mask = (torch.arange(ml)[None, :] <= q)[None, None] \
            & keys[:, None, None, :]
        cache = StaticKVCache([StaticCacheEntry(kv[2 * i], kv[2 * i + 1], lo)
                               for i in range(cfg.num_hidden_layers)])
        pos = torch.arange(lo, hi)[None].expand(2, hi - lo)
        with torch.no_grad():
            logits, _ = port(torch.from_numpy(ids[:, lo:hi]), attn_mask=mask,
                             position_ids=pos, past_key_values=cache,
                             use_cache=True)
        return logits.numpy()

    np.testing.assert_allclose(step(0, s0), full[:, :s0], **LOGIT_TOL)
    for t in range(s0, ids.shape[1]):
        np.testing.assert_allclose(step(t, t + 1)[:, 0], full[:, t],
                                   **LOGIT_TOL)


def _batch(seed, b=3, s=9):
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, 512, (b, s))
    mask = np.ones_like(ids)
    mask[1, :4] = 0            # left padding
    mask[2, s - 3:] = 0        # right padding: generate left-pads it
    return ids, mask


CASES = {
    "greedy": dict(max_new_tokens=6),
    "sampled": dict(SAMPLED, max_new_tokens=6, seed=3),
    "greedy_eos_min_new_repetition": dict(max_new_tokens=7, eos=True,
                                          min_new_tokens=2,
                                          repetition_penalty=1.3),
    "sampled_eos": dict(SAMPLED, max_new_tokens=6, seed=8, eos=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_static_route_matches_reference(models, case):
    ref, port = models
    ids, mask = _batch(len(case))
    kw = dict(CASES[case])
    if kw.pop("eos", False):
        kw["eos_token_id"] = int(port.generate(
            ids, attention_mask=mask, max_new_tokens=3)[0][0, 2])
    want, want_s = ref.generate(ids, attention_mask=mask, **kw)
    got, got_s = port.generate(torch.from_numpy(ids), attention_mask=mask,
                               **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want.numpy()))
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s.numpy()),
                               **SCORE_TOL)
    assert len(np.unique(got.numpy())) > 3     # the text varies


def test_static_route_equals_eager_route(models):
    _, port = models
    ids, mask = _batch(4)
    for kw in ({}, dict(SAMPLED, seed=2)):
        s = port.generate(ids, attention_mask=mask, max_new_tokens=5, **kw)
        e = port.generate(ids, attention_mask=mask, max_new_tokens=5,
                          use_cache=False, **kw)
        assert torch.equal(s[0], e[0])


_HF_NAMES = ((".qkv", ".attn.c_attn"), (".proj", ".attn.c_proj"),
             (".fc1", ".mlp.c_fc"), (".fc2", ".mlp.c_proj"),
             (".ln1.", ".ln_1."), (".ln2.", ".ln_2."))


def _hf_state(state, n_layers, n_pos):
    """The reference's GPT weights under HuggingFace GPT-2's key names
    (``Conv1D`` keeps [in, out]), with the tied ``lm_head.weight`` alias
    and the ``attn.bias`` / ``attn.masked_bias`` buffers, as torch
    tensors."""
    hf = {}
    for k, v in state.items():
        n = k.replace("gpt.", "transformer.", 1)
        for ours, theirs in _HF_NAMES:
            n = n.replace(ours, theirs)
        hf[n] = torch.from_numpy(v.copy())
    hf["lm_head.weight"] = hf["transformer.wte.weight"]
    for i in range(n_layers):
        hf[f"transformer.h.{i}.attn.bias"] = torch.tril(
            torch.ones(n_pos, n_pos)).view(1, 1, n_pos, n_pos)
        hf[f"transformer.h.{i}.attn.masked_bias"] = torch.tensor(-1e4)
    return hf


def test_hf_import_matches_the_reference_import(models):
    import paddle_tpu as paddle
    from paddle_tpu.models import GPTConfig as RefConfig
    from paddle_tpu.models import GPTForCausalLM as RefGPT
    ref, _ = models
    cfg = ref.config
    hf = _hf_state(_ref_state(ref), cfg.num_hidden_layers,
                   cfg.max_position_embeddings)
    # both importers start from other weights than the fixture's
    paddle.seed(1)
    ref2 = RefGPT(RefConfig.tiny(tensor_parallel=False))
    ref2.load_hf_state_dict(hf)
    ref2.eval()
    port2 = GPTForCausalLM(GPTConfig.tiny(), device="cpu")
    port2.load_hf_state_dict(hf)
    ids = np.random.RandomState(6).randint(5, 500, (2, 9))
    with torch.no_grad():
        got = port2.eval()(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, _ref_logits(ref2, ids), **LOGIT_TOL)
    with pytest.raises(ValueError, match="mismatch"):
        port2.load_hf_state_dict({k: v for k, v in hf.items()
                                  if "ln_f" not in k})


def test_convert_round_trip_and_tied_head(models):
    ref, port = models
    want = _ref_state(ref)
    got = export_reference_state_dict(port)
    assert set(got) == set(want) and "lm_head.weight" not in got
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    # the head is wte: no second copy to write
    assert sum(1 for n, _ in port.named_parameters() if "wte" in n) == 1


def test_default_device_requires_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GPTForCausalLM(GPTConfig.tiny())


def test_llm_serve_example_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.examples.llm_serve",
         "--smoke", "--device", "cpu"], cwd=str(REPO), env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "OK"
    assert any(line.startswith("beam_search[4]: (4, 8)") for line in lines)


# ------------------------------------------------------------------- card --

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_gpt2_xl_widths_on_the_card_equal_cpu(cuda):
    """GPT-2 XL's widths (hidden 1600, 25 heads of 64, vocab 50257) at 2
    layers in f32: the card's static-route greedy, sampled and beam
    tokens equal the CPU's."""
    cfg = GPTConfig.gpt2_xl(num_hidden_layers=2)
    cpu = GPTForCausalLM(cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    card = GPTForCausalLM(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(3)
    ids = rng.randint(1, cfg.vocab_size, (3, 24))
    mask = np.ones_like(ids)
    mask[1, :9] = 0
    for kw in ({}, dict(SAMPLED, seed=5),
               dict(decode_strategy="beam_search", num_beams=4,
                    length_penalty=0.6)):
        want = cpu.generate(ids, attention_mask=mask, max_new_tokens=6,
                            **kw)
        got = card.generate(ids, attention_mask=mask, max_new_tokens=6,
                            **kw)
        assert torch.equal(got[0], want[0]), kw
        torch.testing.assert_close(got[1], want[1], **SCORE_TOL)
