"""The port's ``LLMPredictor`` and ``SpeculativePredictor``
(``paddle_tpu_torch/inference/llm.py``) against the reference's, on the
CPU.

Both packages serve one tiny Llama (weights moved with
``convert.load_reference_state_dict``) on the same prompts: buckets,
micro-batches, dummy rows and eos stripping must give the reference's
token lists exactly, with and without weight-only quantization (int8,
int4: the quantized weights agree within one f32 rounding of the same
codes, and the tokens must be equal); speculative decoding must give the
reference's tokens and ``stats`` with a draft that differs from the
target and with the target as its own draft. The ``cuda`` case holds
the predictor on the card to the CPU; the module imports nothing of JAX.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.convert import load_reference_state_dict
from paddle_tpu_torch.inference import LLMPredictor, SpeculativePredictor
from paddle_tpu_torch.kernels import launch_counts, reset_launch_counts
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

PROMPTS = [[5, 6, 7], [8, 9, 10, 11, 12], [13], [4] * 11, [7, 3, 9, 1, 2]]
DRAFT = dict(vocab_size=256, hidden_size=32, intermediate_size=64,
             num_hidden_layers=1, num_attention_heads=2,
             num_key_value_heads=2, max_position_embeddings=512,
             tensor_parallel=False)


@pytest.fixture(scope="module")
def ref():
    import paddle_tpu as paddle
    from paddle_tpu import inference
    from paddle_tpu.models import LlamaConfig as RefConfig
    from paddle_tpu.models import LlamaForCausalLM as RefLlama
    return paddle, inference, RefConfig, RefLlama


def _pair(ref, seed=0, cfg=None):
    paddle, _, RefConfig, RefLlama = ref
    paddle.seed(seed)
    r = RefLlama(RefConfig(**cfg) if cfg else
                 RefConfig.tiny(tensor_parallel=False))
    r.eval()
    p = LlamaForCausalLM(LlamaConfig(**cfg) if cfg else
                         LlamaConfig.tiny(tensor_parallel=False),
                         device="cpu")
    load_reference_state_dict(
        p, {k: np.asarray(v.numpy()) for k, v in r.state_dict().items()})
    return r, p


@pytest.mark.parametrize("batch", [2, 4, 8])
def test_buckets_and_micro_batches_match_reference(ref, batch):
    r, p = _pair(ref)
    want = ref[1].LLMPredictor(r, max_batch_size=batch).generate(
        PROMPTS, max_new_tokens=4)
    got = LLMPredictor(p, max_batch_size=batch).generate(PROMPTS,
                                                         max_new_tokens=4)
    assert got == want and len(got) == len(PROMPTS)
    assert LLMPredictor._bucket(3) == 8 and LLMPredictor._bucket(9) == 16


def test_batched_equals_solo_and_eos_is_stripped(ref):
    r, p = _pair(ref)
    pred = LLMPredictor(p, max_batch_size=4)
    outs = pred.generate(PROMPTS[:3], max_new_tokens=4)
    solo = p.generate(np.array([PROMPTS[0]]), max_new_tokens=4)[0]
    assert outs[0] == solo[0].tolist()
    eos = outs[1][1]                         # row 1's second token
    kw = dict(max_batch_size=4, eos_token_id=eos, seed=1)
    want = ref[1].LLMPredictor(r, **kw).generate(PROMPTS, max_new_tokens=6)
    got = LLMPredictor(p, **kw).generate(PROMPTS, max_new_tokens=6)
    assert got == want
    assert got[1] == outs[1][:1]             # cut at eos, pad tail gone
    assert all(eos not in row for row in got)


def test_call_kwargs_override_defaults(ref):
    r, p = _pair(ref)
    kw = dict(max_batch_size=2, eos_token_id=1, seed=4,
              decode_strategy="sampling", temperature=0.9, top_p=0.9)
    call = dict(max_new_tokens=5, eos_token_id=None, seed=6)
    want = ref[1].LLMPredictor(r, **kw).generate(PROMPTS, **call)
    got = LLMPredictor(p, **kw).generate(PROMPTS, **call)
    assert got == want


@pytest.mark.parametrize("quant", ["int8", "weight_only_int4"])
def test_weight_only_quantization_matches_reference(ref, quant):
    r, p = _pair(ref)
    emb = p.llama.embed_tokens.weight.detach().clone()
    q_ptr = p.llama.layers[0].self_attn.q_proj.weight.data_ptr()
    rq = ref[1].LLMPredictor(r, max_batch_size=4, quant_type=quant, seed=0)
    pq = LLMPredictor(p, max_batch_size=4, quant_type=quant, seed=0)
    # quantized in place: the address stays, embeddings untouched, and
    # every projection equals the reference's rounded weight
    assert p.llama.layers[0].self_attn.q_proj.weight.data_ptr() == q_ptr
    assert torch.equal(p.llama.embed_tokens.weight, emb)
    want_sd = {k: np.asarray(v.numpy()) for k, v in r.state_dict().items()}
    from paddle_tpu_torch.convert import export_reference_state_dict
    for k, a in export_reference_state_dict(p).items():
        np.testing.assert_allclose(a, want_sd[k], rtol=1e-6, atol=1e-7)
    assert rq.generate(PROMPTS, max_new_tokens=5) == \
        pq.generate(PROMPTS, max_new_tokens=5)
    with pytest.raises(ValueError, match="quant_type"):
        LLMPredictor(p, quant_type="fp4")


def test_int4_strips_the_pad_row_of_an_odd_in_dim():
    lin = torch.nn.Linear(5, 3, bias=False)
    model = torch.nn.Sequential(lin)
    before = lin.weight.detach().clone()
    LLMPredictor(model, quant_type="int4")
    assert lin.weight.shape == (3, 5)
    assert (lin.weight - before).abs().max() <= before.abs().max() / 7 / 2 \
        + 1e-6


@pytest.mark.parametrize("draft", ["small", "target"])
def test_speculative_matches_reference(ref, draft):
    r, p = _pair(ref)
    rd, pd = _pair(ref, 1, DRAFT) if draft == "small" else (r, p)
    want = ref[1].SpeculativePredictor(r, rd, gamma=4)
    got = SpeculativePredictor(p, pd, gamma=4)
    prompt = [5, 9, 23, 7]
    toks = got.generate(prompt, max_new_tokens=10)
    assert toks == want.generate(prompt, max_new_tokens=10)
    assert got.stats == want.stats
    # the output is the target's plain greedy decode
    assert toks == LLMPredictor(p, seed=0).generate([prompt],
                                                    max_new_tokens=10)[0]
    if draft == "target":
        assert got.stats["accepted"] == got.stats["proposed"]
        assert got.stats["target_calls"] <= 3


def test_speculative_eos_stops(ref):
    r, p = _pair(ref)
    first = SpeculativePredictor(p, p, gamma=3).generate([5, 9],
                                                         max_new_tokens=1)[0]
    spec = SpeculativePredictor(p, p, gamma=3, eos_token_id=first)
    out = spec.generate([5, 9], max_new_tokens=8)
    assert out == [first]
    want = ref[1].SpeculativePredictor(r, r, gamma=3, eos_token_id=first)
    assert want.generate([5, 9], max_new_tokens=8) == out
    assert spec.stats == want.stats


# ------------------------------------------------------------------- card --

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_llm_predictor_on_the_card_equals_cpu(cuda):
    cfg = LlamaConfig.tiny(hidden_size=256, num_attention_heads=2,
                           num_key_value_heads=2, intermediate_size=512)
    cpu = LlamaForCausalLM(cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    card = LlamaForCausalLM(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    want = LLMPredictor(cpu, max_batch_size=2).generate(PROMPTS, 6)
    reset_launch_counts()
    got = LLMPredictor(card, max_batch_size=2).generate(PROMPTS, 6)
    assert got == want
    calls = 3                     # micro-batches of 2
    assert launch_counts["flash_fwd"] == calls * 6 * cfg.num_hidden_layers
    want = SpeculativePredictor(cpu, cpu, gamma=3).generate(PROMPTS[3], 9)
    assert SpeculativePredictor(card, card, gamma=3).generate(
        PROMPTS[3], 9) == want
