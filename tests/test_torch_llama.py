"""Tiny-Llama parity between the port and the JAX reference.

Both models hold the same weights (moved with
``paddle_tpu_torch.convert.load_reference_state_dict``) and get the same
seeded token ids. f32 logits must agree to atol = rtol = 1e-5 (the same
math; matmuls summed in another order). Covers MHA and GQA, both
``tensor_parallel`` settings, tied embeddings, and the three attention
branches of a serving forward: causal (no past), the left-padded prefill
mask with per-row positions, and a past (K, V) tuple with a suffix mask.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as RefConfig
from paddle_tpu.models import LlamaForCausalLM as RefLlama
from paddle_tpu.tensor import Tensor

from paddle_tpu_torch.convert import load_reference_state_dict
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

TOL = dict(atol=1e-5, rtol=1e-5)
NEG = -1e30

CONFIGS = {
    "mha": {},
    "gqa": {"num_key_value_heads": 2},
    "no_tp": {"tensor_parallel": False},
    "gqa_no_tp": {"num_key_value_heads": 1, "tensor_parallel": False},
    "tied": {"tie_word_embeddings": True},
    "tied_no_tp": {"tie_word_embeddings": True, "tensor_parallel": False},
}


def _pair(**kw):
    paddle.seed(0)
    ref = RefLlama(RefConfig.tiny(**kw))
    ref.eval()
    port = LlamaForCausalLM(LlamaConfig.tiny(**kw), device="cpu")
    load_reference_state_dict(
        port, {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()})
    port.eval()
    return ref, port


def _ref_out(ref, ids, **kw):
    with paddle.no_grad():
        out = ref(Tensor(ids), **kw)
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_causal_logits_parity(name):
    ref, port = _pair(**CONFIGS[name])
    ids = np.random.RandomState(0).randint(0, 256, (2, 11)).astype(np.int64)
    want = np.asarray(_ref_out(ref, ids).numpy())
    with torch.no_grad():
        got = port(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("name", ["mha", "gqa"])
def test_left_padded_prefill_parity(name):
    """The predictor's prefill call: causal + padding mask, per-row
    positions; compared on the real (non-padding) positions."""
    ref, port = _pair(**CONFIGS[name])
    rng = np.random.RandomState(1)
    s, lens = 16, np.array([16, 9, 3])
    ids = rng.randint(1, 256, (3, s)).astype(np.int64)
    pos = np.zeros((3, s), np.int64)
    j = np.arange(s)
    for i, L in enumerate(lens):
        ids[i, :s - L] = 0
        pos[i, s - L:] = np.arange(L)
    key_valid = j[None, :] >= (s - lens)[:, None]
    ok = key_valid[:, None, :] & (j[None, :] <= j[:, None])[None]
    mask = np.where(ok, 0.0, NEG).astype(np.float32)[:, None]
    want = np.asarray(_ref_out(ref, ids, attn_mask=Tensor(mask),
                               position_ids=Tensor(pos)).numpy())
    with torch.no_grad():
        got = port(torch.from_numpy(ids), attn_mask=torch.from_numpy(mask),
                   position_ids=torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(got[key_valid], want[key_valid], **TOL)


@pytest.mark.parametrize("name", ["mha", "gqa"])
def test_past_tuple_suffix_parity(name):
    """The suffix-prefill call: cached prefix K/V as a past tuple, an
    additive mask over [past | suffix], non-causal; the K/V the port
    returns must match too."""
    ref, port = _pair(**CONFIGS[name])
    cfg = port.config
    hd = cfg.hidden_size // cfg.num_attention_heads
    rng = np.random.RandomState(2)
    past_len, sb, m = 8, 8, 6           # 6 of 8 cached positions valid
    pk = [rng.randn(1, past_len, cfg.num_key_value_heads, hd)
          .astype(np.float32) for _ in range(cfg.num_hidden_layers)]
    pv = [rng.randn(*a.shape).astype(np.float32) for a in pk]
    ids = rng.randint(1, 256, (1, sb)).astype(np.int64)
    pos = (m + np.arange(sb))[None].astype(np.int64)
    past_ok = np.broadcast_to(np.arange(past_len)[None] < m, (sb, past_len))
    suf_ok = np.arange(sb)[None, :] <= np.arange(sb)[:, None]
    mask = np.where(np.concatenate([past_ok, suf_ok], 1), 0.0,
                    NEG).astype(np.float32)[None, None]
    want, wcache = _ref_out(
        ref, ids, attn_mask=Tensor(mask), position_ids=Tensor(pos),
        past_key_values=[(Tensor(a), Tensor(b)) for a, b in zip(pk, pv)],
        use_cache=True)
    with torch.no_grad():
        got, gcache = port(
            torch.from_numpy(ids), attn_mask=torch.from_numpy(mask),
            position_ids=torch.from_numpy(pos),
            past_key_values=[(torch.from_numpy(a), torch.from_numpy(b))
                             for a, b in zip(pk, pv)], use_cache=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want.numpy()), **TOL)
    for (gk, gv), (wk, wv) in zip(gcache, wcache):
        np.testing.assert_allclose(gk.numpy(), np.asarray(wk.numpy()), **TOL)
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv.numpy()), **TOL)


def test_convert_rejects_mismatched_state():
    ref, port = _pair()
    sd = {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}
    sd.pop("lm_head.weight")
    with pytest.raises(KeyError):
        load_reference_state_dict(port, sd)
    _, tied = _pair(tie_word_embeddings=True)
    with pytest.raises(KeyError):        # the untied head has no home
        load_reference_state_dict(
            tied, {k: np.asarray(v.numpy())
                   for k, v in ref.state_dict().items()})


def test_rope_buffers_are_recomputed_not_state():
    _, port = _pair()
    assert not any("rope" in k for k in port.state_dict())
    from paddle_tpu.kernels.rope import rope_freqs as ref_freqs
    cos, sin = ref_freqs(32, 256)
    np.testing.assert_allclose(port.llama.rope_cos.numpy(), np.asarray(cos),
                               atol=1e-6)
    np.testing.assert_allclose(port.llama.rope_sin.numpy(), np.asarray(sin),
                               atol=1e-6)
