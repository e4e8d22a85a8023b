"""GPT family (counterpart of ``paddle_tpu/models/gpt.py``): decoder-only
with learned positions, LayerNorm and tanh GELU, the LM head tied to the
token embedding.

Parameter names equal the reference state dict's (for example
``gpt.h.0.qkv.weight``), so ``convert.load_reference_state_dict`` moves
weights across by name; the tied head has no parameter of its own. On
one device the reference's Column/Row/VocabParallel layers compute plain
linear maps and embeddings, so both ``tensor_parallel`` settings build
``Linear``/``Embedding`` here.

The three attention branches of the reference are kept: the static cache
of ``generate()`` (an in-place write at ``pos``, then attention over the
whole buffer under the caller's mask), a past (K, V) tuple that grows by
concatenation, and causal attention with no past. LayerNorm runs through
``fused_layer_norm`` (eps 1e-5) and attention through the flash kernels.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from ..framework import resolve_device
from ..generation import GenerationMixin
from ..generation.kv_cache import (StaticCacheEntry, StaticKVCache,
                                   static_cache_update)
from ..nn import functional as PF
from ..nn.layers_common import Dropout, Embedding, LayerList, LayerNorm, Linear
from ._hf_import import hf_tensor_to_numpy, validate_keys
from .llama import _DTYPES


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 1024
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    initializer_range: float = 0.02
    tensor_parallel: bool = False
    dtype: str = "float32"

    @staticmethod
    def tiny(**kw):
        base = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=128,
                    max_position_embeddings=128)
        base.update(kw)
        return GPTConfig(**base)

    @staticmethod
    def gpt2_xl(**kw):
        """GPT-2 XL's published widths (HF ``gpt2-xl`` ``config.json``:
        n_embd 1600, n_head 25, n_layer 48, n_inner 4 * 1600, vocab
        50257, n_positions 1024)."""
        base = dict(vocab_size=50257, hidden_size=1600, num_hidden_layers=48,
                    num_attention_heads=25, intermediate_size=6400,
                    max_position_embeddings=1024)
        base.update(kw)
        return GPTConfig(**base)

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


class GPTBlock(nn.Module):
    def __init__(self, config: GPTConfig, device=None):
        super().__init__()
        h, heads = config.hidden_size, config.num_attention_heads
        dt = config.torch_dtype
        self.head_dim = h // heads
        self.num_heads = heads
        self.qkv = Linear(h, 3 * h, device=device, dtype=dt)
        self.proj = Linear(h, h, device=device, dtype=dt)
        self.fc1 = Linear(h, config.intermediate_size, device=device,
                          dtype=dt)
        self.fc2 = Linear(config.intermediate_size, h, device=device,
                          dtype=dt)
        self.ln1 = LayerNorm(h, device=device, dtype=dt)
        self.ln2 = LayerNorm(h, device=device, dtype=dt)
        self.attn_drop = config.attention_probs_dropout_prob
        self.drop = Dropout(config.hidden_dropout_prob)

    def forward(self, x, attn_mask=None, past_key_value=None):
        b, s, h = x.shape
        y = self.ln1(x)
        qkv = self.qkv(y).reshape(b, s, 3, self.num_heads, self.head_dim)
        # unbind gives strided views; one copy each before the cache write
        # and the kernel, which takes contiguous q, k and v
        q, k, v = (t.contiguous() for t in qkv.unbind(2))
        if isinstance(past_key_value, StaticCacheEntry):
            # static-shape decode cache: in-place write at ``pos``
            k, v, new_cache = static_cache_update(past_key_value, k, v)
        elif past_key_value is not None:
            # HF/PaddleNLP-style tuple cache: grow by concatenation
            k = torch.cat([past_key_value[0], k], dim=1)
            v = torch.cat([past_key_value[1], v], dim=1)
            new_cache = (k, v)
        else:
            new_cache = (k, v)
        causal = past_key_value is None
        att = PF.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.attn_drop,
            is_causal=causal, training=self.training)
        x = x + self.drop(self.proj(att.reshape(b, s, h)))
        y = self.fc2(PF.gelu(self.fc1(self.ln2(x)), approximate=True))
        return x + self.drop(y), new_cache


class GPTModel(nn.Module):
    def __init__(self, config: GPTConfig, device=None):
        super().__init__()
        self.config = config
        std, dt = config.initializer_range, config.torch_dtype
        self.wte = Embedding(config.vocab_size, config.hidden_size, std=std,
                             device=device, dtype=dt)
        self.wpe = Embedding(config.max_position_embeddings,
                             config.hidden_size, std=std, device=device,
                             dtype=dt)
        self.drop = Dropout(config.hidden_dropout_prob)
        self.h = LayerList([GPTBlock(config, device)
                            for _ in range(config.num_hidden_layers)])
        self.ln_f = LayerNorm(config.hidden_size, device=device, dtype=dt)

    def forward(self, input_ids, attn_mask=None, position_ids=None,
                past_key_values=None, use_cache=False):
        s = input_ids.shape[1]
        if position_ids is not None:
            pos = position_ids
        else:
            past_len = 0
            if (past_key_values is not None
                    and not isinstance(past_key_values, StaticKVCache)
                    and past_key_values[0] is not None):
                past_len = past_key_values[0][0].shape[1]
            pos = torch.arange(past_len, past_len + s,
                               device=input_ids.device)
        x = self.drop(self.wte(input_ids) + self.wpe(pos))
        caches = []
        for i, block in enumerate(self.h):
            pkv = past_key_values[i] if past_key_values is not None else None
            x, cache = block(x, attn_mask=attn_mask, past_key_value=pkv)
            caches.append(cache)
        x = self.ln_f(x)
        if use_cache:
            return x, caches
        return x


class GPTForCausalLM(nn.Module, GenerationMixin):
    """GPT with its LM head tied to ``wte``. ``device`` defaults to CUDA
    (raising when none is present); ``device="cpu"`` builds the
    plain-path model the CPU tests use. ``generate()`` takes the
    static-cache route of ``GenerationMixin`` unless ``use_cache=False``."""

    supports_static_cache = True

    def __init__(self, config: GPTConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.gpt = GPTModel(config, device)

    @property
    def device(self) -> torch.device:
        return self.gpt.wte.weight.device

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Draw every linear and embedding weight from N(0,
        initializer_range) with ``generator`` (on the model's device), as
        the reference's ``Normal`` initializer; biases start at zero,
        LayerNorms at weight one and bias zero."""
        std = self.config.initializer_range
        for m in self.modules():
            if isinstance(m, (Linear, Embedding)):
                m.weight.normal_(0.0, std, generator=generator)
                if isinstance(m, Linear):
                    m.bias.zero_()
            elif isinstance(m, LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        return self

    def load_hf_state_dict(self, hf_state_dict):
        """Import HuggingFace GPT-2 weights — see ``_load_hf_gpt2``."""
        return _load_hf_gpt2(self, hf_state_dict)

    def forward(self, input_ids, attn_mask=None, position_ids=None,
                past_key_values=None, use_cache=False):
        out = self.gpt(input_ids, attn_mask, position_ids, past_key_values,
                       use_cache)
        h, caches = out if use_cache else (out, None)
        logits = torch.matmul(h, self.gpt.wte.weight.t())
        if use_cache:
            return logits, caches
        return logits


def _gpt2_hf_key(name):
    """HF GPT-2 key -> the port's key (transformer.h.N.attn.c_attn ->
    gpt.h.N.qkv etc.)."""
    n = name.replace("transformer.", "gpt.")
    return (n.replace(".attn.c_attn", ".qkv")
             .replace(".attn.c_proj", ".proj")
             .replace(".mlp.c_fc", ".fc1")
             .replace(".mlp.c_proj", ".fc2")
             .replace(".ln_1.", ".ln1.")
             .replace(".ln_2.", ".ln2."))


_HF_LINEARS = (".qkv.weight", ".proj.weight", ".fc1.weight", ".fc2.weight")


@torch.no_grad()
def _load_hf_gpt2(model, hf_state_dict):
    """Import HuggingFace GPT-2 weights. The LM head is tied to ``wte`` in
    both models, so HF's alias key is skipped; the ``attn.bias`` /
    ``attn.masked_bias`` causal-mask buffers are layout artifacts, not
    parameters. HF's ``Conv1D`` stores [in, out], ``nn.Linear`` [out, in]:
    the four projections are transposed."""
    sd = {}
    for name, p in hf_state_dict.items():
        if name == "lm_head.weight" or name.endswith(".attn.bias") \
                or name.endswith(".attn.masked_bias"):
            continue
        key = _gpt2_hf_key(name)
        a = hf_tensor_to_numpy(p)
        if key.endswith(_HF_LINEARS):
            a = a.T
        sd[key] = np.ascontiguousarray(a)
    validate_keys(model, sd, "HF GPT-2")
    for key, t in model.state_dict(keep_vars=True).items():
        a = torch.from_numpy(sd[key])
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"HF GPT-2 {key}: shape {tuple(a.shape)} does "
                             f"not fit {tuple(t.shape)}")
        t.copy_(a)
    return model
