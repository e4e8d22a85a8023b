"""Llama for serving and pretraining (counterpart of
``paddle_tpu/models/llama.py``).

Parameter names equal the reference state dict's (for example
``llama.layers.0.self_attn.q_proj.weight``), so ``convert.
load_reference_state_dict`` moves weights across by name. On one device
the reference's tensor-parallel Column/Row/VocabParallel layers compute
plain linear maps and embeddings, so both ``tensor_parallel`` settings
build ``nn.Linear``/``nn.Embedding`` here, as ``Layer``s (torch's draws at
construction, ``init_weights`` the reference's N(0, initializer_range));
``nn.Linear`` stores its weight as [out, in] where Paddle stores [in,
out]. Every class is an ``nn.Layer``, so the reference's
``set_state_dict`` / ``sublayers`` / hooks run on it.

The four attention branches of the reference are kept: the paged
decode cache (write, then paged attention), the static cache of
``generate()`` (an in-place write at ``pos``, then attention over the
whole buffer under the caller's bool mask), a past (K, V) tuple with an
additive mask (prefix-cache suffix prefill), and causal attention with
no past (prefill).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..amp import cast_inputs
from ..distributed.fleet.recompute import recompute
from ..framework import resolve_device
from ..generation import GenerationMixin
from ..generation.kv_cache import (PagedCacheEntry, StaticCacheEntry,
                                   paged_cache_update_attend,
                                   static_cache_update)
from ..incubate.nn.functional import swiglu
from ..kernels.norm import fused_rms_norm
from ..kernels.rope import apply_rotary_emb, rope_freqs
from ..nn import functional as PF
from ..nn.layer_base import Layer
from ..nn.layers_common import AmpLinear, Embedding, LayerList

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    initializer_range: float = 0.02
    tie_word_embeddings: bool = False
    use_recompute: bool = False
    tensor_parallel: bool = True
    dtype: str = "float32"

    @staticmethod
    def llama2_7b(**kw):
        return LlamaConfig(**kw)

    @staticmethod
    def tiny(**kw):
        base = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
                    num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=4, max_position_embeddings=256)
        base.update(kw)
        return LlamaConfig(**base)

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]


class LlamaRMSNorm(Layer):
    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(
            config.hidden_size, dtype=config.torch_dtype, device=device))
        self.variance_epsilon = config.rms_norm_eps

    def forward(self, x):
        x, w = cast_inputs("rms_norm", x, self.weight)
        return fused_rms_norm(x, w, self.variance_epsilon)


def _linear(n_in, n_out, config, device):
    return AmpLinear(n_in, n_out, bias=False, device=device,
                     dtype=config.torch_dtype)


class LlamaAttention(Layer):
    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        self.config = config
        self.hidden_size = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_key_value_heads
        self.head_dim = config.hidden_size // config.num_attention_heads
        hd = self.head_dim
        self.q_proj = _linear(self.hidden_size, self.num_heads * hd,
                              config, device)
        self.k_proj = _linear(self.hidden_size, self.num_kv_heads * hd,
                              config, device)
        self.v_proj = _linear(self.hidden_size, self.num_kv_heads * hd,
                              config, device)
        self.o_proj = _linear(self.num_heads * hd, self.hidden_size,
                              config, device)

    def forward(self, hidden_states, cos, sin, attn_mask=None,
                position_ids=None, past_key_value=None):
        b, s, _ = hidden_states.shape
        q = self.q_proj(hidden_states).reshape(b, s, self.num_heads,
                                               self.head_dim)
        k = self.k_proj(hidden_states).reshape(b, s, self.num_kv_heads,
                                               self.head_dim)
        v = self.v_proj(hidden_states).reshape(b, s, self.num_kv_heads,
                                               self.head_dim)
        q, k = apply_rotary_emb(*cast_inputs("fused_rope", q, k, cos, sin))

        if isinstance(past_key_value, PagedCacheEntry):
            # paged decode: write this step's K/V into each slot's page,
            # then attend with the paged-decode kernel
            out, new_cache = paged_cache_update_attend(past_key_value, q, k,
                                                       v)
            out = out.reshape(b, s, self.num_heads * self.head_dim)
            return self.o_proj(out), new_cache
        if isinstance(past_key_value, StaticCacheEntry):
            # static cache: write this step's K/V at ``pos`` in place
            k, v, new_cache = static_cache_update(past_key_value, k, v)
        else:
            if past_key_value is not None:
                k = torch.cat([past_key_value[0], k], dim=1)
                v = torch.cat([past_key_value[1], v], dim=1)
            new_cache = (k, v)
        # GQA: K/V heads are not repeated; the kernel maps query heads
        # onto their KV head
        causal = past_key_value is None
        out = PF.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, is_causal=causal,
            training=self.training)
        out = out.reshape(b, s, self.num_heads * self.head_dim)
        return self.o_proj(out), new_cache


class LlamaMLP(Layer):
    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        self.gate_proj = _linear(h, i, config, device)
        self.up_proj = _linear(h, i, config, device)
        self.down_proj = _linear(i, h, config, device)

    def forward(self, x):
        return self.down_proj(swiglu(self.gate_proj(x), self.up_proj(x)))


class LlamaDecoderLayer(Layer):
    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        self.self_attn = LlamaAttention(config, device)
        self.mlp = LlamaMLP(config, device)
        self.input_layernorm = LlamaRMSNorm(config, device)
        self.post_attention_layernorm = LlamaRMSNorm(config, device)

    def forward(self, hidden_states, cos, sin, attn_mask=None,
                position_ids=None, past_key_value=None):
        residual = hidden_states
        h = self.input_layernorm(hidden_states)
        h, cache = self.self_attn(h, cos, sin, attn_mask, position_ids,
                                  past_key_value)
        h = residual + h
        residual = h
        h2 = self.mlp(self.post_attention_layernorm(h))
        return residual + h2, cache


class LlamaModel(Layer):
    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        self.config = config
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size,
                                      device=device,
                                      dtype=config.torch_dtype)
        self.layers = LayerList(
            [LlamaDecoderLayer(config, device)
             for _ in range(config.num_hidden_layers)])
        self.norm = LlamaRMSNorm(config, device)
        cos, sin = rope_freqs(config.hidden_size // config.num_attention_heads,
                              config.max_position_embeddings,
                              config.rope_theta, device=device)
        # recomputed, never loaded: the reference keeps them out of its
        # state dict too
        self.register_buffer("rope_cos", cos, persistable=False)
        self.register_buffer("rope_sin", sin, persistable=False)

    def forward(self, input_ids, attn_mask=None, position_ids=None,
                past_key_values=None, use_cache=False):
        h = PF.embedding(input_ids, self.embed_tokens.weight)
        s = input_ids.shape[1]
        if position_ids is not None:
            # per-row positions (left-padded prompts): gather trig rows
            cos = self.rope_cos[position_ids]
            sin = self.rope_sin[position_ids]
        else:
            past_len = 0
            if isinstance(past_key_values, (list, tuple)) \
                    and past_key_values and past_key_values[0] is not None:
                past_len = past_key_values[0][0].shape[1]
            cos = self.rope_cos[past_len:past_len + s]
            sin = self.rope_sin[past_len:past_len + s]
        caches = []
        for i, layer in enumerate(self.layers):
            pkv = past_key_values[i] if past_key_values is not None else None
            if self.config.use_recompute and self.training and pkv is None:
                # activation recompute: the layer runs again in backward
                h, cache = recompute(layer, h, cos, sin, attn_mask,
                                     position_ids, None)
            else:
                h, cache = layer(h, cos, sin, attn_mask, position_ids, pkv)
            caches.append(cache)
        h = self.norm(h)
        if use_cache:
            return h, caches
        return h


class LlamaForCausalLM(Layer, GenerationMixin):
    """Llama with its LM head. ``device`` defaults to CUDA (raising when
    none is present); ``device="cpu"`` builds the plain-path model the
    CPU tests use. ``generate()`` takes the static-cache route of
    ``GenerationMixin`` unless ``use_cache=False``."""

    supports_static_cache = True

    def __init__(self, config: LlamaConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.llama = LlamaModel(config, device)
        self.lm_head = None if config.tie_word_embeddings else _linear(
            config.hidden_size, config.vocab_size, config, device)

    @property
    def device(self) -> torch.device:
        return self.llama.embed_tokens.weight.device

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Draw every matrix from N(0, initializer_range) with
        ``generator`` (on the model's device); norms start at one."""
        std = self.config.initializer_range
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Embedding)):
                m.weight.normal_(0.0, std, generator=generator)
            elif isinstance(m, LlamaRMSNorm):
                m.weight.fill_(1.0)
        return self

    def forward(self, input_ids, attn_mask=None, position_ids=None,
                past_key_values=None, use_cache=False):
        out = self.llama(input_ids, attn_mask, position_ids, past_key_values,
                         use_cache)
        h, caches = out if use_cache else (out, None)
        if self.lm_head is None:
            logits = torch.matmul(*cast_inputs(
                "matmul", h, self.llama.embed_tokens.weight.t()))
        else:
            logits = self.lm_head(h)
        if use_cache:
            return logits, caches
        return logits


class LlamaPretrainingCriterion(Layer):
    """Shifted-label causal LM loss: logits [B, S, V] at position t are
    scored against labels[:, t + 1] by ``cross_entropy`` (mean over the
    labels that are not ``ignore_index``)."""

    def __init__(self, config: LlamaConfig = None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, logits, labels):
        lg = logits[:, :-1, :]
        lb = labels[:, 1:]
        b, s, v = lg.shape
        return PF.cross_entropy(lg.reshape(b * s, v), lb.reshape(b * s),
                                ignore_index=self.ignore_index)
