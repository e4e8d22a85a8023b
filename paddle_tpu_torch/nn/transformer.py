"""Transformer encoder layers (counterpart of
``paddle_tpu/nn/transformer.py`` ``MultiHeadAttention``,
``TransformerEncoderLayer`` and ``TransformerEncoder``). Attention runs
through ``nn.functional.scaled_dot_product_attention`` (the flash
kernels, with their in-kernel dropout in training) on the [B, S, H, D]
layout; masks broadcast to [B, H, Sq, Sk], e.g. a [B, 1, 1, S] additive
or boolean key mask. The constructors take the reference's parameters in
its order (``kdim`` / ``vdim``, ``need_weights``, whose weights are
``None`` as in the reference, and ``weight_attr`` / ``bias_attr`` for
every projection), the port's ``device`` / ``dtype`` keyword-only after
them. The reference's incremental decoding caches (``gen_cache``,
``cache=``) are not ported.
"""
from __future__ import annotations

import copy

from . import functional as PF
from .layer_base import Layer
from .layers_common import Dropout, LayerList, LayerNorm, Linear


class MultiHeadAttention(Layer):
    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, *, device=None, dtype=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        kw = dict(device=device, dtype=dtype)
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.k_proj = Linear(self.kdim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.v_proj = Linear(self.vdim, embed_dim, weight_attr, bias_attr,
                             **kw)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr,
                               **kw)

    def _heads(self, x):
        b, s, _ = x.shape
        return x.reshape(b, s, self.num_heads, self.head_dim)

    def forward(self, query, key=None, value=None, attn_mask=None):
        key = query if key is None else key
        value = query if value is None else value
        q = self._heads(self.q_proj(query))
        k = self._heads(self.k_proj(key))
        v = self._heads(self.v_proj(value))
        out = PF.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            training=self.training)
        b, s = out.shape[0], out.shape[1]
        out = self.out_proj(out.reshape(b, s, self.embed_dim))
        return (out, None) if self.need_weights else out


class TransformerEncoderLayer(Layer):
    """Post-norm by default; ``normalize_before`` puts each LayerNorm in
    front of its sublayer. ``attn_dropout`` and ``act_dropout`` default
    to ``dropout``."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, *, device=None, dtype=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        kw = dict(device=device, dtype=dtype)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr, **kw)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr,
                              bias_attr, **kw)
        self.dropout = Dropout(act_dropout)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr,
                              bias_attr, **kw)
        self.norm1 = LayerNorm(d_model, layer_norm_eps, **kw)
        self.norm2 = LayerNorm(d_model, layer_norm_eps, **kw)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation = getattr(PF, activation)

    def forward(self, src, src_mask=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = residual + self.dropout1(self.self_attn(src, src, src,
                                                      src_mask))
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src


class TransformerEncoder(Layer):
    """``num_layers`` deep copies of ``encoder_layer`` (the first is the
    layer itself), as in the reference: every layer starts from the same
    weights until they are loaded or drawn anew."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = LayerList(
            [encoder_layer if i == 0 else copy.deepcopy(encoder_layer)
             for i in range(num_layers)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None):
        out = src
        for layer in self.layers:
            out = layer(out, src_mask)
        return out if self.norm is None else self.norm(out)
