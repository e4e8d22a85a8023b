"""BERT for sequence classification (counterpart of
``paddle_tpu/models/bert.py`` ``BertConfig``, ``BertEmbeddings``,
``BertPooler``, ``BertModel`` and ``BertForSequenceClassification``).

Parameter names equal the reference state dict's (for example
``bert.encoder.layers.0.self_attn.q_proj.weight``), so ``convert.
load_reference_state_dict`` moves weights across by name. The model runs
in float32, as the reference's fine-tuning example does. A 2-D
``attention_mask`` of 1 (token) and 0 (padding) becomes the additive
[B, 1, 1, S] mask ``(1 - m) * -1e4``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..framework import resolve_device
from ..nn import functional as PF
from ..nn.initializer import Normal
from ..nn.layer_base import Layer
from ..nn.layers_common import Dropout, Embedding, LayerNorm, Linear
from ..nn.transformer import TransformerEncoder, TransformerEncoderLayer


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    num_labels: int = 2

    @staticmethod
    def base(**kw):
        return BertConfig(**kw)

    @staticmethod
    def tiny(**kw):
        base = dict(vocab_size=1000, hidden_size=64, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=128,
                    max_position_embeddings=128)
        base.update(kw)
        return BertConfig(**base)


@torch.no_grad()
def init_encoder_weights(model: nn.Module, std: float,
                         generator: torch.Generator):
    """Draw every linear and embedding weight of ``model`` from N(0, std)
    with ``generator`` (on the model's device); biases start at zero,
    LayerNorms at weight one and bias zero."""
    for m in model.modules():
        if isinstance(m, (Linear, Embedding)):
            m.weight.normal_(0.0, std, generator=generator)
            if isinstance(m, Linear):
                m.bias.zero_()
        elif isinstance(m, LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return model


class BertEmbeddings(Layer):
    def __init__(self, config: BertConfig, device=None):
        super().__init__()
        init = Normal(0.0, config.initializer_range)
        h = config.hidden_size
        self.word_embeddings = Embedding(config.vocab_size, h, weight_attr=init,
                                         device=device)
        self.position_embeddings = Embedding(config.max_position_embeddings,
                                             h, weight_attr=init, device=device)
        self.token_type_embeddings = Embedding(config.type_vocab_size, h,
                                               weight_attr=init, device=device)
        self.layer_norm = LayerNorm(h, config.layer_norm_eps, device=device)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        s = input_ids.shape[1]
        if position_ids is None:
            position_ids = torch.arange(s, device=input_ids.device)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        emb = (self.word_embeddings(input_ids)
               + self.position_embeddings(position_ids)
               + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(emb))


class BertPooler(Layer):
    def __init__(self, config: BertConfig, device=None):
        super().__init__()
        self.dense = Linear(config.hidden_size, config.hidden_size,
                            device=device)

    def forward(self, hidden_states):
        return PF.tanh(self.dense(hidden_states[:, 0]))


class BertModel(Layer):
    def __init__(self, config: BertConfig, device=None):
        super().__init__()
        self.config = config
        self.embeddings = BertEmbeddings(config, device)
        layer = TransformerEncoderLayer(
            config.hidden_size, config.num_attention_heads,
            config.intermediate_size, dropout=config.hidden_dropout_prob,
            activation=config.hidden_act,
            attn_dropout=config.attention_probs_dropout_prob,
            layer_norm_eps=config.layer_norm_eps, device=device)
        self.encoder = TransformerEncoder(layer, config.num_hidden_layers)
        self.pooler = BertPooler(config, device)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        if attention_mask is not None and attention_mask.dim() == 2:
            am = attention_mask[:, None, None, :]
            attention_mask = (1.0 - am.float()) * -1e4
        h = self.embeddings(input_ids, token_type_ids, position_ids)
        h = self.encoder(h, attention_mask)
        return h, self.pooler(h)


class BertForSequenceClassification(Layer):
    """BERT with a dropout and a linear classifier over the pooled first
    token. ``device`` defaults to CUDA (raising when none is present);
    ``device="cpu"`` builds the plain-path model the CPU tests use."""

    def __init__(self, config: BertConfig, device=None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.bert = BertModel(config, device)
        self.dropout = Dropout(config.hidden_dropout_prob)
        self.classifier = Linear(config.hidden_size, config.num_labels,
                                 device=device)

    @property
    def device(self) -> torch.device:
        return self.classifier.weight.device

    def init_weights(self, generator: torch.Generator):
        """Draw every weight anew from ``generator`` (N(0,
        initializer_range) matrices, zero biases, unit LayerNorms)."""
        return init_encoder_weights(self, self.config.initializer_range,
                                    generator)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids, position_ids,
                              attention_mask)
        return self.classifier(self.dropout(pooled))
