"""ERNIE for sequence classification (counterpart of
``paddle_tpu/models/ernie.py`` ``ErnieConfig``, ``ErnieEmbeddings``,
``ErnieModel`` and ``ErnieForSequenceClassification``): BERT's encoder
with task-type embeddings, a bare ``Linear`` pooler and a boolean
[B, 1, 1, S] key mask made from a 1/0 ``attention_mask``.

The reference's quirks are kept: the encoder layers use LayerNorm eps
1e-5 (``ErnieModel`` passes no ``layer_norm_eps``), only the embedding
norm takes the config's 1e-12, and attention dropout equals
``hidden_dropout_prob``. The class count is the classifier's
``num_classes`` argument; ``ErnieConfig`` has no ``num_labels``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..framework import resolve_device
from ..nn import functional as PF
from ..nn.layers_common import Dropout, Embedding, LayerNorm, Linear
from ..nn.transformer import TransformerEncoder, TransformerEncoderLayer
from .bert import init_encoder_weights


@dataclass
class ErnieConfig:
    vocab_size: int = 40000
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_dropout_prob: float = 0.1
    max_position_embeddings: int = 2048
    type_vocab_size: int = 4
    task_type_vocab_size: int = 3
    use_task_id: bool = True
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12

    @staticmethod
    def tiny(**kw):
        base = dict(vocab_size=256, hidden_size=64, num_hidden_layers=2,
                    num_attention_heads=4, intermediate_size=128,
                    max_position_embeddings=128)
        base.update(kw)
        return ErnieConfig(**base)


class ErnieEmbeddings(nn.Module):
    def __init__(self, config: ErnieConfig, device=None):
        super().__init__()
        std = config.initializer_range
        h = config.hidden_size
        self.word_embeddings = Embedding(config.vocab_size, h, std=std,
                                         device=device)
        self.position_embeddings = Embedding(config.max_position_embeddings,
                                             h, std=std, device=device)
        self.token_type_embeddings = Embedding(config.type_vocab_size, h,
                                               std=std, device=device)
        self.use_task_id = config.use_task_id
        if config.use_task_id:
            self.task_type_embeddings = Embedding(
                config.task_type_vocab_size, h, std=std, device=device)
        self.layer_norm = LayerNorm(h, config.layer_norm_eps, device=device)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                task_type_ids=None):
        s = input_ids.shape[1]
        dev = input_ids.device
        if position_ids is None:
            position_ids = torch.arange(s, device=dev)
        emb = self.word_embeddings(input_ids) \
            + self.position_embeddings(position_ids)
        if token_type_ids is None:
            token_type_ids = torch.zeros(s, dtype=torch.int64, device=dev)
        emb = emb + self.token_type_embeddings(token_type_ids)
        if self.use_task_id:
            if task_type_ids is None:
                task_type_ids = torch.zeros(s, dtype=torch.int64, device=dev)
            emb = emb + self.task_type_embeddings(task_type_ids)
        return self.dropout(self.layer_norm(emb))


class ErnieModel(nn.Module):
    def __init__(self, config: ErnieConfig, device=None):
        super().__init__()
        self.config = config
        self.embeddings = ErnieEmbeddings(config, device)
        layer = TransformerEncoderLayer(
            config.hidden_size, config.num_attention_heads,
            config.intermediate_size, dropout=config.hidden_dropout_prob,
            activation="gelu", device=device)
        self.encoder = TransformerEncoder(layer, config.num_hidden_layers)
        self.pooler = Linear(config.hidden_size, config.hidden_size,
                             device=device)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, task_type_ids=None):
        h = self.embeddings(input_ids, token_type_ids, position_ids,
                            task_type_ids)
        if attention_mask is not None:
            attention_mask = attention_mask.reshape(
                attention_mask.shape[0], 1, 1, attention_mask.shape[1])
            if attention_mask.dtype != torch.bool:
                attention_mask = attention_mask.bool()
        h = self.encoder(h, src_mask=attention_mask)
        return h, PF.tanh(self.pooler(h[:, 0]))


class ErnieForSequenceClassification(nn.Module):
    """ERNIE with a dropout and a ``num_classes``-way linear classifier.
    ``device`` as for ``BertForSequenceClassification``."""

    def __init__(self, config: ErnieConfig, num_classes=2, device=None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.ernie = ErnieModel(config, device)
        self.dropout = Dropout(config.hidden_dropout_prob)
        self.classifier = Linear(config.hidden_size, num_classes,
                                 device=device)

    @property
    def device(self) -> torch.device:
        return self.classifier.weight.device

    def init_weights(self, generator: torch.Generator):
        """Draw every weight anew from ``generator``, as
        ``BertForSequenceClassification.init_weights``."""
        return init_encoder_weights(self, self.config.initializer_range,
                                    generator)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, task_type_ids=None):
        _, pooled = self.ernie(input_ids, token_type_ids, position_ids,
                               attention_mask, task_type_ids)
        return self.classifier(self.dropout(pooled))
