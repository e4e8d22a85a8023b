"""Counterpart of ``paddle_tpu/nn`` (only what the Llama serving and
pretraining and the BERT/ERNIE fine-tuning paths use)."""
from . import functional  # noqa: F401
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .layers_common import Dropout, Embedding, LayerList, LayerNorm, Linear
from .losses import CrossEntropyLoss
from .transformer import (MultiHeadAttention, TransformerEncoder,
                          TransformerEncoderLayer)

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "CrossEntropyLoss", "Dropout", "Embedding", "LayerList",
           "LayerNorm", "Linear", "MultiHeadAttention", "TransformerEncoder",
           "TransformerEncoderLayer"]
