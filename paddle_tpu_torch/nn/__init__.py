"""Counterpart of ``paddle_tpu/nn`` (only what the Llama serving and
pretraining and the BERT/ERNIE fine-tuning paths use). ``Layer`` is the
base class of every layer and model of the port."""
from . import functional, initializer  # noqa: F401
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .initializer import ParamAttr
from .layer_base import Layer
from .layers_common import Dropout, Embedding, LayerList, LayerNorm, Linear
from .losses import CrossEntropyLoss
from .transformer import (MultiHeadAttention, TransformerEncoder,
                          TransformerEncoderLayer)

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "CrossEntropyLoss", "Dropout", "Embedding", "Layer", "LayerList",
           "LayerNorm", "Linear", "MultiHeadAttention", "ParamAttr",
           "TransformerEncoder", "TransformerEncoderLayer"]
