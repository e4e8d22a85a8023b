"""Counterpart of ``paddle_tpu/nn`` (only what the Llama serving and
pretraining, the BERT/ERNIE fine-tuning and the ResNet training paths
use). ``Layer`` is the base class of every layer and model of the
port."""
from . import functional, initializer  # noqa: F401
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .initializer import ParamAttr
from .layer_base import Layer
from .layers_common import (AdaptiveAvgPool2D, AdaptiveMaxPool2D, AvgPool2D,
                            BatchNorm, BatchNorm1D, BatchNorm2D, Conv2D,
                            Dropout, Embedding, Flatten, Hardsigmoid,
                            Hardswish, Identity, LayerList, LayerNorm,
                            Linear, MaxPool2D, ReLU, ReLU6, Sequential,
                            Softmax, Swish)
from .losses import CrossEntropyLoss, NLLLoss
from .transformer import (MultiHeadAttention, TransformerEncoder,
                          TransformerEncoderLayer)

__all__ = ["AdaptiveAvgPool2D", "AdaptiveMaxPool2D", "AvgPool2D",
           "BatchNorm", "BatchNorm1D", "BatchNorm2D", "ClipGradByGlobalNorm",
           "ClipGradByNorm", "ClipGradByValue", "Conv2D", "CrossEntropyLoss",
           "Dropout", "Embedding", "Flatten", "Hardsigmoid", "Hardswish",
           "Identity", "Layer",
           "LayerList", "LayerNorm", "Linear", "MaxPool2D",
           "MultiHeadAttention", "NLLLoss", "ParamAttr", "ReLU", "ReLU6",
           "Sequential", "Softmax", "Swish", "TransformerEncoder",
           "TransformerEncoderLayer"]
