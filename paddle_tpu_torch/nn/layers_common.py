"""Layers of ``paddle_tpu/nn/layers_common.py`` over ``nn.Layer``:
``Linear``, ``LayerNorm``, ``Embedding``, ``Dropout`` and ``LayerList``
(what the BERT/ERNIE path uses).

Each takes the reference's parameters in the reference's order, with
``weight_attr`` / ``bias_attr`` (a ``ParamAttr``, an initializer, a
name, or ``False`` for no parameter) read as the reference reads them
(``nn.initializer.create_parameter``); the port's own ``device`` and
``dtype`` are keyword-only, after them. Parameter names are the
reference's (``weight``, ``bias``), so ``convert.load_reference_state_dict``
moves weights across by name. ``Linear`` is a ``torch.nn.Linear``
(through ``AmpLinear``, whose forward casts its inputs as ``amp`` says
for "linear"): it stores its weight as [out, in] where Paddle stores
[in, out], and ``convert`` transposes it. ``Embedding`` is a
``torch.nn.Embedding`` too and ``LayerList`` a ``torch.nn.ModuleList``,
so code that finds layers by torch class (``init_weights``, ``convert``,
the weight-only quantizer) finds these. Default initialisation follows
the reference: Xavier-uniform linear weights and zero biases, N(0, 1)
embeddings (zero at ``padding_idx``), LayerNorm weight one and bias
zero, drawn from torch's default generators (see
``framework.random.seed``).
"""
from __future__ import annotations

import numbers

import torch
import torch.nn.functional as F
from torch import nn

from ..amp import cast_inputs
from . import functional as PF
from .initializer import Constant, Normal, XavierUniform, create_parameter
from .layer_base import Layer


class AmpLinear(nn.Linear, Layer):
    """``torch.nn.Linear`` (same parameters, same state dict, torch's
    draw) as a ``Layer``, whose input, weight and bias are cast as ``amp``
    says for the reference's "linear" op."""

    def forward(self, x):
        return F.linear(*cast_inputs("linear", x, self.weight, self.bias))


class Linear(AmpLinear):
    """``y = x W + b``; ``bias_attr=False`` leaves out the bias."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=None):
        Layer.__init__(self)
        self.in_features, self.out_features = in_features, out_features
        kw = dict(dtype=dtype, device=device)
        self.register_parameter("weight", create_parameter(
            [in_features, out_features], weight_attr,
            default_initializer=XavierUniform(), transpose=True, **kw))
        self.register_parameter("bias", create_parameter(
            [out_features], bias_attr, is_bias=True, **kw))


class LayerNorm(Layer):
    """LayerNorm over the trailing ``normalized_shape`` axes through
    ``nn.functional.layer_norm`` (the LayerNorm kernel); ``weight_attr``
    / ``bias_attr`` ``False`` leave out the scale / shift."""

    def __init__(self, normalized_shape, epsilon=1e-05, weight_attr=None,
                 bias_attr=None, name=None, *, device=None, dtype=None):
        super().__init__()
        if isinstance(normalized_shape, numbers.Integral):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        kw = dict(dtype=dtype, device=device)
        self.register_parameter("weight", create_parameter(
            self._normalized_shape, weight_attr,
            default_initializer=Constant(1.0), **kw))
        self.register_parameter("bias", create_parameter(
            self._normalized_shape, bias_attr, is_bias=True, **kw))

    def forward(self, x):
        return PF.layer_norm(x, self._normalized_shape, self.weight,
                             self.bias, self._epsilon)

    def extra_repr(self):
        return (f"normalized_shape={self._normalized_shape}, "
                f"epsilon={self._epsilon}")


class Embedding(nn.Embedding, Layer):
    """Lookup table [num_embeddings, embedding_dim], drawn N(0, 1) unless
    ``weight_attr`` says otherwise (the models pass ``Normal(0, std)``),
    zero at ``padding_idx``. ``sparse`` is taken and, as in the
    reference, changes nothing: gradients are dense."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *, device=None,
                 dtype=None):
        Layer.__init__(self)
        # torch.nn.Embedding's attributes (its forward is not used)
        self.num_embeddings, self.embedding_dim = num_embeddings, \
            embedding_dim
        self.padding_idx = padding_idx
        self.max_norm, self.norm_type = None, 2.0
        self.scale_grad_by_freq, self.sparse = False, sparse
        self._padding_idx = padding_idx
        self._sparse = sparse
        self.weight = create_parameter(
            [num_embeddings, embedding_dim], weight_attr, dtype=dtype,
            device=device, default_initializer=Normal(0.0, 1.0))
        if padding_idx is not None:
            with torch.no_grad():
                self.weight[padding_idx] = 0.0

    def forward(self, x):
        return PF.embedding(x, self.weight, self._padding_idx)

    def extra_repr(self):
        return f"{self.weight.shape[0]}, {self.weight.shape[1]}"


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p = p
        self.axis = axis
        self.mode = mode

    def forward(self, x):
        return PF.dropout(x, self.p, axis=self.axis, training=self.training,
                          mode=self.mode)


class LayerList(nn.ModuleList, Layer):
    """The reference's ``LayerList``: ``sublayers`` registered as "0",
    "1", ... (so ``layers.3.linear1.weight`` names match); ``len``,
    indexing, iteration and ``append`` are ``torch.nn.ModuleList``'s."""

    def __init__(self, sublayers=None):
        super().__init__(sublayers)
