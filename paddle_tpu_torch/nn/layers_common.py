"""Layers of ``paddle_tpu/nn/layers_common.py`` over ``nn.Layer``:
``Linear``, ``LayerNorm``, ``Embedding``, ``Dropout`` and ``LayerList``
(what the BERT/ERNIE path uses), and ``Sequential``, ``Conv2D``, the
BatchNorms, ``ReLU``, the 2-D pools, ``Flatten``, ``Identity`` and
``Softmax`` (what the ResNet path uses), and ``ReLU6``, ``Hardswish``,
``Hardsigmoid`` and ``Swish`` (what the other vision models add).

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
``framework.random.seed``). ``Conv2D`` weights are [out, in / groups, kh,
kw] in both packages (never transposed), drawn Kaiming-uniform with the
bias U(+-1 / sqrt(fan_in)); a BatchNorm's running stats are the f32
buffers ``_mean`` and ``_variance``, the reference's names.

The activation, pool and ``Identity`` layers keep the reference's
generic signatures (``ReLU(*args, **kwargs)``, ``MaxPool2D(kernel_size,
stride=None, padding=0, **kwargs)``, ``AdaptiveAvgPool2D(output_size,
**kwargs)``): the extra arguments go to the functional op, or, for the
adaptive pools as there, nowhere.
"""
from __future__ import annotations

import collections
import math
import numbers

import torch
import torch.nn.functional as F
from torch import nn

from ..amp import cast_inputs
from . import functional as PF
from .initializer import (Constant, KaimingUniform, Normal, Uniform,
                          XavierUniform, create_parameter)
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


class Sequential(Layer):
    """Sublayers called in order: ``Sequential(a, b)`` registers them as
    "0", "1", ...; ``Sequential(("name", layer), ...)`` or an
    ``OrderedDict`` by name. Indexing takes a position, a name or a slice
    (a new ``Sequential`` over the same layers)."""

    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0],
                                           collections.OrderedDict):
            for name, layer in layers[0].items():
                self.add_sublayer(name, layer)
        else:
            for i, layer in enumerate(layers):
                if isinstance(layer, tuple):
                    self.add_sublayer(layer[0], layer[1])
                else:
                    self.add_sublayer(str(i), layer)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._modules.values())[idx])
        if isinstance(idx, str):
            return self._modules[idx]
        return list(self._modules.values())[idx]

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())

    def forward(self, x):
        for layer in self._modules.values():
            x = layer(x)
        return x


class _ConvNd(Layer):
    """A convolution's parameters: ``weight`` [out, in / groups, *k]
    (Kaiming-uniform over fan_in = in / groups * prod(k), negative slope
    sqrt(5)) and ``bias`` [out] (U(+-1 / sqrt(fan_in)); ``bias_attr=False``:
    none). ``padding_mode`` is taken and, as in the reference, not read.
    Only the 2-D forward convolution is ported (``transpose`` raises)."""

    def __init__(self, in_channels, out_channels, kernel_size, stride,
                 padding, dilation, groups, padding_mode, weight_attr,
                 bias_attr, data_format, ndim, transpose=False,
                 output_padding=0, *, device=None, dtype=None):
        super().__init__()
        if transpose:
            raise NotImplementedError("transposed convolutions are not "
                                      "ported")
        if in_channels % groups != 0:
            raise ValueError("in_channels must be divisible by groups")
        self._in_channels = in_channels
        self._out_channels = out_channels
        ks = kernel_size if isinstance(kernel_size, (list, tuple)) \
            else (kernel_size,) * ndim
        self._kernel_size = tuple(int(k) for k in ks)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._groups = groups
        self._data_format = data_format
        fan_in = (in_channels // groups) * math.prod(self._kernel_size)
        kw = dict(dtype=dtype, device=device)
        self.register_parameter("weight", create_parameter(
            [out_channels, in_channels // groups, *self._kernel_size],
            weight_attr, default_initializer=KaimingUniform(
                fan_in=fan_in, negative_slope=math.sqrt(5.0),
                nonlinearity="leaky_relu"), **kw))
        bound = 1.0 / math.sqrt(fan_in)
        self.register_parameter("bias", create_parameter(
            [out_channels], bias_attr, is_bias=True,
            default_initializer=Uniform(-bound, bound), **kw))

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, "
                f"kernel_size={list(self._kernel_size)}, "
                f"stride={self._stride}, padding={self._padding}, "
                f"groups={self._groups}, data_format={self._data_format}")


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=None, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format, 2,
                         device=device, dtype=dtype)

    def forward(self, x):
        return PF.conv2d(x, self.weight, self.bias, self._stride,
                         self._padding, self._dilation, self._groups,
                         self._data_format)


class _BatchNormBase(Layer):
    """BatchNorm over ``num_features`` channels: ``weight`` (one) and
    ``bias`` (zero), each left out by ``False``, and the f32 running
    stats ``_mean`` (zero) and ``_variance`` (one), persistable buffers
    that a training forward updates in place (``nn.functional.
    batch_norm``)."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-05,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=None,
                 dtype=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        kw = dict(dtype=dtype, device=device)
        self.register_parameter("weight", create_parameter(
            [num_features], weight_attr, default_initializer=Constant(1.0),
            **kw))
        self.register_parameter("bias", create_parameter(
            [num_features], bias_attr, is_bias=True, **kw))
        self.register_buffer("_mean", torch.zeros(
            num_features, dtype=torch.float32, device=device))
        self.register_buffer("_variance", torch.ones(
            num_features, dtype=torch.float32, device=device))

    def forward(self, x):
        return PF.batch_norm(x, self._mean, self._variance, self.weight,
                             self.bias, training=self.training,
                             momentum=self._momentum, epsilon=self._epsilon,
                             data_format=self._data_format,
                             use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return (f"num_features={self._num_features}, "
                f"momentum={self._momentum}, epsilon={self._epsilon}")


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm(_BatchNormBase):
    """The legacy ``paddle.nn.BatchNorm``: ``act`` (a name in
    ``nn.functional``) applied after the norm; the other legacy arguments
    are taken and, as in the reference, not read."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-05,
                 param_attr=None, bias_attr=None, dtype="float32",
                 data_layout="NCHW", in_place=False, moving_mean_name=None,
                 moving_variance_name=None,
                 do_model_average_for_mean_and_var=True,
                 use_global_stats=False, trainable_statistics=False, *,
                 device=None):
        super().__init__(num_channels, momentum, epsilon, param_attr,
                         bias_attr, data_layout, use_global_stats,
                         device=device, dtype=dtype)
        self._act = act

    def forward(self, x):
        out = super().forward(x)
        if self._act:
            out = getattr(PF, self._act)(out)
        return out


class ReLU(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()
        self._args = args
        self._kwargs = {k: v for k, v in kwargs.items() if k != "name"}

    def forward(self, x):
        return PF.relu(x, *self._args, **self._kwargs)


class _Activation(Layer):
    """An activation layer of the reference's generic signature
    (``*args, **kwargs``, ``name`` dropped): the arguments go to the
    functional op ``_fn``."""
    _fn = None

    def __init__(self, *args, **kwargs):
        super().__init__()
        self._args = args
        self._kwargs = {k: v for k, v in kwargs.items() if k != "name"}

    def forward(self, x):
        return type(self)._fn(x, *self._args, **self._kwargs)


class ReLU6(_Activation):
    _fn = staticmethod(PF.relu6)


class Hardsigmoid(_Activation):
    _fn = staticmethod(PF.hardsigmoid)


class Hardswish(_Activation):
    _fn = staticmethod(PF.hardswish)


class Swish(_Activation):
    _fn = staticmethod(PF.swish)


class Softmax(Layer):
    def __init__(self, axis=-1, name=None):
        super().__init__()
        self.axis = axis

    def forward(self, x):
        return PF.softmax(x, axis=self.axis)


class _Pool2D(Layer):
    _fn = None

    def __init__(self, kernel_size, stride=None, padding=0, **kwargs):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.kwargs = {k: v for k, v in kwargs.items() if k != "name"}

    def forward(self, x):
        return type(self)._fn(x, self.kernel_size, self.stride,
                              self.padding, **self.kwargs)

    def extra_repr(self):
        return (f"kernel_size={self.kernel_size}, stride={self.stride}, "
                f"padding={self.padding}")


class MaxPool2D(_Pool2D):
    _fn = staticmethod(PF.max_pool2d)


class AvgPool2D(_Pool2D):
    _fn = staticmethod(PF.avg_pool2d)


class _AdaptivePool2D(Layer):
    _fn = None

    def __init__(self, output_size, **kwargs):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return type(self)._fn(x, self.output_size)

    def extra_repr(self):
        return f"output_size={self.output_size}"


class AdaptiveAvgPool2D(_AdaptivePool2D):
    _fn = staticmethod(PF.adaptive_avg_pool2d)


class AdaptiveMaxPool2D(_AdaptivePool2D):
    _fn = staticmethod(PF.adaptive_max_pool2d)


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis = start_axis
        self.stop_axis = stop_axis

    def forward(self, x):
        return PF.flatten(x, self.start_axis, self.stop_axis)


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x
