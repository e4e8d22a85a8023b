"""``paddle.nn.initializer`` and ``ParamAttr`` (counterpart of
``paddle_tpu/nn/initializer.py``).

An initializer is called as the reference's is, ``init(shape, dtype)``,
and returns a tensor of ``shape`` in the reference's layout; besides, it
takes ``generator`` (a ``torch.Generator``; ``None`` is torch's default
generator of the device) and ``device``. Draws come from that generator
only: the one state kept here is what ``set_global_initializer`` holds.
Torch and jax give other numbers from one seed, so an initializer matches
the reference's in distribution (``Assign``, ``Dirac``, ``Bilinear`` and
``Constant``: in value), as the tests hold.

``create_parameter`` is the reference's ``Layer.create_parameter`` for
the port's layers: ``ParamAttr._to_attr`` of the attribute (``False``:
no parameter), the initializer chosen in the reference's order (the
attribute's, the global one, the layer's default, then Xavier-uniform
for a weight or zero for a bias), ``trainable`` as ``requires_grad``,
and ``need_clip``, ``regularizer`` and ``optimize_attr`` set on the
parameter, where the clips, ``optimizer/fused.py`` and the optimizers
read the first two (the reference reads ``optimize_attr`` nowhere; it
is kept for parity). A draw whose elements are independent of their
place (``Constant``, ``Normal``, ``TruncatedNormal``, ``Uniform``, the
Xavier and Kaiming pairs) is written in place into the stored tensor,
with the fans of the reference's shape; the others are computed in the
reference's layout and transposed where the port stores the transpose
(``Linear``'s [out, in] weight).
"""
from __future__ import annotations

import copy
import math

import numpy as np
import torch
from torch import nn

__all__ = ["Assign", "Bilinear", "Constant", "Dirac", "Initializer",
           "KaimingNormal", "KaimingUniform", "Normal", "Orthogonal",
           "ParamAttr", "TruncatedNormal", "Uniform", "XavierNormal",
           "XavierUniform", "calculate_gain", "constant", "normal",
           "set_global_initializer", "uniform"]


def _torch_dtype(dtype):
    """A torch dtype from a torch dtype, a name ("float32") or None (the
    default dtype)."""
    if dtype is None:
        return torch.get_default_dtype()
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype).rsplit(".", 1)[-1])


def _fans(shape):
    """(fan_in, fan_out) of a weight of the reference's ``shape``:
    [in, out] for a matrix, [out, in/groups, *k] for a conv kernel."""
    shape = tuple(shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    rf = math.prod(shape[2:])
    return shape[1] * rf, shape[0] * rf


class Initializer:
    """Base class. ``init(shape, dtype, generator=None, device=None)``
    returns a new tensor; a subclass whose elements are drawn
    independently of their place (``_iid``) implements ``fill_``, the
    others ``_value``."""

    _iid = True

    def __call__(self, shape, dtype="float32", generator=None, device=None):
        shape = tuple(int(s) for s in shape)
        if not self._iid:
            return self._value(shape, _torch_dtype(dtype), generator, device)
        out = torch.empty(shape, dtype=_torch_dtype(dtype), device=device)
        with torch.no_grad():
            return self.fill_(out, _fans(shape), generator)

    def fill_(self, tensor, fans, generator=None):
        """Draws into ``tensor`` in place, ``fans`` the (fan_in, fan_out)
        of the reference's shape; returns ``tensor``."""
        raise NotImplementedError

    def _value(self, shape, dtype, generator, device):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def fill_(self, tensor, fans, generator=None):
        return tensor.fill_(self.value)


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0, name=None):
        self.mean, self.std = mean, std

    def fill_(self, tensor, fans, generator=None):
        return tensor.normal_(self.mean, self.std, generator=generator)


class TruncatedNormal(Initializer):
    """N(mean, std) cut to [mean + a std, mean + b std] (``a``, ``b`` in
    standard units, as in the reference)."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0, name=None):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def fill_(self, tensor, fans, generator=None):
        nn.init.trunc_normal_(tensor, 0.0, 1.0, self.a, self.b,
                              generator=generator)
        return tensor.mul_(self.std).add_(self.mean)


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0, name=None):
        self.low, self.high = low, high

    def fill_(self, tensor, fans, generator=None):
        return tensor.uniform_(self.low, self.high, generator=generator)


class _FanInit(Initializer):
    def __init__(self, fan_in=None, fan_out=None):
        self.fan_in, self.fan_out = fan_in, fan_out

    def _fan(self, fans):
        fi = self.fan_in if self.fan_in is not None else fans[0]
        fo = self.fan_out if self.fan_out is not None else fans[1]
        return fi, fo


class XavierNormal(_FanInit):
    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        super().__init__(fan_in, fan_out)
        self.gain = gain

    def fill_(self, tensor, fans, generator=None):
        fi, fo = self._fan(fans)
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return tensor.normal_(0.0, std, generator=generator)


class XavierUniform(_FanInit):
    """U(-l, l), l = gain sqrt(6 / (fan_in + fan_out)), computed as
    ``torch.nn.init.xavier_uniform_`` computes it (sqrt(3) times the
    normal's std), so the port's default linear draws keep their bits."""

    def __init__(self, fan_in=None, fan_out=None, gain=1.0, name=None):
        super().__init__(fan_in, fan_out)
        self.gain = gain

    def fill_(self, tensor, fans, generator=None):
        fi, fo = self._fan(fans)
        limit = math.sqrt(3.0) * self.gain * math.sqrt(2.0 / float(fi + fo))
        return tensor.uniform_(-limit, limit, generator=generator)


def _kaiming_gain(negative_slope, nonlinearity):
    if nonlinearity in ("relu", "leaky_relu"):
        return math.sqrt(2.0 / (1 + negative_slope ** 2))
    return 1.0


class KaimingNormal(_FanInit):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu",
                 name=None):
        super().__init__(fan_in)
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def fill_(self, tensor, fans, generator=None):
        fi, _ = self._fan(fans)
        std = _kaiming_gain(self.negative_slope, self.nonlinearity) \
            / math.sqrt(fi)
        return tensor.normal_(0.0, std, generator=generator)


class KaimingUniform(_FanInit):
    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu",
                 name=None):
        super().__init__(fan_in)
        self.negative_slope = negative_slope
        self.nonlinearity = nonlinearity

    def fill_(self, tensor, fans, generator=None):
        fi, _ = self._fan(fans)
        limit = _kaiming_gain(self.negative_slope, self.nonlinearity) \
            * math.sqrt(3.0 / fi)
        return tensor.uniform_(-limit, limit, generator=generator)


class Assign(Initializer):
    """The given value (a tensor, an array or a list), reshaped to
    ``shape``."""

    _iid = False

    def __init__(self, value, name=None):
        self.value = value

    def _value(self, shape, dtype, generator, device):
        v = self.value
        if not isinstance(v, torch.Tensor):
            v = torch.as_tensor(np.asarray(v))
        return v.to(device=device, dtype=dtype).reshape(shape).clone()


class Dirac(Initializer):
    """Identity conv kernels: 1 at the centre tap of (g * out/groups + i,
    i) for i < min(out/groups, in), 0 elsewhere."""

    _iid = False

    def __init__(self, groups=1, name=None):
        self.groups = groups

    def _value(self, shape, dtype, generator, device):
        out = np.zeros(shape, np.float32)
        oc, ic = shape[0], shape[1]
        per = oc // self.groups
        centers = tuple(s // 2 for s in shape[2:])
        for g in range(self.groups):
            for i in range(min(per, ic)):
                out[(g * per + i, i) + centers] = 1.0
        return torch.as_tensor(out, dtype=dtype, device=device)


class Orthogonal(Initializer):
    """``gain`` times the Q of a QR of a standard-normal draw (signs
    fixed by R's diagonal), [rows, prod(rest)] reshaped to ``shape``."""

    _iid = False

    def __init__(self, gain=1.0, name=None):
        self.gain = gain

    def _value(self, shape, dtype, generator, device):
        rows, cols = shape[0], math.prod(shape[1:])
        flat = torch.empty(max(rows, cols), min(rows, cols),
                           device=device).normal_(generator=generator)
        q, r = torch.linalg.qr(flat)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.T
        return (self.gain * q[:rows, :cols]).reshape(shape).to(dtype)


class Bilinear(Initializer):
    """Bilinear-upsampling kernels for transposed convs, [out, in, kh,
    kw]."""

    _iid = False

    def _value(self, shape, dtype, generator, device):
        if len(shape) != 4:
            raise ValueError("Bilinear initializer expects 4-D weights")
        c_out, c_in, kh, kw = shape
        f_h, f_w = (kh + 1) // 2, (kw + 1) // 2
        ch = (2 * f_h - 1 - f_h % 2) / (2.0 * f_h)
        cw = (2 * f_w - 1 - f_w % 2) / (2.0 * f_w)
        og = np.ogrid[:kh, :kw]
        filt = ((1 - np.abs(og[0] / f_h - ch))
                * (1 - np.abs(og[1] / f_w - cw))).astype(np.float32)
        w = np.broadcast_to(filt, shape)
        return torch.as_tensor(np.ascontiguousarray(w), dtype=dtype,
                               device=device)


def calculate_gain(nonlinearity, param=None):
    if nonlinearity == "tanh":
        return 5.0 / 3
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        a = param if param is not None else 0.01
        return math.sqrt(2.0 / (1 + a ** 2))
    if nonlinearity == "selu":
        return 3.0 / 4
    return 1.0


# snake_case aliases, as paddle.nn.initializer has them
constant = Constant
normal = Normal
uniform = Uniform

_GLOBAL_INIT = {"weight": None, "bias": None}


def set_global_initializer(weight_init, bias_init=None):
    """The initializers ``create_parameter`` uses where the attribute
    names none: they take the place of the layers' defaults, never of an
    attribute's own. ``None, None`` resets them."""
    _GLOBAL_INIT["weight"] = weight_init
    _GLOBAL_INIT["bias"] = bias_init


class ParamAttr:
    """``paddle.ParamAttr``: a parameter's name, initializer, learning-rate
    factor, regularizer, trainability and ``need_clip``
    (``do_model_average`` is kept, as the reference keeps it)."""

    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    @staticmethod
    def _to_attr(attr):
        if attr is None:
            return ParamAttr()
        if attr is False:
            return False
        if isinstance(attr, ParamAttr):
            return attr
        if isinstance(attr, str):
            return ParamAttr(name=attr)
        if isinstance(attr, Initializer):
            return ParamAttr(initializer=attr)
        raise TypeError(f"invalid ParamAttr {attr!r}")


class Parameter(nn.Parameter):
    """``torch.nn.Parameter`` with the reference parameter's attributes
    (``need_clip``, ``regularizer``, ``optimize_attr``, ``name``), which a
    deep copy keeps (``TransformerEncoder`` copies its layer; torch's
    own ``Parameter.__deepcopy__`` drops them)."""

    name = None  # the attribute's name (torch's own ``name`` is read-only)

    def __deepcopy__(self, memo):
        if id(self) in memo:
            return memo[id(self)]
        out = super().__deepcopy__(memo)
        out.__dict__.update(copy.deepcopy(self.__dict__, memo))
        return out


def create_parameter(shape, attr=None, dtype=None, is_bias=False,
                     default_initializer=None, device=None, generator=None,
                     transpose=False):
    """A parameter of the reference's ``shape`` drawn as the reference's
    ``Layer.create_parameter`` draws it (see the module note), or None
    for ``attr=False``. ``transpose`` stores a matrix as [shape[1],
    shape[0]] (``Linear``)."""
    attr = ParamAttr._to_attr(attr)
    if attr is False:
        return None
    shape = tuple(int(s) for s in shape)
    init = attr.initializer or _GLOBAL_INIT["bias" if is_bias else "weight"] \
        or default_initializer or (Constant(0.0) if is_bias
                                   else XavierUniform())
    dt = _torch_dtype(dtype)
    with torch.no_grad():
        if isinstance(init, Initializer) and init._iid:
            value = init.fill_(torch.empty(shape[::-1] if transpose
                                           else shape, dtype=dt,
                                           device=device),
                               _fans(shape), generator)
        else:
            if isinstance(init, Initializer):
                v = init(shape, dt, generator=generator, device=device)
            elif callable(init):
                v = torch.as_tensor(np.asarray(init(shape, dt)))
            else:
                raise TypeError(f"not an initializer: {init!r}")
            value = (v.T if transpose else v).to(device=device, dtype=dt)
            value = value.contiguous()
    p = Parameter(value, requires_grad=bool(attr.trainable))
    p.need_clip = attr.need_clip
    p.regularizer = attr.regularizer
    p.optimize_attr = {"learning_rate": attr.learning_rate}
    if attr.name is not None:
        p.name = attr.name
    return p
