"""MobileNetV3 (counterpart of
``paddle_tpu/vision/models/mobilenetv3.py``): the same layers, names and
``state_dict`` keys, so ``convert.load_reference_state_dict`` carries
the reference's weights across; built on the CPU from torch's default
generator, then moved to the keyword-only ``device`` (default CUDA) and
``dtype``.
"""
from ...framework import resolve_device
from ...nn import (Layer, Conv2D, BatchNorm2D, ReLU, Hardswish, Hardsigmoid,
                   Linear, Dropout, Sequential, AdaptiveAvgPool2D)
from ...ops.manipulation import flatten
from .mobilenetv2 import _make_divisible as _divisible

__all__ = ["MobileNetV3Small", "MobileNetV3Large",
           "mobilenet_v3_small", "mobilenet_v3_large"]


class SqueezeExcitation(Layer):
    def __init__(self, ch, squeeze_ch):
        super().__init__()
        self.avgpool = AdaptiveAvgPool2D(1)
        self.fc1 = Conv2D(ch, squeeze_ch, 1)
        self.relu = ReLU()
        self.fc2 = Conv2D(squeeze_ch, ch, 1)
        self.hsig = Hardsigmoid()

    def forward(self, x):
        s = self.hsig(self.fc2(self.relu(self.fc1(self.avgpool(x)))))
        return x * s


class _ConvBNAct(Sequential):
    def __init__(self, cin, cout, k, stride=1, groups=1, act=None):
        pad = (k - 1) // 2
        mods = [Conv2D(cin, cout, k, stride=stride, padding=pad,
                       groups=groups, bias_attr=False),
                BatchNorm2D(cout)]
        if act == "relu":
            mods.append(ReLU())
        elif act == "hardswish":
            mods.append(Hardswish())
        super().__init__(*mods)


class InvertedResidual(Layer):
    def __init__(self, cin, exp, cout, k, stride, use_se, act):
        super().__init__()
        self.use_res = stride == 1 and cin == cout
        mods = []
        if exp != cin:
            mods.append(_ConvBNAct(cin, exp, 1, act=act))
        mods.append(_ConvBNAct(exp, exp, k, stride=stride, groups=exp,
                               act=act))
        if use_se:
            mods.append(SqueezeExcitation(exp, _divisible(exp // 4)))
        mods.append(_ConvBNAct(exp, cout, 1, act=None))
        self.block = Sequential(*mods)

    def forward(self, x):
        out = self.block(x)
        return x + out if self.use_res else out


_SMALL = [
    # k, exp, out, se, act, stride
    (3, 16, 16, True, "relu", 2), (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1), (5, 96, 40, True, "hardswish", 2),
    (5, 240, 40, True, "hardswish", 1), (5, 240, 40, True, "hardswish", 1),
    (5, 120, 48, True, "hardswish", 1), (5, 144, 48, True, "hardswish", 1),
    (5, 288, 96, True, "hardswish", 2), (5, 576, 96, True, "hardswish", 1),
    (5, 576, 96, True, "hardswish", 1),
]
_LARGE = [
    (3, 16, 16, False, "relu", 1), (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1), (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1), (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hardswish", 2), (3, 200, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1), (3, 184, 80, False, "hardswish", 1),
    (3, 480, 112, True, "hardswish", 1), (3, 672, 112, True, "hardswish", 1),
    (5, 672, 160, True, "hardswish", 2), (5, 960, 160, True, "hardswish", 1),
    (5, 960, 160, True, "hardswish", 1),
]


class _MobileNetV3(Layer):
    def __init__(self, cfg, last_exp, last_ch, scale=1.0, num_classes=1000,
                 with_pool=True,
                 *, device=None, dtype=None):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool

        def c(ch):
            return _divisible(ch * scale)

        layers = [_ConvBNAct(3, c(16), 3, stride=2, act="hardswish")]
        cin = c(16)
        for k, exp, out, se, act, stride in cfg:
            layers.append(InvertedResidual(cin, c(exp), c(out), k, stride,
                                           se, act))
            cin = c(out)
        layers.append(_ConvBNAct(cin, c(last_exp), 1, act="hardswish"))
        self.features = Sequential(*layers)
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = Sequential(
                Linear(c(last_exp), last_ch), Hardswish(), Dropout(0.2),
                Linear(last_ch, num_classes))
        self.to(resolve_device(device), dtype)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.classifier(flatten(x, 1))
        return x


class MobileNetV3Small(_MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 *, device=None, dtype=None):
        super().__init__(_SMALL, 576, 1024, scale, num_classes, with_pool,
                         device=device, dtype=dtype)


class MobileNetV3Large(_MobileNetV3):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 *, device=None, dtype=None):
        super().__init__(_LARGE, 960, 1280, scale, num_classes, with_pool,
                         device=device, dtype=dtype)


def mobilenet_v3_small(pretrained=False, scale=1.0, **kwargs):
    if pretrained:
        raise RuntimeError("pretrained weights are not available offline")
    return MobileNetV3Small(scale=scale, **kwargs)


def mobilenet_v3_large(pretrained=False, scale=1.0, **kwargs):
    if pretrained:
        raise RuntimeError("pretrained weights are not available offline")
    return MobileNetV3Large(scale=scale, **kwargs)
