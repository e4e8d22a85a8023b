"""MobileNetV1 (counterpart of
``paddle_tpu/vision/models/mobilenetv1.py``): the same layers, names and
``state_dict`` keys, so ``convert.load_reference_state_dict`` carries
the reference's weights across; built on the CPU from torch's default
generator, then moved to the keyword-only ``device`` (default CUDA) and
``dtype``.
"""
from ...framework import resolve_device
from ...nn import (Layer, Conv2D, BatchNorm2D, ReLU, Linear, Sequential,
                   AdaptiveAvgPool2D)
from ...ops.manipulation import flatten

__all__ = ["MobileNetV1", "mobilenet_v1"]


class _DWSeparable(Sequential):
    def __init__(self, in_ch, out_ch, stride):
        super().__init__(
            Conv2D(in_ch, in_ch, 3, stride=stride, padding=1,
                   groups=in_ch, bias_attr=False),
            BatchNorm2D(in_ch), ReLU(),
            Conv2D(in_ch, out_ch, 1, bias_attr=False),
            BatchNorm2D(out_ch), ReLU(),
        )


class MobileNetV1(Layer):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True,
                 *, device=None, dtype=None):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool

        def c(ch):
            return max(8, int(ch * scale))

        cfg = [(32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
               (256, 256, 1), (256, 512, 2)] \
            + [(512, 512, 1)] * 5 + [(512, 1024, 2), (1024, 1024, 1)]
        layers = [Conv2D(3, c(32), 3, stride=2, padding=1, bias_attr=False),
                  BatchNorm2D(c(32)), ReLU()]
        for cin, cout, s in cfg:
            layers.append(_DWSeparable(c(cin), c(cout), s))
        self.features = Sequential(*layers)
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = Linear(c(1024), num_classes)
        self.to(resolve_device(device), dtype)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool(x)
        if self.num_classes > 0:
            x = self.fc(flatten(x, 1))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    if pretrained:
        raise RuntimeError("pretrained weights are not available offline")
    return MobileNetV1(scale=scale, **kwargs)
