"""SqueezeNet (counterpart of ``paddle_tpu/vision/models/squeezenet.py``):
the same layers, names and ``state_dict`` keys, so
``convert.load_reference_state_dict`` carries the reference's weights
across; built on the CPU from torch's default generator, then moved to
the keyword-only ``device`` (default CUDA) and ``dtype``.
"""
from ...framework import resolve_device
from ...nn import (Layer, Conv2D, ReLU, MaxPool2D, Dropout, Sequential,
                   AdaptiveAvgPool2D)
from ...ops.manipulation import concat, flatten

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


class Fire(Layer):
    def __init__(self, inplanes, squeeze, expand1x1, expand3x3):
        super().__init__()
        self.squeeze = Conv2D(inplanes, squeeze, 1)
        self.relu = ReLU()
        self.expand1x1 = Conv2D(squeeze, expand1x1, 1)
        self.expand3x3 = Conv2D(squeeze, expand3x3, 3, padding=1)

    def forward(self, x):
        x = self.relu(self.squeeze(x))
        return concat([self.relu(self.expand1x1(x)),
                       self.relu(self.expand3x3(x))], axis=1)


class SqueezeNet(Layer):
    def __init__(self, version="1.0", num_classes=1000, with_pool=True,
                 *, device=None, dtype=None):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        if version == "1.0":
            self.features = Sequential(
                Conv2D(3, 96, 7, stride=2), ReLU(),
                MaxPool2D(3, stride=2, ceil_mode=True),
                Fire(96, 16, 64, 64), Fire(128, 16, 64, 64),
                Fire(128, 32, 128, 128),
                MaxPool2D(3, stride=2, ceil_mode=True),
                Fire(256, 32, 128, 128), Fire(256, 48, 192, 192),
                Fire(384, 48, 192, 192), Fire(384, 64, 256, 256),
                MaxPool2D(3, stride=2, ceil_mode=True),
                Fire(512, 64, 256, 256),
            )
        elif version == "1.1":
            self.features = Sequential(
                Conv2D(3, 64, 3, stride=2), ReLU(),
                MaxPool2D(3, stride=2, ceil_mode=True),
                Fire(64, 16, 64, 64), Fire(128, 16, 64, 64),
                MaxPool2D(3, stride=2, ceil_mode=True),
                Fire(128, 32, 128, 128), Fire(256, 32, 128, 128),
                MaxPool2D(3, stride=2, ceil_mode=True),
                Fire(256, 48, 192, 192), Fire(384, 48, 192, 192),
                Fire(384, 64, 256, 256), Fire(512, 64, 256, 256),
            )
        else:
            raise ValueError(f"unsupported version {version}")
        if with_pool:
            self.pool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = Sequential(
                Dropout(0.5),
                Conv2D(512, num_classes, 1), ReLU(),
                AdaptiveAvgPool2D(1),
            )
        self.to(resolve_device(device), dtype)

    def forward(self, x):
        x = self.features(x)
        if self.num_classes > 0:
            x = flatten(self.classifier(x), 1)
        elif self.with_pool:
            x = self.pool(x)
        return x


def squeezenet1_0(pretrained=False, **kwargs):
    if pretrained:
        raise RuntimeError("pretrained weights are not available offline")
    return SqueezeNet("1.0", **kwargs)


def squeezenet1_1(pretrained=False, **kwargs):
    if pretrained:
        raise RuntimeError("pretrained weights are not available offline")
    return SqueezeNet("1.1", **kwargs)
