"""GoogLeNet (counterpart of ``paddle_tpu/vision/models/googlenet.py``):
the same layers, names and ``state_dict`` keys, so
``convert.load_reference_state_dict`` carries the reference's weights
across; built on the CPU from torch's default generator, then moved to
the keyword-only ``device`` (default CUDA) and ``dtype``. The forward
returns ``(out, aux1, aux2)`` when it has a classifier, as the
reference's does.
"""
from ...framework import resolve_device
from ...nn import (Layer, Conv2D, ReLU, MaxPool2D, AvgPool2D, Linear,
                   Dropout, Sequential, AdaptiveAvgPool2D)
from ...ops.manipulation import concat, flatten

__all__ = ["GoogLeNet", "googlenet"]


class ConvReLU(Sequential):
    def __init__(self, cin, cout, k, stride=1, padding=0):
        super().__init__(Conv2D(cin, cout, k, stride=stride,
                                padding=padding), ReLU())


class Inception(Layer):
    def __init__(self, cin, c1, c3r, c3, c5r, c5, proj):
        super().__init__()
        self.b1 = ConvReLU(cin, c1, 1)
        self.b2 = Sequential(ConvReLU(cin, c3r, 1), ConvReLU(c3r, c3, 3,
                                                             padding=1))
        self.b3 = Sequential(ConvReLU(cin, c5r, 1), ConvReLU(c5r, c5, 5,
                                                             padding=2))
        self.b4 = Sequential(MaxPool2D(3, stride=1, padding=1),
                             ConvReLU(cin, proj, 1))

    def forward(self, x):
        return concat([self.b1(x), self.b2(x), self.b3(x), self.b4(x)],
                      axis=1)


class _AuxHead(Layer):
    def __init__(self, cin, num_classes):
        super().__init__()
        self.pool = AvgPool2D(5, stride=3)
        self.conv = ConvReLU(cin, 128, 1)
        self.fc1 = Linear(128 * 4 * 4, 1024)
        self.relu = ReLU()
        self.drop = Dropout(0.7)
        self.fc2 = Linear(1024, num_classes)

    def forward(self, x):
        x = self.conv(self.pool(x))
        x = self.relu(self.fc1(flatten(x, 1)))
        return self.fc2(self.drop(x))


class GoogLeNet(Layer):
    def __init__(self, num_classes=1000, with_pool=True,
                 *, device=None, dtype=None):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = Sequential(
            ConvReLU(3, 64, 7, stride=2, padding=3),
            MaxPool2D(3, stride=2, ceil_mode=True),
            ConvReLU(64, 64, 1), ConvReLU(64, 192, 3, padding=1),
            MaxPool2D(3, stride=2, ceil_mode=True))
        self.inc3a = Inception(192, 64, 96, 128, 16, 32, 32)
        self.inc3b = Inception(256, 128, 128, 192, 32, 96, 64)
        self.pool3 = MaxPool2D(3, stride=2, ceil_mode=True)
        self.inc4a = Inception(480, 192, 96, 208, 16, 48, 64)
        self.inc4b = Inception(512, 160, 112, 224, 24, 64, 64)
        self.inc4c = Inception(512, 128, 128, 256, 24, 64, 64)
        self.inc4d = Inception(512, 112, 144, 288, 32, 64, 64)
        self.inc4e = Inception(528, 256, 160, 320, 32, 128, 128)
        self.pool4 = MaxPool2D(3, stride=2, ceil_mode=True)
        self.inc5a = Inception(832, 256, 160, 320, 32, 128, 128)
        self.inc5b = Inception(832, 384, 192, 384, 48, 128, 128)
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.drop = Dropout(0.4)
            self.fc = Linear(1024, num_classes)
            self.aux1 = _AuxHead(512, num_classes)
            self.aux2 = _AuxHead(528, num_classes)
        self.to(resolve_device(device), dtype)

    def forward(self, x):
        x = self.stem(x)
        x = self.pool3(self.inc3b(self.inc3a(x)))
        x = self.inc4a(x)
        aux1 = self.aux1(x) if self.num_classes > 0 else None
        x = self.inc4d(self.inc4c(self.inc4b(x)))
        aux2 = self.aux2(x) if self.num_classes > 0 else None
        x = self.pool4(self.inc4e(x))
        x = self.inc5b(self.inc5a(x))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(self.drop(flatten(x, 1)))
            return x, aux1, aux2
        return x


def googlenet(pretrained=False, **kwargs):
    if pretrained:
        raise RuntimeError("pretrained weights are not available offline")
    return GoogLeNet(**kwargs)
