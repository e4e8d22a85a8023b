"""Inception v3 (counterpart of
``paddle_tpu/vision/models/inceptionv3.py``): the same layers, names and
``state_dict`` keys, so ``convert.load_reference_state_dict`` carries
the reference's weights across; built on the CPU from torch's default
generator, then moved to the keyword-only ``device`` (default CUDA) and
``dtype``.
"""
from ...framework import resolve_device
from ...nn import (Layer, Conv2D, BatchNorm2D, ReLU, MaxPool2D, AvgPool2D,
                   Linear, Dropout, Sequential, AdaptiveAvgPool2D)
from ...ops.manipulation import concat, flatten

__all__ = ["InceptionV3", "inception_v3"]


class ConvBN(Sequential):
    def __init__(self, cin, cout, k, stride=1, padding=0):
        super().__init__(
            Conv2D(cin, cout, k, stride=stride, padding=padding,
                   bias_attr=False),
            BatchNorm2D(cout), ReLU())


class InceptionA(Layer):
    def __init__(self, cin, pool_features):
        super().__init__()
        self.b1 = ConvBN(cin, 64, 1)
        self.b5 = Sequential(ConvBN(cin, 48, 1), ConvBN(48, 64, 5, padding=2))
        self.b3 = Sequential(ConvBN(cin, 64, 1), ConvBN(64, 96, 3, padding=1),
                             ConvBN(96, 96, 3, padding=1))
        self.bp = Sequential(AvgPool2D(3, stride=1, padding=1),
                             ConvBN(cin, pool_features, 1))

    def forward(self, x):
        return concat([self.b1(x), self.b5(x), self.b3(x), self.bp(x)],
                      axis=1)


class InceptionB(Layer):
    def __init__(self, cin):
        super().__init__()
        self.b3 = ConvBN(cin, 384, 3, stride=2)
        self.b3d = Sequential(ConvBN(cin, 64, 1), ConvBN(64, 96, 3,
                                                         padding=1),
                              ConvBN(96, 96, 3, stride=2))
        self.pool = MaxPool2D(3, stride=2)

    def forward(self, x):
        return concat([self.b3(x), self.b3d(x), self.pool(x)], axis=1)


class InceptionC(Layer):
    def __init__(self, cin, c7):
        super().__init__()
        self.b1 = ConvBN(cin, 192, 1)
        self.b7 = Sequential(
            ConvBN(cin, c7, 1), ConvBN(c7, c7, (1, 7), padding=(0, 3)),
            ConvBN(c7, 192, (7, 1), padding=(3, 0)))
        self.b7d = Sequential(
            ConvBN(cin, c7, 1), ConvBN(c7, c7, (7, 1), padding=(3, 0)),
            ConvBN(c7, c7, (1, 7), padding=(0, 3)),
            ConvBN(c7, c7, (7, 1), padding=(3, 0)),
            ConvBN(c7, 192, (1, 7), padding=(0, 3)))
        self.bp = Sequential(AvgPool2D(3, stride=1, padding=1),
                             ConvBN(cin, 192, 1))

    def forward(self, x):
        return concat([self.b1(x), self.b7(x), self.b7d(x), self.bp(x)],
                      axis=1)


class InceptionD(Layer):
    def __init__(self, cin):
        super().__init__()
        self.b3 = Sequential(ConvBN(cin, 192, 1), ConvBN(192, 320, 3,
                                                         stride=2))
        self.b7 = Sequential(
            ConvBN(cin, 192, 1), ConvBN(192, 192, (1, 7), padding=(0, 3)),
            ConvBN(192, 192, (7, 1), padding=(3, 0)),
            ConvBN(192, 192, 3, stride=2))
        self.pool = MaxPool2D(3, stride=2)

    def forward(self, x):
        return concat([self.b3(x), self.b7(x), self.pool(x)], axis=1)


class InceptionE(Layer):
    def __init__(self, cin):
        super().__init__()
        self.b1 = ConvBN(cin, 320, 1)
        self.b3_stem = ConvBN(cin, 384, 1)
        self.b3_a = ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.b3_b = ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.b3d_stem = Sequential(ConvBN(cin, 448, 1),
                                   ConvBN(448, 384, 3, padding=1))
        self.b3d_a = ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.b3d_b = ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.bp = Sequential(AvgPool2D(3, stride=1, padding=1),
                             ConvBN(cin, 192, 1))

    def forward(self, x):
        s = self.b3_stem(x)
        b3 = concat([self.b3_a(s), self.b3_b(s)], axis=1)
        d = self.b3d_stem(x)
        b3d = concat([self.b3d_a(d), self.b3d_b(d)], axis=1)
        return concat([self.b1(x), b3, b3d, self.bp(x)], axis=1)


class InceptionV3(Layer):
    def __init__(self, num_classes=1000, with_pool=True,
                 *, device=None, dtype=None):
        super().__init__()
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.stem = Sequential(
            ConvBN(3, 32, 3, stride=2), ConvBN(32, 32, 3),
            ConvBN(32, 64, 3, padding=1), MaxPool2D(3, stride=2),
            ConvBN(64, 80, 1), ConvBN(80, 192, 3), MaxPool2D(3, stride=2))
        self.blocks = Sequential(
            InceptionA(192, 32), InceptionA(256, 64), InceptionA(288, 64),
            InceptionB(288),
            InceptionC(768, 128), InceptionC(768, 160),
            InceptionC(768, 160), InceptionC(768, 192),
            InceptionD(768),
            InceptionE(1280), InceptionE(2048))
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.dropout = Dropout(0.5)
            self.fc = Linear(2048, num_classes)
        self.to(resolve_device(device), dtype)

    def forward(self, x):
        x = self.blocks(self.stem(x))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(self.dropout(flatten(x, 1)))
        return x


def inception_v3(pretrained=False, **kwargs):
    if pretrained:
        raise RuntimeError("pretrained weights are not available offline")
    return InceptionV3(**kwargs)
