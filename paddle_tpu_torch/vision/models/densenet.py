"""DenseNet (counterpart of ``paddle_tpu/vision/models/densenet.py``): the
same layers, names and ``state_dict`` keys, so
``convert.load_reference_state_dict`` carries the reference's weights
across; built on the CPU from torch's default generator, then moved to
the keyword-only ``device`` (default CUDA) and ``dtype``.
"""
from ...framework import resolve_device
from ...nn import (Layer, Conv2D, BatchNorm2D, ReLU, MaxPool2D, AvgPool2D,
                   Linear, Dropout, Sequential, AdaptiveAvgPool2D)
from ...ops.manipulation import concat, flatten

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201", "densenet264"]

_CFG = {
    121: (64, 32, [6, 12, 24, 16]),
    161: (96, 48, [6, 12, 36, 24]),
    169: (64, 32, [6, 12, 32, 32]),
    201: (64, 32, [6, 12, 48, 32]),
    264: (64, 32, [6, 12, 64, 48]),
}


class _DenseLayer(Layer):
    def __init__(self, in_ch, growth_rate, bn_size, dropout):
        super().__init__()
        self.bn1 = BatchNorm2D(in_ch)
        self.conv1 = Conv2D(in_ch, bn_size * growth_rate, 1, bias_attr=False)
        self.bn2 = BatchNorm2D(bn_size * growth_rate)
        self.conv2 = Conv2D(bn_size * growth_rate, growth_rate, 3, padding=1,
                            bias_attr=False)
        self.relu = ReLU()
        self.dropout = Dropout(dropout) if dropout else None

    def forward(self, x):
        y = self.conv1(self.relu(self.bn1(x)))
        y = self.conv2(self.relu(self.bn2(y)))
        if self.dropout is not None:
            y = self.dropout(y)
        return concat([x, y], axis=1)


class _Transition(Layer):
    def __init__(self, in_ch, out_ch):
        super().__init__()
        self.bn = BatchNorm2D(in_ch)
        self.relu = ReLU()
        self.conv = Conv2D(in_ch, out_ch, 1, bias_attr=False)
        self.pool = AvgPool2D(2, stride=2)

    def forward(self, x):
        return self.pool(self.conv(self.relu(self.bn(x))))


class DenseNet(Layer):
    def __init__(self, layers=121, bn_size=4, dropout=0.0,
                 num_classes=1000, with_pool=True,
                 *, device=None, dtype=None):
        super().__init__()
        assert layers in _CFG, f"supported layers: {sorted(_CFG)}"
        num_init, growth, blocks = _CFG[layers]
        self.num_classes = num_classes
        self.with_pool = with_pool
        feats = [Conv2D(3, num_init, 7, stride=2, padding=3,
                        bias_attr=False),
                 BatchNorm2D(num_init), ReLU(),
                 MaxPool2D(3, stride=2, padding=1)]
        ch = num_init
        for i, n in enumerate(blocks):
            for _ in range(n):
                feats.append(_DenseLayer(ch, growth, bn_size, dropout))
                ch += growth
            if i != len(blocks) - 1:
                feats.append(_Transition(ch, ch // 2))
                ch = ch // 2
        feats += [BatchNorm2D(ch), ReLU()]
        self.features = Sequential(*feats)
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = Linear(ch, num_classes)
        self.to(resolve_device(device), dtype)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(flatten(x, 1))
        return x


def _make(layers):
    def ctor(pretrained=False, **kwargs):
        if pretrained:
            raise RuntimeError("pretrained weights are not available offline")
        return DenseNet(layers=layers, **kwargs)
    ctor.__name__ = f"densenet{layers}"
    return ctor


densenet121 = _make(121)
densenet161 = _make(161)
densenet169 = _make(169)
densenet201 = _make(201)
densenet264 = _make(264)
