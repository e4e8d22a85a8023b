"""VGG (counterpart of ``paddle_tpu/vision/models/vgg.py``): the same
layers, names and ``state_dict`` keys, so
``convert.load_reference_state_dict`` carries the reference's weights
across; built on the CPU from torch's default generator, then moved to
the keyword-only ``device`` (default CUDA) and ``dtype``.
"""
from ...framework import resolve_device
from ...nn import (Layer, Conv2D, ReLU, MaxPool2D, Linear, Sequential,
                   Dropout, AdaptiveAvgPool2D, BatchNorm2D)
from ...ops.manipulation import flatten


_cfgs = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512,
          "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
          512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
          512, 512, 512, 512, "M", 512, 512, 512, 512, "M"],
}


def _make_layers(cfg, batch_norm=False):
    layers = []
    in_c = 3
    for v in cfg:
        if v == "M":
            layers.append(MaxPool2D(2, 2))
        else:
            layers.append(Conv2D(in_c, v, 3, padding=1))
            if batch_norm:
                layers.append(BatchNorm2D(v))
            layers.append(ReLU())
            in_c = v
    return Sequential(*layers)


class VGG(Layer):
    def __init__(self, features, num_classes=1000, with_pool=True,
                 *, device=None, dtype=None):
        super().__init__()
        self.features = features
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            self.classifier = Sequential(
                Linear(512 * 7 * 7, 4096), ReLU(), Dropout(),
                Linear(4096, 4096), ReLU(), Dropout(),
                Linear(4096, num_classes))
        self.num_classes = num_classes
        self.to(resolve_device(device), dtype)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = flatten(x, 1)
            x = self.classifier(x)
        return x


def _vgg(cfg, batch_norm, pretrained, **kw):
    if pretrained:
        raise RuntimeError("pretrained weights are not available offline")
    return VGG(_make_layers(_cfgs[cfg], batch_norm), **kw)


def vgg11(pretrained=False, batch_norm=False, **kw):
    return _vgg("A", batch_norm, pretrained, **kw)


def vgg13(pretrained=False, batch_norm=False, **kw):
    return _vgg("B", batch_norm, pretrained, **kw)


def vgg16(pretrained=False, batch_norm=False, **kw):
    return _vgg("D", batch_norm, pretrained, **kw)


def vgg19(pretrained=False, batch_norm=False, **kw):
    return _vgg("E", batch_norm, pretrained, **kw)
