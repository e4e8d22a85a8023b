"""AlexNet (counterpart of ``paddle_tpu/vision/models/alexnet.py``): the
same layers, names and ``state_dict`` keys, so
``convert.load_reference_state_dict`` carries the reference's weights
across; built on the CPU from torch's default generator, then moved to
the keyword-only ``device`` (default CUDA) and ``dtype``.
"""
from ...framework import resolve_device
from ...nn import (Layer, Conv2D, ReLU, MaxPool2D, Linear, Dropout,
                   Sequential, AdaptiveAvgPool2D)
from ...ops.manipulation import flatten

__all__ = ["AlexNet", "alexnet"]


class AlexNet(Layer):
    def __init__(self, num_classes=1000,
                 *, device=None, dtype=None):
        super().__init__()
        self.num_classes = num_classes
        self.features = Sequential(
            Conv2D(3, 64, 11, stride=4, padding=2), ReLU(),
            MaxPool2D(3, stride=2),
            Conv2D(64, 192, 5, padding=2), ReLU(),
            MaxPool2D(3, stride=2),
            Conv2D(192, 384, 3, padding=1), ReLU(),
            Conv2D(384, 256, 3, padding=1), ReLU(),
            Conv2D(256, 256, 3, padding=1), ReLU(),
            MaxPool2D(3, stride=2),
        )
        self.avgpool = AdaptiveAvgPool2D((6, 6))
        if num_classes > 0:
            self.classifier = Sequential(
                Dropout(0.5), Linear(256 * 6 * 6, 4096), ReLU(),
                Dropout(0.5), Linear(4096, 4096), ReLU(),
                Linear(4096, num_classes),
            )
        self.to(resolve_device(device), dtype)

    def forward(self, x):
        x = self.avgpool(self.features(x))
        if self.num_classes > 0:
            x = self.classifier(flatten(x, 1))
        return x


def alexnet(pretrained=False, **kwargs):
    if pretrained:
        raise RuntimeError("pretrained weights are not available offline")
    return AlexNet(**kwargs)
