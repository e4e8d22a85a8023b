"""LeNet (counterpart of ``paddle_tpu/vision/models/lenet.py``): the same
layers, names and ``state_dict`` keys, so
``convert.load_reference_state_dict`` carries the reference's weights
across; built on the CPU from torch's default generator, then moved to
the keyword-only ``device`` (default CUDA) and ``dtype``.
"""
from ...framework import resolve_device
from ...nn import (Layer, Conv2D, ReLU, MaxPool2D, Linear, Sequential)
from ...ops.manipulation import flatten


class LeNet(Layer):
    def __init__(self, num_classes=10,
                 *, device=None, dtype=None):
        super().__init__()
        self.num_classes = num_classes
        self.features = Sequential(
            Conv2D(1, 6, 3, stride=1, padding=1), ReLU(),
            MaxPool2D(2, 2),
            Conv2D(6, 16, 5, stride=1, padding=0), ReLU(),
            MaxPool2D(2, 2),
        )
        if num_classes > 0:
            self.fc = Sequential(
                Linear(400, 120), Linear(120, 84), Linear(84, num_classes))
        self.to(resolve_device(device), dtype)

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = flatten(x, 1)
            x = self.fc(x)
        return x
