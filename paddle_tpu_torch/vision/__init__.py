"""``paddle.vision`` (counterpart of ``paddle_tpu/vision``): ``models``
(the ResNet family) and ``datasets`` (``FakeData``). The transforms,
``ops``, the other models and the downloading datasets are not ported
yet."""
from . import datasets, models
from .models import ResNet, resnet18, resnet34, resnet50, resnet101, \
    resnet152

__all__ = ["ResNet", "datasets", "models", "resnet18", "resnet34",
           "resnet50", "resnet101", "resnet152"]
