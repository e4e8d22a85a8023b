"""``paddle.vision`` (counterpart of ``paddle_tpu/vision``): ``models``
(every family of the reference), ``transforms`` (with
``transforms.functional``), ``datasets`` (``FakeData`` and the datasets
that read local files) and the image backend's switches. ``ops`` (the
detection ops) is not ported yet."""
from . import datasets, models, transforms
from .models import (LeNet, MobileNetV2, ResNet, VGG, mobilenet_v2,
                     resnet18, resnet34, resnet50, resnet101, resnet152,
                     vgg16)

__all__ = ["LeNet", "MobileNetV2", "ResNet", "VGG", "datasets",
           "get_image_backend", "image_load", "mobilenet_v2", "models",
           "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
           "set_image_backend", "transforms", "vgg16"]

_IMAGE_BACKEND = "pil"


def set_image_backend(backend):
    """'pil' or 'cv2' (the backend ``image_load`` reads with)."""
    global _IMAGE_BACKEND
    if backend not in ("pil", "cv2"):
        raise ValueError(f"unsupported image backend {backend!r}")
    _IMAGE_BACKEND = backend


def get_image_backend():
    return _IMAGE_BACKEND


def image_load(path, backend=None):
    """The image at ``path``, read with PIL (``cv2`` is not installed:
    asking for it raises, as in the reference)."""
    b = backend or _IMAGE_BACKEND
    if b == "cv2":
        raise RuntimeError("cv2 backend not available in this "
                           "environment; use set_image_backend('pil')")
    from PIL import Image
    return Image.open(path)
