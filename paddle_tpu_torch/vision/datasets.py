"""``paddle.vision.datasets`` (counterpart of
``paddle_tpu/vision/datasets.py``): ``FakeData``, the synthetic
ImageNet-shaped dataset. The datasets that download are not ported."""
from __future__ import annotations

import numpy as np

from ..io import Dataset

__all__ = ["FakeData"]


class FakeData(Dataset):
    """``size`` samples (image of ``image_shape``, uniform in [0, 1), and
    an int64 label below ``num_classes``), each drawn from
    ``np.random.RandomState(idx % 65536)``: the same per index in both
    packages and every run. ``transform`` is applied to the image."""

    def __init__(self, size=1000, image_shape=(3, 224, 224), num_classes=10,
                 transform=None, dtype="float32"):
        self.size = size
        self.image_shape = tuple(image_shape)
        self.num_classes = num_classes
        self.transform = transform
        self.dtype = dtype

    def __len__(self):
        return self.size

    def __getitem__(self, idx):
        rng = np.random.RandomState(idx % 65536)
        img = rng.rand(*self.image_shape).astype(self.dtype)
        label = np.int64(rng.randint(0, self.num_classes))
        if self.transform is not None:
            img = self.transform(img)
        return img, label
