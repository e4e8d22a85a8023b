"""``paddle.vision.datasets`` (counterpart of
``paddle_tpu/vision/datasets.py``): ``FakeData``, the synthetic
ImageNet-shaped dataset, and the datasets that read local files as the
reference's do: ``MNIST`` / ``FashionMNIST`` (idx files, gzipped or
not), ``Cifar10`` / ``Cifar100`` (the python tar), ``DatasetFolder`` /
``ImageFolder`` (one directory per class), ``Flowers`` (102flowers.tgz
or its directory, with imagelabels.mat and setid.mat) and ``VOC2012``
(the VOCtrainval tar or the VOCdevkit directory). Nothing downloads:
a missing file raises the reference's message. Samples are numpy arrays
or PIL images, as there, so the transforms and the DataLoader's workers
take them as they are; the archive datasets hold bytes, not open
files, so they pickle.
"""
from __future__ import annotations

import os
import pickle
import tarfile

import numpy as np

from ..io import Dataset

__all__ = ["Cifar10", "Cifar100", "DatasetFolder", "FakeData",
           "FashionMNIST", "Flowers", "ImageFolder", "MNIST", "VOC2012"]


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


class MNIST(Dataset):
    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend=None):
        self.transform = transform
        if image_path is None or not os.path.exists(image_path):
            raise RuntimeError(
                "MNIST files not found; this sandbox has no network. Pass "
                "image_path/label_path to local idx files, or use "
                "paddle.vision.datasets.FakeData for synthetic data.")
        self.images = self._load_images(image_path)
        self.labels = self._load_labels(label_path)

    @staticmethod
    def _load_images(path):
        import gzip
        op = gzip.open if path.endswith(".gz") else open
        with op(path, "rb") as f:
            data = f.read()
        n = int.from_bytes(data[4:8], "big")
        return np.frombuffer(data, np.uint8, offset=16).reshape(n, 28, 28)

    @staticmethod
    def _load_labels(path):
        import gzip
        op = gzip.open if path.endswith(".gz") else open
        with op(path, "rb") as f:
            data = f.read()
        return np.frombuffer(data, np.uint8, offset=8).astype(np.int64)

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[idx]



class Cifar10(Dataset):
    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        self.transform = transform
        if data_file is None or not os.path.exists(data_file):
            raise RuntimeError(
                "CIFAR archive not found; no network in this sandbox. Pass "
                "data_file=<local cifar-10-python.tar.gz> or use FakeData.")
        self.data, self.labels = self._load(data_file, mode)

    @staticmethod
    def _load(path, mode):
        imgs, labels = [], []
        with tarfile.open(path) as tf:
            want = "data_batch" if mode == "train" else "test_batch"
            names = [n for n in tf.getnames() if want in n]
            for n in sorted(names):
                d = pickle.load(tf.extractfile(n), encoding="bytes")
                imgs.append(d[b"data"])
                labels.extend(d.get(b"labels", d.get(b"fine_labels", [])))
        data = np.concatenate(imgs).reshape(-1, 3, 32, 32)
        return data, np.asarray(labels, np.int64)

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, idx):
        img = self.data[idx].transpose(1, 2, 0)  # HWC for transforms
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[idx]


class Cifar100(Cifar10):
    pass


class DatasetFolder(Dataset):
    """Samples ``(loader(path), class index)`` from ``root/<class>/<file>``
    for every file whose name ends in one of ``extensions`` (default
    ".npy", read by ``np.load``), classes and files in sorted order.
    ``is_valid_file`` is taken and, as in the reference, not read."""

    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        extensions = extensions or (".npy",)
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            cdir = os.path.join(root, c)
            for fn in sorted(os.listdir(cdir)):
                if fn.lower().endswith(extensions):
                    self.samples.append((os.path.join(cdir, fn),
                                         self.class_to_idx[c]))
        self.loader = loader or np.load   # a function: the dataset pickles

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        path, target = self.samples[idx]
        sample = self.loader(path)
        if self.transform is not None:
            sample = self.transform(sample)
        return sample, np.int64(target)


ImageFolder = DatasetFolder


class FashionMNIST(MNIST):
    """The idx format of ``MNIST``, from local file paths."""


class Flowers(Dataset):
    """Oxford 102 flowers from local copies of the official files:
    data_file=102flowers.tgz (or the extracted directory CONTAINING
    jpg/), label_file=imagelabels.mat, setid_file=setid.mat. Labels are
    the raw 1-based Oxford classes, as in the reference."""

    _SPLIT_KEY = {"train": "trnid", "valid": "valid", "test": "tstid"}

    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode="train", transform=None, download=True, backend=None):
        if mode not in self._SPLIT_KEY:
            raise ValueError(
                f"mode must be one of {sorted(self._SPLIT_KEY)}, "
                f"got {mode!r}")
        for f, what in ((data_file, "data_file (102flowers.tgz)"),
                        (label_file, "label_file (imagelabels.mat)"),
                        (setid_file, "setid_file (setid.mat)")):
            if f is None or not os.path.exists(str(f)):
                raise RuntimeError(
                    f"Flowers {what} not found; this sandbox has no "
                    "network — point it at a local copy (or use "
                    "DatasetFolder / FakeData)")
        import scipy.io as sio
        labels = sio.loadmat(str(label_file))["labels"].reshape(-1)
        setid = sio.loadmat(str(setid_file))
        self._indexes = setid[self._SPLIT_KEY[mode]].reshape(-1) \
            .astype(int)  # 1-based image ids
        self._labels = labels
        self._transform = transform
        data_file = str(data_file)
        self._dir = data_file if os.path.isdir(data_file) else None
        self._blobs = None
        if self._dir is None:
            # load this split's members once: random extractfile() on a
            # gzip tar re-decompresses from the archive start on every
            # backward seek, and an open TarFile is unpicklable for
            # DataLoader workers
            wanted = {f"jpg/image_{int(i):05d}.jpg"
                      for i in self._indexes}
            self._blobs = {}
            with tarfile.open(data_file) as tf:
                for m in tf:
                    if m.name in wanted:
                        self._blobs[m.name] = tf.extractfile(m).read()

    def _img_bytes(self, idx1):
        name = f"jpg/image_{idx1:05d}.jpg"
        if self._dir is not None:
            with open(os.path.join(self._dir, name), "rb") as f:
                return f.read()
        return self._blobs[name]

    def __getitem__(self, i):
        import io
        from PIL import Image
        idx1 = int(self._indexes[i])
        img = Image.open(io.BytesIO(self._img_bytes(idx1))).convert("RGB")
        label = int(self._labels[idx1 - 1])  # raw 1-based (reference)
        if self._transform is not None:
            img = self._transform(img)
        return img, np.array([label])

    def __len__(self):
        return len(self._indexes)


class VOC2012(Dataset):
    """Segmentation pairs (image, label mask) from the official
    VOCtrainval tar or an extracted VOCdevkit directory (``data_file``)."""

    _SPLIT = {"train": "train.txt", "valid": "val.txt",
              "trainval": "trainval.txt"}
    _ROOT = "VOCdevkit/VOC2012"

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        if mode not in self._SPLIT:
            raise ValueError(
                f"mode must be one of {sorted(self._SPLIT)}, got {mode!r}")
        if data_file is None or not os.path.exists(str(data_file)):
            raise RuntimeError(
                "VOC2012 archive not found; this sandbox has no network. "
                "Point data_file at a local VOCtrainval tar (or the "
                "extracted VOCdevkit), or use DatasetFolder / FakeData.")
        data_file = str(data_file)
        self._dir = data_file if os.path.isdir(data_file) else None
        self._blobs = None
        split = self._SPLIT[mode]
        if self._dir is None:
            # sequential passes: random tar access is pathological on
            # gzip and an open TarFile breaks DataLoader pickling. Pass 1
            # grabs the split list + masks; pass 2 keeps ONLY this
            # split's JPEGs (the full VOC tar holds ~17k images but a
            # segmentation split references <3k — loading all of them
            # would multiply across DataLoader workers)
            self._blobs = {}
            with tarfile.open(data_file) as tf:
                for m in tf:
                    if m.isfile() and (
                            "/SegmentationClass/" in m.name
                            or "/ImageSets/Segmentation/" in m.name):
                        self._blobs[m.name] = tf.extractfile(m).read()
            split_key = f"{self._ROOT}/ImageSets/Segmentation/{split}"
            if split_key not in self._blobs:
                raise RuntimeError(
                    f"VOC2012 archive has no {split_key} — is this the "
                    "official VOCtrainval tar?")
            self._names = [
                n.strip() for n in
                self._blobs[split_key].decode().split("\n") if n.strip()]
            wanted = {f"{self._ROOT}/JPEGImages/{n}.jpg"
                      for n in self._names}
            with tarfile.open(data_file) as tf:
                for m in tf:
                    if m.name in wanted:
                        self._blobs[m.name] = tf.extractfile(m).read()
        else:
            names = self._read(
                f"{self._ROOT}/ImageSets/Segmentation/{split}")
            self._names = [n.strip() for n in names.decode().split("\n")
                           if n.strip()]
        self._transform = transform

    def _read(self, rel):
        if self._dir is not None:
            with open(os.path.join(self._dir, rel), "rb") as f:
                return f.read()
        return self._blobs[rel]

    def __getitem__(self, i):
        import io
        from PIL import Image
        n = self._names[i].strip()
        img = Image.open(io.BytesIO(self._read(
            f"{self._ROOT}/JPEGImages/{n}.jpg"))).convert("RGB")
        mask = Image.open(io.BytesIO(self._read(
            f"{self._ROOT}/SegmentationClass/{n}.png")))
        if self._transform is not None:
            img = self._transform(img)
        return img, mask

    def __len__(self):
        return len(self._names)
