"""``vision.transforms`` and ``vision.transforms.functional`` of the port
against the reference's on the CPU: every transform class and function
on a uint8 and an f32 HWC image, Python's ``random`` (and numpy's, for
``RandomErasing``'s "random" value) seeded alike before each call, and
the functional forms on CHW tensors.

Everything but ``Resize`` is the same numpy arithmetic in both packages
and compares exactly. ``Resize`` (and the transforms that resize) is
numpy's copy of the reference's ``jax.image.resize``: the weights equal
jax's to a few f32 ulps (XLA fuses and contracts their arithmetic), and
the products round in another order, so f32 outputs on a 0-255 image
are held to 1e-4 of that range (2.55e-2; the largest difference seen is
3e-4) and uint8 outputs, truncated from those, to one level on at most
0.5 % of the pixels.

Also the datasets that read local files (``vision.datasets``), over tiny
archives and trees made in ``tmp_path``: the same samples, exactly, as
the reference's; the reference's message when the file is missing; and
an archive dataset read by two DataLoader workers.
"""
import random

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.vision.transforms as RT
import paddle_tpu.vision.transforms.functional as RF

import paddle_tpu_torch as pt
import paddle_tpu_torch.vision.transforms as PT
import paddle_tpu_torch.vision.transforms.functional as PF

F32_ATOL = 1e-4 * 255


def _img(dtype, shape=(20, 26, 3), seed=0):
    a = np.random.RandomState(seed).rand(*shape) * 255
    return a.astype(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if hasattr(x, "numpy"):
        return np.asarray(x.numpy())
    return np.asarray(x)


def _run(t, img, seed):
    random.seed(seed)
    np.random.seed(seed)
    return _np(t(img.copy()))


def _close(got, want, resized):
    assert got.shape == want.shape and got.dtype == want.dtype
    if not resized:
        np.testing.assert_array_equal(got, want)
    elif got.dtype == np.uint8:
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.005
    else:
        assert np.abs(got - want).max() <= F32_ATOL


MEAN, STD = [120.0, 110.0, 100.0], [60.0, 55.0, 50.0]

# (class name, args, kwargs, resizes)
CLASSES = [
    ("Resize", (12,), {}, True),
    ("Resize", ((31, 17),), dict(interpolation="bicubic"), True),
    ("Resize", ((9, 40),), dict(interpolation="nearest"), True),
    ("RandomCrop", (11,), {}, False),
    ("RandomCrop", ((8, 12),), dict(padding=2), False),
    ("CenterCrop", (9,), {}, False),
    ("RandomHorizontalFlip", (), dict(prob=0.5), False),
    ("RandomVerticalFlip", (), dict(prob=0.5), False),
    ("RandomResizedCrop", (16,), {}, True),
    ("Normalize", (MEAN, STD), dict(data_format="HWC"), False),
    ("Transpose", (), {}, False),
    ("ToTensor", (), {}, False),
    ("BrightnessTransform", (0.4,), {}, False),
    ("ContrastTransform", (0.4,), {}, False),
    ("SaturationTransform", (0.4,), {}, False),
    ("HueTransform", (0.2,), {}, False),
    ("ColorJitter", (0.3, 0.3, 0.3, 0.1), {}, False),
    ("Pad", ([1, 2, 3, 4],), dict(fill=7), False),
    ("Grayscale", (3,), {}, False),
    ("RandomRotation", (30,), {}, False),
    ("RandomErasing", (), dict(prob=1.0), False),
    ("RandomErasing", (), dict(prob=1.0, value="random"), False),
    ("RandomAffine", (15,), dict(translate=(0.1, 0.2), scale=(0.8, 1.2),
                                  shear=10), False),
    ("RandomPerspective", (), dict(prob=1.0), False),
]


@pytest.mark.parametrize("dtype", [np.uint8, np.float32],
                         ids=["uint8", "f32"])
@pytest.mark.parametrize("name,args,kw,resizes", CLASSES,
                         ids=[f"{c[0]}{i}" for i, c in enumerate(CLASSES)])
def test_transform_equals_the_reference(name, args, kw, resizes, dtype):
    ref, port = getattr(RT, name)(*args, **kw), getattr(PT, name)(*args, **kw)
    img = _img(dtype)
    for seed in (0, 1, 2):
        _close(_run(port, img, seed), _run(ref, img, seed), resizes)


def test_compose_imagenet_pipeline_and_tensor_normalize():
    """The ImageNet train transform, and ``Normalize`` on a CHW tensor
    (it gives a CPU tensor back)."""
    def pipe(T):
        return T.Compose([T.RandomResizedCrop(24), T.RandomHorizontalFlip(),
                          T.Normalize(MEAN, STD, data_format="HWC"),
                          T.Transpose()])
    img = _img(np.uint8, (40, 36, 3), seed=3)
    for seed in range(4):
        _close(_run(pipe(PT), img, seed), _run(pipe(RT), img, seed), True)
    chw = _img(np.float32, (3, 7, 5))
    got = PT.Normalize(MEAN, STD)(torch.from_numpy(chw))
    want = RT.Normalize(MEAN, STD)(paddle.to_tensor(chw))
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("mode", ["bilinear", "bicubic", "nearest"])
@pytest.mark.parametrize("shape,size", [((37, 29, 3), (16, 20)),
                                        ((12, 9, 3), (31, 40)),
                                        ((20, 20), (7, 33)),
                                        ((50, 64, 3), 24)],
                         ids=["shrink", "enlarge", "mixed_2d", "short_side"])
@pytest.mark.parametrize("dtype", [np.uint8, np.float32],
                         ids=["uint8", "f32"])
def test_resize_modes_shrinking_and_enlarging(mode, shape, size, dtype):
    img = _img(dtype, shape, seed=4)
    got = PT.Resize(size, mode)(img)
    want = np.asarray(RT.Resize(size, mode)(img))
    _close(got, want, True)


# (function name, args after the image, resizes)
FUNCS = [
    ("resize", ((13, 22),), True),
    ("hflip", (), False),
    ("vflip", (), False),
    ("adjust_brightness", (1.3,), False),
    ("adjust_contrast", (0.7,), False),
    ("adjust_saturation", (1.4,), False),
    ("adjust_hue", (0.2,), False),
    ("to_grayscale", (), False),
    ("crop", (2, 3, 9, 11), False),
    ("center_crop", (11,), False),
    ("pad", ([1, 2, 3, 4],), False),
    ("affine", (20.0, (2, -1), 0.9, (5.0, 0.0)), False),
    ("rotate", (33.0,), False),
    ("perspective", ([(0, 0), (25, 0), (25, 19), (0, 19)],
                     [(2, 1), (23, 0), (24, 18), (1, 17)]), False),
]


@pytest.mark.parametrize("name,args,resizes", FUNCS,
                         ids=[f[0] for f in FUNCS])
def test_functional_on_hwc_arrays_and_chw_tensors(name, args, resizes):
    img = _img(np.float32)
    _close(_np(getattr(PF, name)(img, *args)),
           _np(getattr(RF, name)(img, *args)), resizes)
    chw = np.ascontiguousarray(_img(np.uint8).transpose(2, 0, 1))
    got = getattr(PF, name)(torch.from_numpy(chw), *args)
    want = getattr(RF, name)(paddle.to_tensor(chw), *args)
    assert isinstance(got, torch.Tensor)
    _close(got.numpy(), _np(want), resizes)
    with pytest.raises(ValueError, match="3-D CHW"):
        getattr(PF, name)(torch.zeros(2, 3, 4, 4), *args)


def test_functional_normalize_to_tensor_and_erase():
    img = _img(np.uint8)
    np.testing.assert_array_equal(PF.to_tensor(img).numpy(),
                                  _np(RF.to_tensor(img)))
    np.testing.assert_array_equal(
        _np(PF.normalize(img, MEAN, STD, data_format="HWC")),
        _np(RF.normalize(img, MEAN, STD, data_format="HWC")))
    np.testing.assert_array_equal(PF.erase(img, 2, 3, 4, 5, 9),
                                  RF.erase(img, 2, 3, 4, 5, 9))
    chw = torch.from_numpy(np.ascontiguousarray(img.transpose(2, 0, 1)))
    v = torch.arange(3, dtype=torch.uint8).reshape(3, 1, 1)
    want = RF.erase(paddle.to_tensor(chw.numpy()), 2, 3, 4, 5,
                    paddle.to_tensor(v.numpy()))
    got = PF.erase(chw, 2, 3, 4, 5, v)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    assert not torch.equal(got, chw)
    same = PF.erase(chw, 2, 3, 4, 5, v, inplace=True)
    assert same is chw and torch.equal(chw, got)


def test_to_tensor_gives_cpu_float_chw():
    out = PT.ToTensor()(_img(np.uint8, (5, 6)))
    assert out.dtype == torch.float32 and tuple(out.shape) == (1, 5, 6)
    assert float(out.max()) <= 1.0
    hwc = PT.ToTensor(data_format="HWC")(_img(np.float32, (5, 6, 3)))
    assert tuple(hwc.shape) == (5, 6, 3) and hwc.is_contiguous()


def test_image_backend_and_load(tmp_path):
    from PIL import Image
    path = tmp_path / "x.png"
    Image.fromarray(_img(np.uint8, (4, 5, 3))).save(path)
    assert pt.vision.get_image_backend() == "pil"
    np.testing.assert_array_equal(np.asarray(pt.vision.image_load(path)),
                                  np.asarray(paddle.vision.image_load(path)))
    with pytest.raises(ValueError):
        pt.vision.set_image_backend("tensor")
    pt.vision.set_image_backend("cv2")
    try:
        with pytest.raises(RuntimeError, match="cv2"):
            pt.vision.image_load(path)
    finally:
        pt.vision.set_image_backend("pil")


# -------------------------------------------------------------- datasets --

def _idx(path, arr, magic):
    import gzip
    head = magic.to_bytes(4, "big") + b"".join(
        int(n).to_bytes(4, "big") for n in arr.shape)
    with gzip.open(path, "wb") as f:
        f.write(head + arr.astype(np.uint8).tobytes())


def _cifar(path, n_classes):
    import io
    import pickle
    import tarfile
    rng = np.random.RandomState(0)
    key = b"labels" if n_classes == 10 else b"fine_labels"
    with tarfile.open(path, "w:gz") as tf:
        for name in ("cifar/data_batch_1", "cifar/data_batch_2",
                     "cifar/test_batch"):
            d = {b"data": rng.randint(0, 256, (3, 3072), np.uint8),
                 key: rng.randint(0, n_classes, 3).tolist()}
            blob = pickle.dumps(d)
            info = tarfile.TarInfo(name)
            info.size = len(blob)
            tf.addfile(info, io.BytesIO(blob))


def _flowers(d):
    import io
    import tarfile
    import scipy.io as sio
    from PIL import Image
    tgz = d / "102flowers.tgz"
    with tarfile.open(tgz, "w:gz") as tf:
        for i in range(1, 7):
            b = io.BytesIO()
            Image.fromarray(_img(np.uint8, (8, 8, 3), seed=i)).save(b, "PNG")
            info = tarfile.TarInfo(f"jpg/image_{i:05d}.jpg")
            info.size = len(b.getvalue())
            tf.addfile(info, io.BytesIO(b.getvalue()))
    sio.savemat(d / "imagelabels.mat", {"labels": np.array([[1, 1, 2, 2, 3,
                                                              3]])})
    sio.savemat(d / "setid.mat", {"trnid": np.array([[1, 3, 5]]),
                                  "valid": np.array([[2]]),
                                  "tstid": np.array([[4, 6]])})
    return dict(data_file=str(tgz), label_file=str(d / "imagelabels.mat"),
                setid_file=str(d / "setid.mat"))


def _voc(d, as_tar):
    import tarfile
    from PIL import Image
    root = d / "VOCdevkit" / "VOC2012"
    (root / "ImageSets" / "Segmentation").mkdir(parents=True)
    (root / "JPEGImages").mkdir()
    (root / "SegmentationClass").mkdir()
    for k, n in enumerate(("2007_000001", "2007_000002", "2007_000003")):
        Image.fromarray(_img(np.uint8, (6, 7, 3), seed=k)).save(
            root / "JPEGImages" / f"{n}.jpg", "PNG")
        Image.fromarray(np.full((6, 7), k, np.uint8)).save(
            root / "SegmentationClass" / f"{n}.png")
    (root / "ImageSets" / "Segmentation" / "train.txt").write_text(
        "2007_000001\n2007_000003\n")
    (root / "ImageSets" / "Segmentation" / "val.txt").write_text(
        "2007_000002\n")
    if not as_tar:
        return str(d)
    tar = d / "voc.tar"
    with tarfile.open(tar, "w") as tf:
        tf.add(d / "VOCdevkit", arcname="VOCdevkit")
    return str(tar)


def _datasets(name, d):
    """(reference dataset, port dataset) of ``name`` over files in ``d``,
    both with the same transform."""
    import paddle_tpu.vision.datasets as RD
    import paddle_tpu_torch.vision.datasets as PD
    if name in ("MNIST", "FashionMNIST"):
        rng = np.random.RandomState(1)
        _idx(d / "img.gz", rng.randint(0, 256, (5, 28, 28)), 2051)
        _idx(d / "lab.gz", rng.randint(0, 10, (5,)), 2049)
        kw = dict(image_path=str(d / "img.gz"), label_path=str(d / "lab.gz"))
    elif name in ("Cifar10", "Cifar100"):
        _cifar(d / "c.tar.gz", 10 if name == "Cifar10" else 100)
        kw = dict(data_file=str(d / "c.tar.gz"), mode="test")
    elif name in ("DatasetFolder", "ImageFolder"):
        for c in ("b", "a"):
            (d / c).mkdir()
            for i in range(2):
                np.save(d / c / f"{i}.npy", _img(np.float32, (4, 4), i))
        (d / "a" / "skip.txt").write_text("x")
        kw = dict(root=str(d))
    elif name == "Flowers":
        kw = dict(_flowers(d), mode="train")
    else:
        kw = dict(data_file=_voc(d, name == "VOC2012_tar"), mode="train")
        name = "VOC2012"
    return (getattr(RD, name)(transform=RT.Transpose(), **kw),
            getattr(PD, name)(transform=PT.Transpose(), **kw))


DATASETS = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100", "DatasetFolder",
            "ImageFolder", "Flowers", "VOC2012", "VOC2012_tar"]


@pytest.mark.parametrize("name", DATASETS)
def test_local_file_dataset_equals_the_reference(name, tmp_path):
    import pickle
    ref, port = _datasets(name, tmp_path)
    assert len(port) == len(ref) > 0
    for i in range(len(ref)):
        for a, b in zip(port[i], ref[i]):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert len(pickle.loads(pickle.dumps(port))) == len(port)


@pytest.mark.parametrize("name,kw", [
    ("MNIST", dict(image_path=None)), ("Cifar10", {}), ("Flowers", {}),
    ("VOC2012", {})])
def test_missing_files_raise_the_references_message(name, kw, tmp_path):
    import paddle_tpu.vision.datasets as RD
    import paddle_tpu_torch.vision.datasets as PD
    with pytest.raises(RuntimeError) as want:
        getattr(RD, name)(**kw)
    with pytest.raises(RuntimeError) as got:
        getattr(PD, name)(**kw)
    assert str(got.value) == str(want.value)


def test_workers_read_an_archive_dataset_as_in_process(tmp_path):
    """Cifar10 (held as arrays) through ``ToTensor`` in two workers: the
    in-process batches."""
    import paddle_tpu_torch.vision.datasets as PD
    _cifar(tmp_path / "c.tar.gz", 10)
    ds = PD.Cifar10(data_file=str(tmp_path / "c.tar.gz"),
                    transform=PT.ToTensor())
    kw = dict(places="cpu", batch_size=4)
    got = list(pt.io.DataLoader(ds, num_workers=2, **kw))
    want = list(pt.io.DataLoader(ds, **kw))
    assert len(got) == len(want) == 2
    for (gx, gy), (wx, wy) in zip(got, want):
        assert torch.equal(gx, wx) and torch.equal(gy, wy)
