"""``paddle.io`` and ``paddle.metric`` of the port against the reference's
on the CPU: the datasets, the samplers (numpy's global generator, seeded
alike on both sides), collation, ``DataLoader``'s batches and their
order with a seeded ``RandomSampler``, ``FakeData`` sample by sample,
and ``Accuracy`` (top-k), ``Precision``, ``Recall``, ``Auc`` and
``accuracy`` on seeded predictions. Values compare exactly (indices,
labels, counts) or at f32 atol = rtol = 1e-6 (images, metrics).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.io as rio
import paddle_tpu.metric as rmetric

import paddle_tpu_torch.io as pio
import paddle_tpu_torch.metric as pmetric
from paddle_tpu_torch.vision.datasets import FakeData

TOL = dict(atol=1e-6, rtol=1e-6)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t.numpy()) if hasattr(t, "numpy") else np.asarray(t)


class _Squares:
    """A map-style dataset of (array, int, float) samples, subclassed
    from each package's ``Dataset``."""

    def __init__(self, n=11):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return (np.full((2, 3), i, np.float32), i * i, float(i) / 2)


def _both(cls_name, *args):
    ref = type("R", (_Squares, rio.Dataset), {})(*args)
    port = type("P", (_Squares, pio.Dataset), {})(*args)
    return ref, port


def _batches(loader):
    return [tuple(_np(t) for t in b) for b in loader]


@pytest.mark.parametrize("kw", [
    dict(batch_size=4), dict(batch_size=4, drop_last=True),
    dict(batch_size=3, shuffle=True), dict(batch_size=5, shuffle=True,
                                           drop_last=True)])
def test_data_loader_batches_and_order_equal_the_reference(kw):
    ref_ds, port_ds = _both("squares")
    np.random.seed(7)
    want = _batches(rio.DataLoader(ref_ds, **kw))
    np.random.seed(7)
    got = _batches(pio.DataLoader(port_ds, places="cpu", **kw))
    assert len(got) == len(want) == len(pio.DataLoader(port_ds, places="cpu",
                                                       **kw))
    for g, w in zip(got, want):
        assert [a.dtype for a in g] == [a.dtype for a in w]
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_data_loader_with_samplers_and_collate():
    ref_ds, port_ds = _both("squares", 10)
    np.random.seed(3)
    rs = rio.RandomSampler(ref_ds, replacement=True, num_samples=7)
    want = _batches(rio.DataLoader(ref_ds, batch_sampler=rio.BatchSampler(
        sampler=rs, batch_size=3)))
    np.random.seed(3)
    ps = pio.RandomSampler(port_ds, replacement=True, num_samples=7)
    got = _batches(pio.DataLoader(port_ds, places="cpu",
                                  batch_sampler=pio.BatchSampler(
                                      sampler=ps, batch_size=3)))
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    dicts = [{"x": np.ones(2, np.float32) * i, "y": i} for i in range(3)]
    out = pio.default_collate_fn(dicts)
    assert out["x"].shape == (3, 2) and out["y"].dtype == torch.int64
    stacked = pio.default_collate_fn([torch.ones(2), torch.zeros(2)])
    assert stacked.shape == (2, 2)
    conv = pio.default_convert_fn([np.arange(3), (1.5, {"k": 2})])
    assert isinstance(conv[0], torch.Tensor) and conv[1][1]["k"] == 2
    assert pio.DataLoader(port_ds, places="cpu",
                          collate_fn=lambda b: len(b),
                          batch_size=4).__iter__().__next__() == 4


def test_samplers_equal_the_reference():
    ref_ds, port_ds = _both("squares", 13)
    assert list(pio.SequenceSampler(port_ds)) == list(
        rio.SequenceSampler(ref_ds))
    np.random.seed(1)
    want = list(rio.WeightedRandomSampler([1, 2, 3, 0.5], 9))
    np.random.seed(1)
    assert list(pio.WeightedRandomSampler([1, 2, 3, 0.5], 9)) == want
    for kw in (dict(num_replicas=3, rank=1), dict(num_replicas=2, rank=0,
                                                  shuffle=True,
                                                  drop_last=True)):
        r = rio.DistributedBatchSampler(ref_ds, 2, **kw)
        p = pio.DistributedBatchSampler(port_ds, 2, **kw)
        r.set_epoch(4)
        p.set_epoch(4)
        assert list(p) == list(r) and len(p) == len(r)
    one = pio.DistributedBatchSampler(port_ds, 4)
    assert one.nranks == 1 and one.local_rank == 0
    sub = pio.SubsetRandomSampler([3, 5, 7])
    assert sorted(sub) == [3, 5, 7] and len(sub) == 3


def test_datasets_equal_the_reference():
    xs = np.arange(12, dtype=np.float32).reshape(6, 2)
    ys = np.arange(6)
    rt = rio.TensorDataset([xs, ys])
    ptd = pio.TensorDataset([torch.from_numpy(xs), torch.from_numpy(ys)])
    assert len(ptd) == len(rt) == 6
    np.testing.assert_array_equal(_np(ptd[4][0]), rt[4][0])
    ref_ds, port_ds = _both("squares", 5)
    rc = rio.ConcatDataset([ref_ds, rt])
    pc = pio.ConcatDataset([port_ds, ptd])
    assert len(pc) == len(rc) == 11
    for i in (0, 4, 5, 10, -1):
        np.testing.assert_array_equal(_np(pc[i][0]), _np(rc[i][0]))
    rcomp = rio.ComposeDataset([ref_ds, rt])
    pcomp = pio.ComposeDataset([port_ds, ptd])
    assert len(pcomp) == len(rcomp) == 5 and len(pcomp[2]) == len(rcomp[2])
    assert [v for v in pio.ChainDataset([[1, 2], [3]])] == [
        v for v in rio.ChainDataset([[1, 2], [3]])]
    np.random.seed(5)
    want = [s.indices for s in rio.random_split(rc, [0.5, 0.3, 0.2])]
    np.random.seed(5)
    got = [s.indices for s in pio.random_split(pc, [0.5, 0.3, 0.2])]
    assert got == want
    with pytest.raises(ValueError):
        pio.random_split(pc, [3, 3])
    with pytest.raises(RuntimeError):
        pio.IterableDataset()[0]


def test_iterable_dataset_loader():
    class Stream(pio.IterableDataset):
        def __iter__(self):
            for i in range(7):
                yield np.float32(i), i
    batches = list(pio.DataLoader(Stream(), places="cpu", batch_size=3))
    assert [b[1].tolist() for b in batches] == [[0, 1, 2], [3, 4, 5], [6]]
    assert batches[0][0].dtype == torch.float32
    with pytest.raises(TypeError):
        len(pio.DataLoader(Stream(), places="cpu"))


def test_fake_data_equals_the_reference_per_index():
    from paddle_tpu.vision.datasets import FakeData as RefFake
    ref, port = RefFake(70000, (3, 8, 8), 1000), FakeData(70000, (3, 8, 8),
                                                          1000)
    assert len(port) == len(ref)
    for i in (0, 1, 65535, 65536 + 3):
        (a, la), (b, lb) = port[i], ref[i]
        np.testing.assert_array_equal(a, b)
        assert la == lb and a.dtype == np.float32
    assert FakeData(3, transform=lambda im: im[:1])[0][0].shape == (1, 224,
                                                                   224)


def test_data_loader_refusals(monkeypatch, tmp_path):
    """Workers whose ring library cannot be built raise (the reference
    falls back to a thread: ``test_torch_io_workers.py``); the default
    device without a GPU raises."""
    from paddle_tpu_torch import _native
    _, port_ds = _both("squares")
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "library_path",
                        lambda: tmp_path / "libshm_channel-x.so")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="shm_channel.cc"):
        list(pio.DataLoader(port_ds, places="cpu", num_workers=2))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pio.DataLoader(port_ds)


# ----------------------------------------------------------------- metric --

@pytest.mark.parametrize("topk", [(1,), (1, 5), 3])
def test_accuracy_equals_the_reference(topk):
    rng = np.random.RandomState(0)
    ref, port = rmetric.Accuracy(topk=topk), pmetric.Accuracy(topk=topk)
    for step in range(3):
        pred = rng.randn(16, 10).astype(np.float32)
        label = rng.randint(0, 10, (16, 1)).astype(np.int64)
        rc = ref.compute(paddle.to_tensor(pred), paddle.to_tensor(label))
        pc = port.compute(torch.from_numpy(pred), torch.from_numpy(label))
        np.testing.assert_array_equal(_np(pc), _np(rc))
        assert port.update(pc) == pytest.approx(ref.update(rc), abs=1e-6, rel=1e-6)
    assert port.accumulate() == pytest.approx(ref.accumulate(), abs=1e-6, rel=1e-6)
    assert port.name() == ref.name()
    port.reset()
    assert port.count == [0] * len(port.topk)


def test_precision_recall_auc_accuracy_equal_the_reference():
    rng = np.random.RandomState(1)
    for cls in ("Precision", "Recall", "Auc"):
        ref, port = getattr(rmetric, cls)(), getattr(pmetric, cls)()
        for _ in range(3):
            p = rng.rand(20).astype(np.float32)
            if cls == "Auc":
                p = np.stack([1 - p, p], axis=1)
            lab = rng.randint(0, 2, (20, 1)).astype(np.int64)
            ref.update(paddle.to_tensor(p), paddle.to_tensor(lab))
            port.update(torch.from_numpy(p), torch.from_numpy(lab))
        assert port.accumulate() == pytest.approx(ref.accumulate(), abs=1e-6, rel=1e-6)
        assert port.name() == ref.name()
    pred = rng.randn(12, 6).astype(np.float32)
    lab = rng.randint(0, 6, (12, 1)).astype(np.int64)
    for k in (1, 3):
        np.testing.assert_allclose(
            _np(pmetric.accuracy(torch.from_numpy(pred),
                                 torch.from_numpy(lab), k=k)),
            _np(rmetric.accuracy(paddle.to_tensor(pred),
                                 paddle.to_tensor(lab), k=k)), **TOL)
