"""The port's DataLoader worker processes (``io/_worker.py``) and their
shared-memory ring (``_native.ShmChannel`` over
``paddle_tpu_torch/csrc/shm_channel.cc``, built here with g++) against
the reference's ``DataLoader(num_workers=2)`` on the CPU.

Batches compare exactly: the samples are integers and float32 arrays
that no step rounds. The samplers and the workers' numpy generators are
seeded alike in both packages (``np.random.seed`` before each loader).
Each of the three decided divergences is shown beside the reference's
result: the port's worker collate stacks ``torch.Tensor`` samples where
the reference's returns a list; the port seeds Python's ``random`` in
each worker where the reference's workers draw from the OS; a failed
build of the ring's library raises where the reference falls back to a
thread.
"""
import os
import random

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.io as rio
import paddle_tpu.vision.transforms as RT

import paddle_tpu_torch.io as pio
import paddle_tpu_torch.vision.transforms as PT
from paddle_tpu_torch import _native
from paddle_tpu_torch.framework import flags


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.numpy()
    return np.asarray(t.numpy())


def _tree(batch):
    """A batch as nested tuples of numpy arrays (either package)."""
    if isinstance(batch, (list, tuple)):
        return tuple(_tree(b) for b in batch)
    return _np(batch)


def _equal(a, b):
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a.dtype == b.dtype and np.array_equal(a, b)


def _pair(cls):
    """``cls`` built on each package's ``Dataset`` (reference, port)."""
    return (type(cls.__name__, (cls, rio.Dataset), {})(),
            type(cls.__name__, (cls, pio.Dataset), {})())


class _Samples:
    """(float32 image, int label, float score) per index, and a numpy
    draw from the process's global generator (a worker's, in a
    worker)."""

    def __len__(self):
        return 23

    def __getitem__(self, i):
        img = np.arange(12, dtype=np.float32).reshape(3, 4) + i
        return img, i, np.float32(i) / 4, np.random.randint(0, 1 << 30)


class _Shards:
    """An iterable dataset of 0..16 sharded round robin by
    ``get_worker_info`` (each package's own)."""

    get_info = None

    def __iter__(self):
        info = self.get_info()
        wid, n = (0, 1) if info is None else (info.id, info.num_workers)
        for i in range(wid, 17, n):
            yield np.array([i, i * i], np.int64), i


def _loaders(ref_ds, port_ds, **kw):
    np.random.seed(7)
    ref = [_tree(b) for b in rio.DataLoader(ref_ds, **kw)]
    np.random.seed(7)
    port = [_tree(b) for b in pio.DataLoader(port_ds, places="cpu", **kw)]
    return ref, port


# ------------------------------------------------------------------ ring --

def test_ring_round_trip_and_limits():
    name = f"/pdt_test_ring_{os.getpid()}"   # one segment a process
    owner = _native.ShmChannel(name, 1 << 12, create=True)
    try:
        peer = _native.ShmChannel(name)
        msgs = [b"", b"x" * 1000, bytes(range(256)) * 3]
        for m in msgs:
            peer.push(m)
        assert [owner.pop() for _ in msgs] == msgs
        for m in msgs * 4:         # wraps around the 4 KiB ring
            peer.push(m)
            assert owner.pop() == m
        obj = {"a": np.arange(5), "b": (1, "two")}
        peer.push_obj(obj)
        got = owner.pop_obj()
        assert got["b"] == obj["b"] and np.array_equal(got["a"], obj["a"])
        with pytest.raises(TimeoutError):
            owner.pop(timeout_ms=10)
        with pytest.raises(RuntimeError, match="larger than ring capacity"):
            peer.push(b"y" * (1 << 12))
        peer.push(b"last")
        owner.close_write()
        assert owner.pop() == b"last" and owner.pop() is None
        with pytest.raises(RuntimeError, match="closed"):
            peer.push(b"z")
        peer.close()
    finally:
        owner.close()
    with pytest.raises(RuntimeError, match="missing"):
        _native.ShmChannel(name)


def test_library_is_named_by_its_source_and_flags():
    path = _native.library_path()
    assert path.parent == _native._build.BUILD_DIR
    assert path.name.startswith("libshm_channel-") and path.exists()
    assert flags.flag_value("shm_channel_capacity_mb") == 64


# --------------------------------------------------------------- batches --

@pytest.mark.parametrize("kw", [dict(batch_size=4, shuffle=True),
                                dict(batch_size=5, drop_last=True)],
                         ids=["shuffle", "drop_last"])
def test_worker_batches_equal_in_process_and_the_references(kw):
    """Batches in the sampler's order, each worker's numpy draws from
    ``seed + worker_id`` with ``seed`` drawn as the reference draws it:
    the port's two workers give the reference's two workers' batches;
    without the draw, ``num_workers=0``'s."""
    ref_ds, port_ds = _pair(_Samples)
    ref, port = _loaders(ref_ds, port_ds, num_workers=2, **kw)
    assert len(port) == len(ref) == (6 if kw.get("shuffle") else 4)
    assert all(_equal(a, b) for a, b in zip(port, ref))
    _, in_proc = _loaders(ref_ds, port_ds, num_workers=0, **kw)
    assert all(_equal(a[:3], b[:3]) for a, b in zip(port, in_proc))


def test_iterable_shards_by_worker_info():
    """Each worker streams its shard and batches it: the same batches as
    the reference's workers (the order across workers is theirs to race
    for), and the same samples as one in-process pass, where
    ``get_worker_info`` is ``(0, 1)``."""
    rcls = type("R", (_Shards, rio.IterableDataset),
                {"get_info": staticmethod(rio.get_worker_info)})
    pcls = type("P", (_Shards, pio.IterableDataset),
                {"get_info": staticmethod(pio.get_worker_info)})
    ref, port = _loaders(rcls(), pcls(), num_workers=2, batch_size=3)
    key = lambda b: b[1].tolist()  # noqa: E731
    assert sorted(port, key=key) and len(port) == len(ref) == 6
    for a, b in zip(sorted(port, key=key), sorted(ref, key=key)):
        assert _equal(a, b)
    _, one = _loaders(rcls(), pcls(), num_workers=0, batch_size=3)
    assert sorted(int(i) for b in one for i in b[1]) == list(range(17))
    assert sorted(int(i) for b in port for i in b[1]) == list(range(17))
    assert pio.get_worker_info() is None


def test_worker_info_and_init_fn():
    class Info(pio.Dataset):
        def __len__(self):
            return 4

        def __getitem__(self, i):
            w = pio.get_worker_info()
            return np.array([w.id, w.num_workers, w.seed, hits[0]])

    hits = [0]

    def init(worker_id):
        hits[0] = 100 + worker_id

    np.random.seed(3)
    seed = np.random.randint(0, 2 ** 31)
    np.random.seed(3)
    rows = torch.cat(list(pio.DataLoader(
        Info(), places="cpu", batch_size=1, num_workers=2,
        worker_init_fn=init))).tolist()
    assert rows == [[i % 2, 2, seed + i % 2, 100 + i % 2] for i in range(4)]


def test_workers_run_one_torch_and_one_blas_thread():
    """Each worker sets torch's threads and numpy's OpenBLAS threads to 1
    (six workers of eight BLAS threads each ran ``Resize`` ten times
    slower than the parent)."""
    import ctypes

    def blas_threads():
        with open("/proc/self/maps") as f:
            libs = {ln.split()[-1] for ln in f
                    if "openblas" in ln.lower() and ".so" in ln}
        for path in libs:
            get = getattr(ctypes.CDLL(path),
                          "scipy_openblas_get_num_threads64_", None)
            if get is not None:
                get.restype = ctypes.c_int
                return get()
        return -1

    class Threads(pio.Dataset):
        def __len__(self):
            return 2

        def __getitem__(self, i):
            return np.array([torch.get_num_threads(), blas_threads()])

    rows = torch.cat(list(pio.DataLoader(Threads(), places="cpu",
                                         num_workers=2))).tolist()
    assert all(r[0] == 1 for r in rows)
    if blas_threads() != -1:
        assert all(r[1] == 1 for r in rows)


def test_worker_error_carries_its_traceback():
    class Bad(pio.Dataset):
        def __len__(self):
            return 6

        def __getitem__(self, i):
            if i == 3:
                raise ValueError(f"bad sample {i}")
            return np.zeros(2)

    with pytest.raises(RuntimeError) as e:
        list(pio.DataLoader(Bad(), places="cpu", batch_size=2,
                            num_workers=2))
    msg = str(e.value)
    assert "DataLoader worker 1 failed" in msg
    assert "ValueError: bad sample 3" in msg and "__getitem__" in msg


def test_thread_path_equals_in_process():
    """``use_shared_memory=False``: a thread prefetches the in-process
    batches (the main process's numpy draws, as in the reference)."""
    ref_ds, port_ds = _pair(_Samples)
    ref, port = _loaders(ref_ds, port_ds, num_workers=2, batch_size=4,
                         shuffle=True, use_shared_memory=False)
    _, in_proc = _loaders(ref_ds, port_ds, num_workers=0, batch_size=4,
                          shuffle=True)
    assert len(port) == 6
    assert all(_equal(a, b) for a, b in zip(port, in_proc))
    assert all(_equal(a, b) for a, b in zip(port, ref))


def test_multiprocess_reader_equals_the_references():
    def reader(k):
        return lambda: iter(range(k * 10, k * 10 + k + 1))
    readers = [reader(k) for k in range(3)]
    assert list(pio.multiprocess_reader(readers)()) == \
        list(rio.multiprocess_reader(readers)())


# ------------------------------------------------------------- decisions --

class _Images:
    def __init__(self):
        self.t = None

    def __len__(self):
        return 4

    def __getitem__(self, i):
        img = np.full((8, 8, 3), i * 40, np.uint8)
        return self.t(img), i


def test_worker_collate_stacks_tensors_where_the_reference_lists_them():
    """A transform ending in ``ToTensor``: the port's worker batch is one
    [2, 3, 8, 8] tensor, as with ``num_workers=0``; the reference's
    worker batch is a list of two tensors (its ``numpy_collate`` has no
    tensor branch)."""
    ref_ds, port_ds = _pair(_Images)
    ref_ds.t, port_ds.t = RT.ToTensor(), PT.ToTensor()
    port = list(pio.DataLoader(port_ds, places="cpu", batch_size=2,
                               num_workers=2))
    one = list(pio.DataLoader(port_ds, places="cpu", batch_size=2))
    assert tuple(port[0][0].shape) == (2, 3, 8, 8)
    assert all(torch.equal(a[0], b[0]) for a, b in zip(port, one))
    ref = list(rio.DataLoader(ref_ds, batch_size=2, num_workers=2))
    ref_one = list(rio.DataLoader(ref_ds, batch_size=2))
    assert isinstance(ref[0][0], list) and len(ref[0][0]) == 2
    assert tuple(ref_one[0][0].shape) == (2, 3, 8, 8)
    np.testing.assert_array_equal(_np(port[1][0]), _np(ref_one[1][0]))


class _Draws:
    def __len__(self):
        return 6

    def __getitem__(self, i):
        return np.array([random.randint(0, 1 << 30),
                         np.random.randint(0, 1 << 30)])


def test_workers_seed_python_random_where_the_reference_does_not():
    """Two runs from the same seeds: the port's workers draw the same
    Python ``random`` numbers (and numpy's, equal to the reference's);
    the reference's workers draw other Python numbers in each run."""
    ref_ds, port_ds = _pair(_Draws)
    runs = [_loaders(ref_ds, port_ds, batch_size=2, num_workers=2)
            for _ in range(2)]
    (ref1, port1), (ref2, port2) = runs
    assert all(_equal(a, b) for a, b in zip(port1, port2))
    assert all(np.array_equal(a[:, 1], b[:, 1]) for a, b in zip(port1, ref1))
    assert not all(np.array_equal(a[:, 0], b[:, 0])
                   for a, b in zip(ref1, ref2))


def test_failed_build_raises_where_the_reference_falls_back(monkeypatch,
                                                            tmp_path):
    """Without a compiler the port's workers raise; the reference's loader
    quietly runs its thread instead."""
    ref_ds, port_ds = _pair(_Samples)
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "library_path",
                        lambda: tmp_path / "libshm_channel-x.so")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="building shm_channel.cc failed"):
        list(pio.DataLoader(port_ds, places="cpu", num_workers=2))
    import paddle_tpu._native as rnative
    monkeypatch.setattr(rnative, "available", lambda: False)
    np.random.seed(0)
    assert len(list(rio.DataLoader(ref_ds, batch_size=4,
                                   num_workers=2))) == 6
    assert paddle.io.DataLoader is rio.DataLoader
