"""The DataLoader's worker processes (counterpart of
``paddle_tpu/io/_worker.py``): forked workers collate batches and ship
them through the shared-memory ring (``_native.ShmChannel``, built from
``csrc/shm_channel.cc``), not a pipe; the parent restores their order.

Workers stay on the CPU: they touch no CUDA (the parent may hold a CUDA
context and captured graphs when it forks), set torch's intra-op threads
to 1 before any torch op (an OpenMP pool inherited across ``fork`` can
hang) and numpy's OpenBLAS threads to 1 (N workers of one BLAS thread a
core each, not N pools of them: ``transforms.Resize``'s products ran ten
times slower in 6 workers than in the parent before), and leave through
``os._exit`` (``multiprocessing``'s fork start), so no CUDA tensor's
deleter runs in a child. Batches cross as numpy
trees; the parent turns them into CPU tensors and ``DataLoader`` moves
them to its device.

Where the port differs from the reference, each pinned by
``tests/test_torch_io_workers.py``:

- ``numpy_collate`` stacks ``torch.Tensor`` samples (sent as one numpy
  array), as ``default_collate_fn`` does with ``num_workers=0``; the
  reference's returns such a batch as a list of tensors.
- each worker seeds Python's ``random`` as well as numpy with ``seed +
  worker_id``, so random augmentation in workers repeats from one seed;
  the reference seeds numpy only, and Python reseeds ``random`` from the
  OS in every forked child.
"""
from __future__ import annotations

import ctypes
import multiprocessing as mp
import os
import pickle
import random
import time
import traceback
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

_WORKER_INFO = None


@dataclass
class WorkerInfo:
    id: int
    num_workers: int
    seed: int
    dataset: object


def get_worker_info() -> Optional[WorkerInfo]:
    """This worker's id, the worker count, its seed and its dataset
    inside a worker process (and, as ``WorkerInfo(0, 1, 0, dataset)``,
    while a loader iterates an ``IterableDataset`` in-process); None
    elsewhere."""
    return _WORKER_INFO


def numpy_collate(batch):
    """Samples stacked field by field into numpy arrays (no device):
    arrays and tensors stacked, ints int64, floats float32, tuples and
    lists field by field (a tuple), dicts key by key."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch).numpy()
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, np.integer)):
        return np.asarray(batch, dtype=np.int64)
    if isinstance(sample, (float, np.floating)):
        return np.asarray(batch, dtype=np.float32)
    if isinstance(sample, (list, tuple)):
        return tuple(numpy_collate(list(items)) for items in zip(*batch))
    if isinstance(sample, dict):
        return {k: numpy_collate([b[k] for b in batch]) for k in sample}
    return batch


def _one_blas_thread():
    """numpy's OpenBLAS (the library mapped into this process) to one
    thread, where it exports a setter; nothing otherwise."""
    with open("/proc/self/maps") as f:
        libs = {line.split()[-1] for line in f
                if "openblas" in line.lower() and ".so" in line}
    for path in libs:
        lib = ctypes.CDLL(path)
        for name in ("scipy_openblas_set_num_threads64_",
                     "scipy_openblas_set_num_threads",
                     "openblas_set_num_threads64_",
                     "openblas_set_num_threads"):
            setter = getattr(lib, name, None)
            if setter is not None:
                setter.argtypes, setter.restype = [ctypes.c_int], None
                setter(1)
                break


def worker_loop(dataset, batch_indices, worker_id, num_workers, chan_name,
                collate_fn, worker_init_fn, seed, batch_size, drop_last):
    """Entry point of one worker process.

    ``batch_indices`` is None for an ``IterableDataset`` (each worker
    streams its own shard through ``get_worker_info``), else the list of
    every batch's indices: worker w makes batches w, w + N, w + 2N, ...
    (round robin, so the parent can restore the order). Each message is
    ("b", batch index or None, batch), ("e", worker id, traceback) or,
    last, ("d", worker id, None)."""
    global _WORKER_INFO
    from .._native import ShmChannel

    torch.set_num_threads(1)
    _one_blas_thread()
    _WORKER_INFO = WorkerInfo(id=worker_id, num_workers=num_workers,
                              seed=seed + worker_id, dataset=dataset)
    np.random.seed(seed + worker_id)
    random.seed(seed + worker_id)
    ch = ShmChannel(chan_name)
    collate = collate_fn or numpy_collate
    try:
        if worker_init_fn is not None:
            worker_init_fn(worker_id)
        if batch_indices is None:
            buf = []
            for item in iter(dataset):
                buf.append(item)
                if len(buf) == batch_size:
                    ch.push_obj(("b", None, collate(buf)))
                    buf = []
            if buf and not drop_last:
                ch.push_obj(("b", None, collate(buf)))
        else:
            for i in range(worker_id, len(batch_indices), num_workers):
                data = [dataset[j] for j in batch_indices[i]]
                ch.push_obj(("b", i, collate(data)))
    except Exception:      # reported to the parent, which raises it
        _report(ch, ("e", worker_id, traceback.format_exc()))
    finally:
        _report(ch, ("d", worker_id, None))
        ch.close()


def _report(ch, msg):
    try:
        ch.push_obj(msg)
    except RuntimeError:   # the parent closed the channel: it stopped early
        pass


def np_tree_to_tensor(obj):
    """A numpy-collated tree (from a worker) with every array a CPU
    tensor sharing its memory."""
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(obj)
    if isinstance(obj, tuple):
        return tuple(np_tree_to_tensor(o) for o in obj)
    if isinstance(obj, list):
        return [np_tree_to_tensor(o) for o in obj]
    if isinstance(obj, dict):
        return {k: np_tree_to_tensor(v) for k, v in obj.items()}
    return obj


class WorkerPool:
    """Parent side: forks the workers, restores the batch order, turns
    numpy trees into CPU tensors. ``host_s`` sums the parent's seconds
    per part ("pop": waiting for and copying a message out of the ring;
    "unpickle") over ``host_s["batches"]`` batches."""

    def __init__(self, dataset, batch_indices, num_workers, collate_fn,
                 worker_init_fn, seed=0, batch_size=1, drop_last=False,
                 capacity_bytes=None, host_s=None):
        from .._native import ShmChannel
        from ..framework import flags

        if capacity_bytes is None:
            capacity_bytes = int(
                flags.flag_value("shm_channel_capacity_mb")) << 20
        self.num_workers = num_workers
        self.ordered = batch_indices is not None
        self.total = len(batch_indices) if self.ordered else None
        self.host_s = host_s if host_s is not None else {}
        name = f"/pdt_dl_{os.getpid()}_{id(self)}"
        self.chan = ShmChannel(name, capacity_bytes, create=True)
        ctx = mp.get_context("fork")
        self.procs = [
            ctx.Process(
                target=worker_loop,
                args=(dataset, batch_indices, w, num_workers, name,
                      collate_fn, worker_init_fn, seed, batch_size,
                      drop_last),
                daemon=True)
            for w in range(num_workers)
        ]
        for p in self.procs:
            p.start()

    def _pop(self):
        t0 = time.perf_counter()
        data = self.chan.pop(timeout_ms=300000)
        t1 = time.perf_counter()
        msg = None if data is None else pickle.loads(data)
        s = self.host_s
        s["pop"] = s.get("pop", 0.0) + t1 - t0
        s["unpickle"] = s.get("unpickle", 0.0) + time.perf_counter() - t1
        return msg

    def _out(self, payload):
        self.host_s["batches"] = self.host_s.get("batches", 0) + 1
        return np_tree_to_tensor(payload)

    def __iter__(self):
        done = 0
        pending = {}
        next_idx = 0
        try:
            while done < self.num_workers:
                msg = self._pop()
                if msg is None:
                    break
                kind, idx, payload = msg
                if kind == "d":
                    done += 1
                    continue
                if kind == "e":
                    raise RuntimeError(
                        f"DataLoader worker {idx} failed:\n{payload}")
                if not self.ordered:
                    yield self._out(payload)
                    continue
                pending[idx] = payload
                while next_idx in pending:
                    yield self._out(pending.pop(next_idx))
                    next_idx += 1
            # batches that arrived with the final "d"
            while self.ordered and next_idx in pending:
                yield self._out(pending.pop(next_idx))
                next_idx += 1
            if self.ordered and next_idx < self.total:
                raise RuntimeError(
                    f"DataLoader lost batches: got {next_idx} of "
                    f"{self.total} (a worker died without reporting)")
        finally:
            self.shutdown()

    def shutdown(self):
        self.chan.close_write()
        for p in self.procs:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        self.chan.close()
