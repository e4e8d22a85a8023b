"""``paddle.io`` (counterpart of ``paddle_tpu/io/__init__.py``): the
datasets, the samplers, collation and ``DataLoader``.

The samplers draw from numpy's global generator, as the reference's do:
``np.random.seed(s)`` gives the same batches in both packages.
Collation stacks samples into CPU tensors; ``DataLoader`` then moves
every tensor of a batch to its device (``places``: default CUDA, raising
without one; ``places="cpu"`` keeps it on the CPU) with one copy per
tensor, from pinned memory and without waiting for it on the card. A
batch that reaches the card has nothing left to copy in ``jit.TrainStep``.

``num_workers > 0`` with ``use_shared_memory`` (the default) forks
worker processes that collate batches and ship them through the port's
shared-memory ring (``io/_worker.py`` over ``_native.ShmChannel``, built
from ``csrc/shm_channel.cc`` with the host compiler at first use), in
the order ``num_workers=0`` gives; without ``use_shared_memory``, a
background thread collates up to ``prefetch_factor * num_workers``
batches ahead. Where the reference falls back to the thread when its
native library is unavailable, the port raises.
"""
from __future__ import annotations

import bisect
import itertools
import math
import queue
import random
import threading
import time

import numpy as np
import torch

from ..framework import resolve_device
from ._worker import WorkerInfo, WorkerPool, get_worker_info
from . import _worker

__all__ = ["BatchSampler", "ChainDataset", "ComposeDataset",
           "ConcatDataset", "DataLoader", "Dataset",
           "DistributedBatchSampler", "IterableDataset", "RandomSampler",
           "Sampler", "SequenceSampler", "Subset", "SubsetRandomSampler",
           "TensorDataset", "WeightedRandomSampler", "default_collate_fn",
           "default_convert_fn", "get_worker_info", "multiprocess_reader",
           "random_split"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    """Sample ``i`` of each dataset, their fields in one flat tuple."""

    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __len__(self):
        return min(len(d) for d in self.datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, tuple) else (item,))
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative_sizes = list(itertools.accumulate(
            len(d) for d in self.datasets))

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        i = bisect.bisect_right(self.cumulative_sizes, idx)
        off = idx - (self.cumulative_sizes[i - 1] if i > 0 else 0)
        return self.datasets[i][off]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    """Subsets of ``lengths`` (counts, or fractions summing to 1) over one
    permutation from numpy's global generator; ``generator`` is taken
    and, as in the reference, not read."""
    if all(isinstance(n, float) for n in lengths) and \
            abs(sum(lengths) - 1.0) < 1e-6:
        total = len(dataset)
        sizes = [int(math.floor(total * f)) for f in lengths]
        for i in range(total - sum(sizes)):
            sizes[i % len(sizes)] += 1
        lengths = sizes
    if sum(lengths) != len(dataset):
        raise ValueError("sum of lengths != dataset size")
    perm = np.random.permutation(len(dataset))
    out, off = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[off:off + n].tolist()))
        off += n
    return out


# ---------------------------------------------------------------- samplers --
class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    """A permutation (or, with ``replacement``, uniform draws) from numpy's
    global generator; ``generator`` is taken and, as in the reference,
    not read."""

    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, dtype=np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        return iter(np.random.choice(
            len(self.weights), self.num_samples, replace=self.replacement,
            p=p).tolist())

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    """``indices`` in an order from Python's ``random`` module."""

    def __init__(self, indices):
        super().__init__(indices)
        self.indices = list(indices)

    def __iter__(self):
        order = list(self.indices)
        random.shuffle(order)
        return iter(order)

    def __len__(self):
        return len(self.indices)


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Rank ``rank``'s share of the indices (padded to a multiple of
    ``num_replicas`` from the start), shuffled per ``set_epoch``. Either
    left out is read from the ``torch.distributed`` process group when
    one is up, else 1 replica and rank 0."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        dist = torch.distributed
        up = dist.is_available() and dist.is_initialized()
        if num_replicas is None:
            num_replicas = dist.get_world_size() if up else 1
        if rank is None:
            rank = dist.get_rank() if up else 0
        self.nranks = num_replicas
        self.local_rank = rank
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            indices = np.random.RandomState(self.epoch).permutation(
                n).tolist()
        else:
            indices = list(range(n))
        indices += indices[:(self.total_size - len(indices))]
        indices = indices[self.local_rank:self.total_size:self.nranks]
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch


# --------------------------------------------------------------- collation --
def default_collate_fn(batch):
    """Samples stacked field by field into CPU tensors: tensors and numpy
    arrays stacked, ints int64, floats float32, tuples and lists field by
    field (a tuple), dicts key by key."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch)
    if isinstance(sample, np.ndarray):
        return torch.from_numpy(np.stack(batch))
    if isinstance(sample, (int, np.integer)):
        return torch.from_numpy(np.asarray(batch, dtype=np.int64))
    if isinstance(sample, (float, np.floating)):
        return torch.from_numpy(np.asarray(batch, dtype=np.float32))
    if isinstance(sample, (list, tuple)):
        return tuple(default_collate_fn(list(items)) for items in zip(*batch))
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    return batch


def default_convert_fn(batch):
    """Each leaf (a numpy array or number) as a CPU tensor, nothing
    stacked."""
    if isinstance(batch, (list, tuple)):
        return type(batch)(default_convert_fn(b) for b in batch)
    if isinstance(batch, dict):
        return {k: default_convert_fn(v) for k, v in batch.items()}
    if isinstance(batch, (np.ndarray, np.generic, int, float)):
        return torch.as_tensor(np.asarray(batch))
    return batch


def _to_device(obj, device):
    """Every tensor of a collated batch on ``device``: one copy each, from
    pinned memory and not waited for when it goes to the card."""
    if isinstance(obj, torch.Tensor):
        if obj.device == device:
            return obj
        if device.type == "cuda" and obj.device.type == "cpu":
            obj = obj if obj.is_pinned() else obj.pin_memory()
            return obj.to(device, non_blocking=True)
        return obj.to(device)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_device(o, device) for o in obj)
    if isinstance(obj, dict):
        return {k: _to_device(v, device) for k, v in obj.items()}
    return obj


class DataLoader:
    """Batches of ``dataset`` from ``batch_sampler`` (else a
    ``BatchSampler`` over ``batch_size`` / ``shuffle`` / ``drop_last``),
    collated by ``collate_fn`` and moved to ``places`` (a device or place;
    the first of a list).

    With ``num_workers > 0`` and ``use_shared_memory``, forked workers
    collate (``collate_fn``, else ``_worker.numpy_collate``) and the
    batches come back in the sampler's order (an ``IterableDataset``'s in
    the order the workers finish them); ``worker_init_fn(worker_id)``
    runs first in each worker. The parent draws the workers' base seed
    from numpy's global generator after the sampler, as the reference
    does. Without ``use_shared_memory`` a thread prefetches
    ``prefetch_factor * num_workers`` batches. ``host_s`` sums the
    parent's seconds per part of the worker path ("pop", "unpickle",
    "to_device": the pinned copy) and counts its "batches".
    ``feed_list``, ``return_list``, ``use_buffer_reader``, ``timeout``
    and ``persistent_workers`` are taken and, as in the reference, not
    read."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        if isinstance(places, (list, tuple)):
            places = places[0] if places else None
        self.device = resolve_device(places)
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self._user_collate = collate_fn
        self.num_workers = num_workers
        self.use_shared_memory = use_shared_memory
        self.worker_init_fn = worker_init_fn
        self.prefetch_factor = prefetch_factor
        self._iterable_mode = isinstance(dataset, IterableDataset)
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.host_s = {}
        if self._iterable_mode:
            self.batch_sampler = None
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)

    def _batches(self):
        if not self._iterable_mode:
            for idxs in self.batch_sampler:
                yield self.collate_fn([self.dataset[i] for i in idxs])
            return
        # one shard of one: a dataset that shards by get_worker_info()
        # gives the same stream here as across the workers
        prev = _worker._WORKER_INFO
        _worker._WORKER_INFO = WorkerInfo(id=0, num_workers=1, seed=0,
                                          dataset=self.dataset)
        try:
            batch = []
            for item in self.dataset:
                batch.append(item)
                if len(batch) == self.batch_size:
                    yield self.collate_fn(batch)
                    batch = []
            if batch and not self.drop_last:
                yield self.collate_fn(batch)
        finally:
            _worker._WORKER_INFO = prev

    def _worker_batches(self):
        from .. import _native
        _native.load()    # raises when the library cannot be built
        if self._iterable_mode:
            batch_indices = None
            bs, dl = self.batch_size, self.drop_last
        else:
            batch_indices = list(self.batch_sampler)
            bs, dl = 1, False
        yield from WorkerPool(
            self.dataset, batch_indices, self.num_workers,
            self._user_collate, self.worker_init_fn,
            seed=int(np.random.randint(0, 2 ** 31)), batch_size=bs,
            drop_last=dl, host_s=self.host_s)

    def _thread_batches(self):
        q = queue.Queue(maxsize=self.num_workers * self.prefetch_factor)
        end = object()
        failed = []

        def producer():
            try:
                for b in self._batches():
                    q.put(b)
            except Exception as e:    # re-raised in the consumer
                failed.append(e)
            finally:
                q.put(end)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is end:
                break
            yield item
        t.join()
        if failed:
            raise failed[0]

    def __iter__(self):
        if self.num_workers <= 0:
            batches = self._batches()
        elif self.use_shared_memory:
            batches = self._worker_batches()
        else:
            batches = self._thread_batches()
        s = self.host_s
        for batch in batches:
            t0 = time.perf_counter()
            out = _to_device(batch, self.device)
            s["to_device"] = s.get("to_device", 0.0) + \
                time.perf_counter() - t0
            yield out


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    """The reference's legacy reader composer: the readers' samples
    interleaved round robin in-process (``use_pipe`` and ``queue_size``
    taken and not read, as there)."""
    def composed():
        iters = [r() for r in readers]
        alive = [True] * len(iters)
        while any(alive):
            for i, it in enumerate(iters):
                if not alive[i]:
                    continue
                try:
                    yield next(it)
                except StopIteration:
                    alive[i] = False
    return composed
