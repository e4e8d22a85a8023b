"""``paddle.io`` (counterpart of ``paddle_tpu/io/__init__.py``): the
datasets, the samplers, collation and ``DataLoader``.

The samplers draw from numpy's global generator, as the reference's do:
``np.random.seed(s)`` gives the same batches in both packages.
Collation stacks samples into CPU tensors; ``DataLoader`` then moves
every tensor of a batch to its device (``places``: default CUDA, raising
without one; ``places="cpu"`` keeps it on the CPU) with one copy per
tensor, from pinned memory and without waiting for it on the card. A
batch that reaches the card has nothing left to copy in ``jit.TrainStep``.

``num_workers > 0`` raises ``NotImplementedError``: the reference's
worker processes (``io/_worker.py``) are not ported, and the loader
never runs them in-process instead.
"""
from __future__ import annotations

import bisect
import itertools
import math
import random

import numpy as np
import torch

from ..framework import resolve_device

__all__ = ["BatchSampler", "ChainDataset", "ComposeDataset",
           "ConcatDataset", "DataLoader", "Dataset",
           "DistributedBatchSampler", "IterableDataset", "RandomSampler",
           "Sampler", "SequenceSampler", "Subset", "SubsetRandomSampler",
           "TensorDataset", "WeightedRandomSampler", "default_collate_fn",
           "default_convert_fn", "random_split"]


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
    the first of a list). ``feed_list``, ``return_list``,
    ``use_buffer_reader``, ``prefetch_factor``, ``use_shared_memory``,
    ``timeout``, ``worker_init_fn`` and ``persistent_workers`` are taken
    and not read: with ``num_workers=0``, the reference reads none of
    them either."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        if num_workers > 0:
            raise NotImplementedError(
                "DataLoader: num_workers > 0 needs the worker processes "
                "(io/_worker.py), which are not ported; pass "
                "num_workers=0")
        if isinstance(places, (list, tuple)):
            places = places[0] if places else None
        self.device = resolve_device(places)
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self._iterable_mode = isinstance(dataset, IterableDataset)
        self.batch_size = batch_size
        self.drop_last = drop_last
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
        batch = []
        for item in self.dataset:
            batch.append(item)
            if len(batch) == self.batch_size:
                yield self.collate_fn(batch)
                batch = []
        if batch and not self.drop_last:
            yield self.collate_fn(batch)

    def __iter__(self):
        for batch in self._batches():
            yield _to_device(batch, self.device)
