"""Samplers — counterpart of ``paddle_tpu/io/sampler.py`` (Sampler,
SequenceSampler, RandomSampler, SubsetRandomSampler, WeightedRandomSampler,
BatchSampler, DistributedBatchSampler), the same orders and draws: a
``generator`` is a ``numpy.random.Generator``, as in the reference. The
distributed sampler shards by rank like the reference (padding to even
length, per-epoch shuffle seed), taking ``num_replicas`` / ``rank`` from
its arguments or, when they are left out, from ``torch.distributed``
(1 and 0 when it is not initialised).
"""

from __future__ import annotations

import math
from typing import Iterator, List, Optional

import numpy as np

__all__ = ["Sampler", "SequenceSampler", "RandomSampler",
           "WeightedRandomSampler", "BatchSampler", "DistributedBatchSampler",
           "SubsetRandomSampler"]


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self) -> Iterator[int]:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))

    def __len__(self):
        return len(self.data_source)


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement: bool = False,
                 num_samples: Optional[int] = None, generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator
        if not replacement and num_samples is not None and \
                num_samples > len(data_source):
            raise ValueError("num_samples > dataset size without replacement")

    @property
    def num_samples(self) -> int:
        return self._num_samples if self._num_samples is not None \
            else len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        rng = self.generator or np.random.default_rng()
        if self.replacement:
            yield from rng.integers(0, n, self.num_samples).tolist()
        else:
            yield from rng.permutation(n)[: self.num_samples].tolist()

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    def __init__(self, indices, generator=None):
        super().__init__(None)
        self.indices = list(indices)
        self.generator = generator

    def __iter__(self):
        rng = self.generator or np.random.default_rng()
        for i in rng.permutation(len(self.indices)):
            yield self.indices[i]

    def __len__(self):
        return len(self.indices)


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples: int, replacement: bool = True):
        super().__init__(None)
        self.weights = np.asarray(weights, np.float64)
        if (self.weights < 0).any():
            raise ValueError("weights must be non-negative")
        self.num_samples = int(num_samples)
        self.replacement = replacement
        if not replacement and num_samples > len(self.weights):
            raise ValueError("num_samples > #weights without replacement")

    def __iter__(self):
        p = self.weights / self.weights.sum()
        rng = np.random.default_rng()
        idx = rng.choice(len(self.weights), self.num_samples,
                         replace=self.replacement, p=p)
        yield from idx.tolist()

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler: Optional[Sampler] = None,
                 shuffle: bool = False, batch_size: int = 1,
                 drop_last: bool = False):
        super().__init__(dataset)
        if sampler is not None:
            if dataset is not None:
                raise ValueError("BatchSampler: pass dataset OR sampler")
            self.sampler = sampler
        elif dataset is not None:
            self.sampler = RandomSampler(dataset) if shuffle \
                else SequenceSampler(dataset)
        else:
            raise ValueError("BatchSampler needs a dataset or a sampler")
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        self.batch_size = int(batch_size)
        self.drop_last = bool(drop_last)

    def __iter__(self):
        batch: List[int] = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last \
            else (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Shard batches by data-parallel rank (ref: DistributedBatchSampler —
    pad to a rank-divisible length, per-epoch seeded shuffle, ``set_epoch``)."""

    def __init__(self, dataset, batch_size: int, num_replicas: Optional[int] = None,
                 rank: Optional[int] = None, shuffle: bool = False,
                 drop_last: bool = False):
        self.dataset = dataset
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        self.batch_size = int(batch_size)
        self.drop_last = bool(drop_last)
        self.shuffle = bool(shuffle)
        if num_replicas is None or rank is None:
            import torch.distributed as dist
            live = dist.is_available() and dist.is_initialized()
            if num_replicas is None:
                num_replicas = dist.get_world_size() if live else 1
            if rank is None:
                rank = dist.get_rank() if live else 0
        self.nranks = int(num_replicas)
        self.local_rank = int(rank)
        if not 0 <= self.local_rank < self.nranks:
            raise ValueError(f"rank {rank} out of range for {num_replicas}")
        self.epoch = 0
        n = len(dataset)
        self.num_samples = int(math.ceil(n / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def set_epoch(self, epoch: int):
        self.epoch = int(epoch)

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng(self.epoch)
            indices = rng.permutation(n).tolist()
        else:
            indices = list(range(n))
        # pad so every rank sees the same number of samples
        indices += indices[: self.total_size - n]
        local = indices[self.local_rank:self.total_size:self.nranks]
        batch: List[int] = []
        for idx in local:
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
