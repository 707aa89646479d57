"""Dataset types — counterpart of ``paddle_tpu/io/dataset.py`` (Dataset,
IterableDataset, TensorDataset, ComposeDataset, ChainDataset, Subset,
ConcatDataset, random_split), the same indexing and the same draws.

Items are host (numpy) values: the DataLoader's forked workers touch no
device, and the collate step turns a batch into CPU torch tensors.
"""

from __future__ import annotations

import bisect
from typing import Iterable, List, Sequence

import numpy as np
import torch

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "ConcatDataset", "Subset", "random_split"]


class Dataset:
    """Map-style dataset: implement ``__getitem__`` and ``__len__``."""

    def __getitem__(self, idx):
        raise NotImplementedError(
            f"{type(self).__name__} must implement __getitem__")

    def __len__(self):
        raise NotImplementedError(
            f"{type(self).__name__} must implement __len__")


class IterableDataset(Dataset):
    """Stream-style dataset: implement ``__iter__``; workers split the stream
    via ``get_worker_info()`` (reference parity)."""

    def __iter__(self):
        raise NotImplementedError(
            f"{type(self).__name__} must implement __iter__")

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        # TypeError, not RuntimeError: list()/length_hint probe __len__ and
        # only swallow TypeError
        raise TypeError("IterableDataset has no static length")


class TensorDataset(Dataset):
    """Wrap equal-first-dim tensors/arrays (copied to host numpy arrays;
    bf16 as float32); item i is the tuple of row i."""

    def __init__(self, tensors: Sequence):
        from ..framework.io import to_host
        if not tensors:
            raise ValueError("TensorDataset needs at least one tensor")
        arrays = []
        for t in tensors:
            arrays.append(to_host(t) if isinstance(t, torch.Tensor)
                          else np.asarray(t))
        n = arrays[0].shape[0]
        for a in arrays:
            if a.shape[0] != n:
                raise ValueError("TensorDataset tensors must share dim 0 "
                                 f"({a.shape[0]} != {n})")
        self.tensors = arrays

    def __getitem__(self, idx):
        return tuple(a[idx] for a in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    """Zip several map-style datasets; item i concatenates their fields."""

    def __init__(self, datasets: Sequence[Dataset]):
        self.datasets = list(datasets)
        if not self.datasets:
            raise ValueError("ComposeDataset needs at least one dataset")
        lens = [len(d) for d in self.datasets]
        if len(set(lens)) != 1:
            raise ValueError(f"ComposeDataset lengths differ: {lens}")

    def __len__(self):
        return len(self.datasets[0])

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, (tuple, list)) else [item])
        return tuple(out)


class ChainDataset(IterableDataset):
    """Concatenate iterable datasets into one stream."""

    def __init__(self, datasets: Sequence[IterableDataset]):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    """Concatenate map-style datasets end to end."""

    def __init__(self, datasets: Iterable[Dataset]):
        self.datasets = list(datasets)
        if not self.datasets:
            raise ValueError("ConcatDataset needs at least one dataset")
        self.cumulative_sizes = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        if not 0 <= idx < len(self):
            raise IndexError(idx)
        ds = bisect.bisect_right(self.cumulative_sizes, idx)
        prev = 0 if ds == 0 else self.cumulative_sizes[ds - 1]
        return self.datasets[ds][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset: Dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset: Dataset, lengths: Sequence,
                 generator=None) -> List[Subset]:
    """Split by lengths (ints) or fractions summing to 1 (reference parity).
    ``generator`` is a ``numpy.random.Generator`` (pass a seeded one for a
    reproducible split: the same seed gives the JAX package's split)."""
    n = len(dataset)
    ls = list(lengths)
    if ls and all(isinstance(x, float) for x in ls):
        if abs(sum(ls) - 1.0) > 1e-6:
            raise ValueError("random_split fractions must sum to 1")
        counts = [int(np.floor(n * f)) for f in ls]
        for i in range(n - sum(counts)):
            counts[i % len(counts)] += 1
        ls = counts
    if sum(ls) != n:
        raise ValueError(f"random_split lengths sum {sum(ls)} != dataset {n}")
    rng = generator if generator is not None else np.random.default_rng()
    perm = rng.permutation(n).tolist()
    out, ofs = [], 0
    for l in ls:
        out.append(Subset(dataset, perm[ofs:ofs + l]))
        ofs += l
    return out
