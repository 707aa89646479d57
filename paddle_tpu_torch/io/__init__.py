"""Datasets, samplers and the self-healing DataLoader — counterpart of
``paddle_tpu/io``."""

from .dataset import (ChainDataset, ComposeDataset, ConcatDataset, Dataset,
                      IterableDataset, Subset, TensorDataset, random_split)
from .sampler import (BatchSampler, DistributedBatchSampler, RandomSampler,
                      Sampler, SequenceSampler, SubsetRandomSampler,
                      WeightedRandomSampler)
from .dataloader import (DataLoader, WorkerInfo, default_collate_fn,
                         default_convert_fn, get_worker_info,
                         prefetch_to_device)

__all__ = [
    "Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
    "ChainDataset", "ConcatDataset", "Subset", "random_split",
    "Sampler", "SequenceSampler", "RandomSampler", "WeightedRandomSampler",
    "SubsetRandomSampler", "BatchSampler", "DistributedBatchSampler",
    "DataLoader", "WorkerInfo", "get_worker_info", "default_collate_fn",
    "default_convert_fn", "prefetch_to_device",
]
