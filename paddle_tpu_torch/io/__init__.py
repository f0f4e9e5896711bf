"""Datasets, samplers, the DataLoader and the InMemory / Queue datasets
of ``fleet_dataset.py`` (paddle_tpu/io)."""
from .dataset import (ChainDataset, ComposeDataset, ConcatDataset, Dataset,  # noqa: F401
                      IterableDataset, Subset, TensorDataset, random_split)
from .sampler import (BatchSampler, DistributedBatchSampler, RandomSampler,  # noqa: F401
                      Sampler, SequenceSampler, WeightedRandomSampler)
from .dataloader import DataLoader, default_collate_fn  # noqa: F401
from .fleet_dataset import (DatasetBase, DatasetFactory,  # noqa: F401
                            InMemoryDataset, QueueDataset)

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "ConcatDataset", "Subset", "random_split",
           "Sampler", "SequenceSampler", "RandomSampler",
           "WeightedRandomSampler", "BatchSampler", "DistributedBatchSampler",
           "DataLoader", "default_collate_fn", "DatasetBase",
           "InMemoryDataset", "QueueDataset", "DatasetFactory"]
