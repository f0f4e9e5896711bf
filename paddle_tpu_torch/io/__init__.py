"""Datasets, samplers and the DataLoader (paddle_tpu/io).

``fleet_dataset.py`` (the InMemory / Queue datasets) waits for the
parameter-server tier, ROADMAP Queue 1 item 8."""
from .dataset import (ChainDataset, ComposeDataset, ConcatDataset, Dataset,  # noqa: F401
                      IterableDataset, Subset, TensorDataset, random_split)
from .sampler import (BatchSampler, DistributedBatchSampler, RandomSampler,  # noqa: F401
                      Sampler, SequenceSampler, WeightedRandomSampler)
from .dataloader import DataLoader, default_collate_fn  # noqa: F401

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "ConcatDataset", "Subset", "random_split",
           "Sampler", "SequenceSampler", "RandomSampler",
           "WeightedRandomSampler", "BatchSampler", "DistributedBatchSampler",
           "DataLoader", "default_collate_fn"]
