"""Dataset containers (paddle_tpu/io/dataset.py), copied: numpy only, so
both packages split and index the same way from the same seed."""
from __future__ import annotations

import bisect

import numpy as np

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "ConcatDataset", "Subset", "random_split"]


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
        lens = {len(t) for t in tensors}
        if len(lens) != 1:
            raise ValueError("tensors must share dim 0")
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return len(self.tensors[0])


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __getitem__(self, idx):
        out = []
        for ds in self.datasets:
            sample = ds[idx]
            out.extend(sample if isinstance(sample, (list, tuple)) else [sample])
        return tuple(out)

    def __len__(self):
        return min(len(ds) for ds in self.datasets)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for ds in self.datasets:
            yield from ds


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cum = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cum[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        i = bisect.bisect_right(self.cum, idx)
        prev = self.cum[i - 1] if i > 0 else 0
        return self.datasets[i][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    if sum(lengths) != len(dataset):
        raise ValueError("lengths must sum to dataset size")
    perm = np.random.permutation(len(dataset))
    out, start = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[start:start + n].tolist()))
        start += n
    return out
