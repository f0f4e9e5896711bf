"""Cifar10 / Cifar100 (paddle_tpu/vision/datasets/cifar.py): the python
pickle archive when it is on disk, else the JAX package's deterministic
synthetic set (4096 train / 512 test images, seeds 3 / 5)."""
from __future__ import annotations

import os
import pickle
import tarfile

import numpy as np

from ...io import Dataset

__all__ = ["Cifar10", "Cifar100"]


class Cifar10(Dataset):
    NAME = "cifar-10-python.tar.gz"
    NUM_CLASSES = 10

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend=None):
        self.transform = transform
        path = data_file or os.path.expanduser(
            f"~/.cache/paddle_tpu/{self.NAME}")
        if os.path.exists(path):
            self._load_archive(path, mode)
        else:
            rng = np.random.RandomState(3 if mode == "train" else 5)
            n = 4096 if mode == "train" else 512
            self.labels = rng.randint(0, self.NUM_CLASSES, n).astype("int64")
            base = rng.randn(self.NUM_CLASSES, 3, 32, 32).astype("float32")
            self.images = (base[self.labels]
                           + rng.randn(n, 3, 32, 32).astype("float32") * 0.8)

    def _load_archive(self, path, mode):
        images, labels = [], []
        want = "data_batch" if mode == "train" else "test_batch"
        with tarfile.open(path) as tf:
            for m in tf.getmembers():
                if want in m.name:
                    d = pickle.load(tf.extractfile(m), encoding="bytes")
                    images.append(d[b"data"].reshape(-1, 3, 32, 32))
                    key = b"labels" if b"labels" in d else b"fine_labels"
                    labels.extend(d[key])
        self.images = (np.concatenate(images).astype("float32") / 255.0)
        self.labels = np.asarray(labels, dtype="int64")

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[idx]

    def __len__(self):
        return len(self.images)


class Cifar100(Cifar10):
    NAME = "cifar-100-python.tar.gz"
    NUM_CLASSES = 100
