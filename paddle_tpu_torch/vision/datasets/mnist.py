"""MNIST / FashionMNIST (paddle_tpu/vision/datasets/mnist.py).

The idx-ubyte files are read from ``image_path`` / ``label_path`` or
``~/.cache/paddle_tpu/{mnist,fashion-mnist}``; where they are absent a
deterministic synthetic digit set stands in (8192 train / 1024 test
digits, seeds 7 / 11: the JAX package's arrays). ``download`` is
accepted and nothing is downloaded.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ...io import Dataset

__all__ = ["MNIST", "FashionMNIST"]


def _synthetic_digits(n, seed):
    """Digits drawn as coarse 7-seg-style glyphs + noise: classifiable but
    non-trivial."""
    rng = np.random.RandomState(seed)
    images = np.zeros((n, 28, 28), dtype="float32")
    labels = rng.randint(0, 10, n).astype("int64")
    segs = {  # (r0, r1, c0, c1) strokes per digit
        0: [(4, 24, 6, 9), (4, 24, 19, 22), (4, 7, 6, 22), (21, 24, 6, 22)],
        1: [(4, 24, 13, 16)],
        2: [(4, 7, 6, 22), (4, 14, 19, 22), (11, 14, 6, 22), (14, 24, 6, 9),
            (21, 24, 6, 22)],
        3: [(4, 7, 6, 22), (11, 14, 6, 22), (21, 24, 6, 22), (4, 24, 19, 22)],
        4: [(4, 14, 6, 9), (11, 14, 6, 22), (4, 24, 19, 22)],
        5: [(4, 7, 6, 22), (4, 14, 6, 9), (11, 14, 6, 22), (14, 24, 19, 22),
            (21, 24, 6, 22)],
        6: [(4, 24, 6, 9), (11, 14, 6, 22), (14, 24, 19, 22), (21, 24, 6, 22)],
        7: [(4, 7, 6, 22), (4, 24, 19, 22)],
        8: [(4, 24, 6, 9), (4, 24, 19, 22), (4, 7, 6, 22), (11, 14, 6, 22),
            (21, 24, 6, 22)],
        9: [(4, 14, 6, 9), (4, 7, 6, 22), (11, 14, 6, 22), (4, 24, 19, 22)],
    }
    for i in range(n):
        for (r0, r1, c0, c1) in segs[int(labels[i])]:
            images[i, r0:r1, c0:c1] = 1.0
        # jitter: shift and noise
        sh, sw = rng.randint(-2, 3, 2)
        images[i] = np.roll(images[i], (sh, sw), axis=(0, 1))
        images[i] += rng.randn(28, 28).astype("float32") * 0.15
    return np.clip(images, 0.0, 1.0), labels


def _read_idx(path):
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        nd = magic & 0xFF
        dims = [struct.unpack(">I", f.read(4))[0] for _ in range(nd)]
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(dims)


class MNIST(Dataset):
    NAME = "mnist"

    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend=None):
        self.mode = mode
        self.transform = transform
        images = labels = None
        cache = os.path.expanduser(f"~/.cache/paddle_tpu/{self.NAME}")
        prefix = "train" if mode == "train" else "t10k"
        img = image_path or os.path.join(cache, f"{prefix}-images-idx3-ubyte.gz")
        lab = label_path or os.path.join(cache, f"{prefix}-labels-idx1-ubyte.gz")
        if os.path.exists(img) and os.path.exists(lab):
            images = _read_idx(img).astype("float32") / 255.0
            labels = _read_idx(lab).astype("int64")
        else:
            n = 8192 if mode == "train" else 1024
            images, labels = _synthetic_digits(n, seed=7 if mode == "train" else 11)
        self.images = images[:, None, :, :]  # NCHW
        self.labels = labels

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[idx]

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    NAME = "fashion-mnist"
