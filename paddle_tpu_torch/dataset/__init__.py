"""paddle.dataset — fluid-era reader-creator dataset modules
(paddle_tpu/dataset/__init__.py).

Analog of reference python/paddle/dataset/ (mnist.py, cifar.py,
uci_housing.py, imdb.py, imikolov.py, ...): each submodule exposes
train()/test() *reader creators* (zero-arg callables yielding samples)
over the same data the 2.x Dataset classes serve (vision/datasets,
text/datasets — local files when present, deterministic synthetic data in
zero-egress environments).

The port's ``mnist``, ``cifar`` and ``flowers`` read its ``vision/
datasets``; ``uci_housing``, ``imdb``, ``imikolov`` and ``movielens``
read text datasets the port does not have yet, and their creators raise
NotImplementedError naming ROADMAP Queue 1 item 9.
"""
from __future__ import annotations

import sys
import types

import numpy as np

__all__ = ["mnist", "cifar", "uci_housing", "imdb", "imikolov",
           "flowers", "movielens"]


def _reader_from(dataset_factory, transform=None):
    def reader():
        ds = dataset_factory()
        for i in range(len(ds)):
            item = ds[i]
            yield transform(item) if transform is not None else item
    return reader


def _module(name):
    m = types.ModuleType(f"{__name__}.{name}")
    sys.modules[m.__name__] = m
    return m


# -- mnist: samples are (flat float32[784] in [-1,1], int label) ------------
mnist = _module("mnist")


def _mnist_reader(mode):
    from ..vision.datasets import MNIST

    def tf(item):
        img, lab = item
        flat = (np.asarray(img, np.float32).reshape(-1) * 2.0) - 1.0
        return flat, int(np.asarray(lab).reshape(-1)[0])
    return _reader_from(lambda: MNIST(mode=mode), tf)


mnist.train = lambda: _mnist_reader("train")
mnist.test = lambda: _mnist_reader("test")


# -- cifar: (flat float32[3072] in [0,1], int label) ------------------------
cifar = _module("cifar")


def _cifar_reader(mode, cls):
    def tf(item):
        img, lab = item
        return (np.asarray(img, np.float32).reshape(-1),
                int(np.asarray(lab).reshape(-1)[0]))

    def make():
        from ..vision.datasets import Cifar10, Cifar100
        ds_cls = Cifar10 if cls == 10 else Cifar100
        return ds_cls(mode=mode)
    return _reader_from(make, tf)


cifar.train10 = lambda: _cifar_reader("train", 10)
cifar.test10 = lambda: _cifar_reader("test", 10)
cifar.train100 = lambda: _cifar_reader("train", 100)
cifar.test100 = lambda: _cifar_reader("test", 100)


# -- uci_housing, imdb, imikolov, movielens: over text datasets of
# -- ROADMAP Queue 1 item 9 ---------------------------------------------------
def _unported(name):
    def creator(*args, **kwargs):
        raise NotImplementedError(
            f"paddle.dataset.{name} reads text/datasets' {name} dataset, "
            f"which the port does not have yet (ROADMAP Queue 1 item 9)")
    return creator


uci_housing = _module("uci_housing")
uci_housing.train = uci_housing.test = _unported("uci_housing")
imdb = _module("imdb")
imdb.train = imdb.test = imdb.word_dict = _unported("imdb")
imikolov = _module("imikolov")
imikolov.train = imikolov.test = imikolov.build_dict = \
    _unported("imikolov")
movielens = _module("movielens")
movielens.train = movielens.test = _unported("movielens")


# -- flowers ----------------------------------------------------------------
flowers = _module("flowers")


def _flowers_reader(mode, **files):
    from ..vision.datasets import Flowers

    def tf(item):
        img, lab = item
        return (np.asarray(img, np.float32),
                int(np.asarray(lab).reshape(-1)[0]))
    return _reader_from(lambda: Flowers(mode=mode, **files), tf)


flowers.train = lambda **files: _flowers_reader("train", **files)
flowers.test = lambda **files: _flowers_reader("test", **files)
flowers.valid = lambda **files: _flowers_reader("valid", **files)


# -- streaming: online-learning completion-record stream (a REAL
# -- submodule, not a fluid reader shim — see docs/online_learning.md) ------
from .streaming import StreamingDataset  # noqa: E402

__all__ += ["streaming", "StreamingDataset"]
