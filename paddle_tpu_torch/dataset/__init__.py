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
its ``text/datasets``. Combine them with ``paddle.reader``'s decorators
and ``paddle.batch``.
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


# -- uci_housing: (float32[13], float32[1]) ---------------------------------
uci_housing = _module("uci_housing")


def _uci_reader(mode):
    from ..text.datasets import UCIHousing
    return _reader_from(lambda: UCIHousing(mode=mode))


uci_housing.train = lambda: _uci_reader("train")
uci_housing.test = lambda: _uci_reader("test")


# -- imdb: (word-id list, 0/1 label) ----------------------------------------
imdb = _module("imdb")


def _imdb_reader(mode):
    from ..text.datasets import Imdb

    def tf(item):
        ids, lab = item
        return list(np.asarray(ids).reshape(-1)), int(np.asarray(lab))
    return _reader_from(lambda: Imdb(mode=mode), tf)


imdb.train = lambda word_dict=None: _imdb_reader("train")
imdb.test = lambda word_dict=None: _imdb_reader("test")
imdb.word_dict = lambda: {i: i for i in range(5149)}


# -- imikolov: n-gram tuples ------------------------------------------------
imikolov = _module("imikolov")


def _imikolov_reader(mode, n, data_file):
    from ..text.datasets import Imikolov

    def tf(item):
        return tuple(int(x) for x in np.asarray(item).reshape(-1))
    return _reader_from(lambda: Imikolov(data_file=data_file, mode=mode,
                                         data_type="NGRAM",
                                         window_size=n), tf)


imikolov.train = lambda word_dict=None, n=5, *, data_file=None: \
    _imikolov_reader("train", n, data_file)
imikolov.test = lambda word_dict=None, n=5, *, data_file=None: \
    _imikolov_reader("test", n, data_file)
imikolov.build_dict = lambda: {i: i for i in range(2073)}


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


# -- movielens --------------------------------------------------------------
movielens = _module("movielens")


def _movielens_reader(mode, data_file):
    from ..text.datasets import Movielens
    return _reader_from(lambda: Movielens(data_file=data_file, mode=mode))


movielens.train = lambda data_file=None: _movielens_reader("train",
                                                           data_file)
movielens.test = lambda data_file=None: _movielens_reader("test",
                                                          data_file)


# -- streaming: online-learning completion-record stream (a REAL
# -- submodule, not a fluid reader shim — see docs/online_learning.md) ------
from .streaming import StreamingDataset  # noqa: E402

__all__ += ["streaming", "StreamingDataset"]
