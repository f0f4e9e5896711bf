"""Vision datasets (paddle_tpu/vision/datasets): local files only."""
from .mnist import MNIST, FashionMNIST  # noqa: F401
from .cifar import Cifar10, Cifar100  # noqa: F401
from .folder import DatasetFolder, ImageFolder  # noqa: F401
from .flowers import Flowers  # noqa: F401
from .voc2012 import VOC2012  # noqa: F401

__all__ = ["MNIST", "FashionMNIST", "Cifar10", "Cifar100",
           "DatasetFolder", "ImageFolder", "Flowers", "VOC2012"]
