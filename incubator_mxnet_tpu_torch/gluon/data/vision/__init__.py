"""Vision datasets and transforms: the port of the JAX package's
``incubator_mxnet_tpu/gluon/data/vision/``."""

from . import datasets
from .datasets import (MNIST, FashionMNIST, CIFAR10, CIFAR100,
                       ImageFolderDataset, ImageRecordDataset)
from . import transforms

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageFolderDataset", "ImageRecordDataset", "transforms"]
