"""Datasets, samplers and the DataLoader: the port of the JAX package's
``incubator_mxnet_tpu/gluon/data/``."""

from . import dataset
from .dataset import (Dataset, ArrayDataset, SimpleDataset, RecordFileDataset)
from . import sampler
from .sampler import (Sampler, SequentialSampler, RandomSampler, BatchSampler)
from . import dataloader
from .dataloader import DataLoader
from . import vision

__all__ = ["Dataset", "ArrayDataset", "SimpleDataset", "RecordFileDataset",
           "Sampler", "SequentialSampler", "RandomSampler", "BatchSampler",
           "DataLoader", "vision"]
