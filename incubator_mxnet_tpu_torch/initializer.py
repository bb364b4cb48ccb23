"""Weight initializers: the port of the JAX package's
``incubator_mxnet_tpu/initializer.py`` for what the port's models use.

Each initializer is a callable that fills a tensor in place, drawing from
an explicit ``torch.Generator`` (the port's default one for the tensor's
device, ``random.generator``, when none is passed). JAX's threefry and
torch's generators give different numbers from one seed: weights cross
between the packages through ``models.convert``, never through a seed.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["TruncNorm", "Zero", "One"]


class TruncNorm:
    """Normal(mean, stdev) truncated at two standard deviations (the
    GluonNLP ``TruncNorm`` BERT and GPT use). The draw is made in f32 and
    cast to the tensor's dtype."""

    def __init__(self, mean=0.0, stdev=0.01):
        self.mean = float(mean)
        self.stdev = float(stdev)

    @torch.no_grad()
    def __call__(self, tensor, generator=None):
        if generator is None:
            from .random import generator as default_generator
            generator = default_generator(tensor.device)
        w = torch.empty(tensor.shape, device=tensor.device)
        nn.init.trunc_normal_(w, mean=self.mean, std=self.stdev,
                              a=self.mean - 2 * self.stdev,
                              b=self.mean + 2 * self.stdev,
                              generator=generator)
        return tensor.copy_(w)


class Zero:
    @torch.no_grad()
    def __call__(self, tensor, generator=None):
        return tensor.zero_()


class One:
    @torch.no_grad()
    def __call__(self, tensor, generator=None):
        return tensor.fill_(1.0)
