"""How far f32 rounding can move a few SGD steps of resnet18_v1, on the
CPU, through the PyTorch port alone.

    python tools/torch_vision_conditioning.py sensitivity
    python tools/torch_vision_conditioning.py float64

``sensitivity``: resnet18_v1(thumbnail=True, classes=10), 32 x 32
inputs in [0, 1), three ``SPMDTrainer`` SGD steps (momentum 0.9) at each
(batch, learning rate); then the same with every trained weight scaled
by (1 + 1e-6 n), n standard normal. Prints each step's loss and its
relative change: a change far above 1e-6 means rounding differences of
that size (another library's convolution, another summation order) part
two correct f32 implementations by more than a parity test's tolerance.

``float64``: B=32, lr 1e-3 (the zoo test's and chip_smoke.py's
card-against-CPU configuration) in f32 and in float64 (BatchNorm's
statistics too, where the port's op computes them in f32), from the same
weights. Prints the losses' relative difference and, per tensor, the
largest absolute difference after three steps against its largest
entry.

Runs on the host (``with mx.cpu():``) in about a minute each.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import incubator_mxnet_tpu_torch as mx  # noqa: E402
from incubator_mxnet_tpu_torch import nd  # noqa: E402
from incubator_mxnet_tpu_torch.gluon import loss as gloss  # noqa: E402
from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import \
    resnet18_v1  # noqa: E402
from incubator_mxnet_tpu_torch.ops import nn as ops_nn  # noqa: E402
from incubator_mxnet_tpu_torch.ops import registry  # noqa: E402
from incubator_mxnet_tpu_torch.parallel import SPMDTrainer  # noqa: E402


def _batch(B, side=32):
    rng = np.random.RandomState(0)
    return (rng.rand(B, 3, side, side).astype(np.float32),
            rng.randint(0, 10, (B,)).astype(np.int32))


def _run(B, lr, perturb=0.0, dtype="float32", steps=3):
    """Losses of ``steps`` SGD steps and the final parameters."""
    x, y = _batch(B)
    with mx.cpu():
        mx.random.seed(0)
        net = resnet18_v1(thumbnail=True, classes=10)
        net.initialize()
        net(nd.array(x))
        if perturb:
            g = torch.Generator().manual_seed(1)
            with torch.no_grad():
                for p in net.parameters():
                    if p.requires_grad:
                        p.mul_(1 + perturb * torch.randn(p.shape,
                                                         generator=g))
        if dtype != "float32":
            net.cast(dtype)
        tr = SPMDTrainer(net, loss=gloss.SoftmaxCrossEntropyLoss(),
                         optimizer="sgd",
                         optimizer_params={"learning_rate": lr,
                                           "momentum": 0.9})
        xs = nd.array(x.astype(dtype), dtype=dtype)
        ys = nd.array(y, dtype="int32")
        losses = np.array([float(tr.step(xs, ys).asnumpy())
                           for _ in range(steps)])
        final = {k: p.data()._data.detach().double().clone()
                 for k, p in net._collect_params_with_prefix().items()}
    return losses, final


def _batch_norm_float64(data, gamma, beta, moving_mean, moving_var,
                        eps=1e-5, momentum=0.9, fix_gamma=True,
                        use_global_stats=False, axis=1, training=None):
    """The BatchNorm op with its statistics in the input's dtype when that
    is float64 (the port's op computes them in f32)."""
    if data.dtype != torch.float64:
        return _F32_BATCH_NORM(data, gamma, beta, moving_mean, moving_var,
                               eps, momentum, fix_gamma, use_global_stats,
                               axis, training)
    axes = tuple(i for i in range(data.ndim) if i != 1)
    shape = (1, -1) + (1,) * (data.ndim - 2)
    g = torch.ones_like(gamma) if fix_gamma else gamma
    mean = data.mean(dim=axes)
    var = data.var(dim=axes, unbiased=False)
    out = (data - mean.reshape(shape)) * (torch.rsqrt(var + eps) * g) \
        .reshape(shape) + beta.reshape(shape)
    return out, mean, var


_F32_BATCH_NORM = ops_nn.batch_norm


def sensitivity():
    for B in (8, 32):
        for lr in (0.1, 0.01, 0.001):
            base, _ = _run(B, lr)
            moved, _ = _run(B, lr, perturb=1e-6)
            change = np.abs(moved - base) / np.abs(base)
            print(f"B={B:2d} lr={lr:<5} losses {np.round(base, 5)} "
                  f"relative change at 1e-6: "
                  f"{' '.join(f'{c:.1e}' for c in change)}", flush=True)


def float64():
    registry.get("BatchNorm").fn = _batch_norm_float64
    try:
        l32, p32 = _run(32, 1e-3)
        l64, p64 = _run(32, 1e-3, dtype="float64")
    finally:
        registry.get("BatchNorm").fn = _F32_BATCH_NORM
    print(f"losses f32 {l32} float64 {l64}; largest relative difference "
          f"{float(np.max(np.abs(l32 - l64) / l64)):.1e}")
    rows = sorted(((float((p32[k] - p64[k]).abs().max()),
                    float(p64[k].abs().max()), k) for k in p64),
                  key=lambda r: -r[0] / max(r[1], 1e-30))
    for diff, top, name in rows[:8]:
        print(f"{name:40s} |f32 - float64| {diff:.2e}, largest entry "
              f"{top:.2e} ({diff / max(top, 1e-30):.1e} of it)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("sensitivity", "float64"))
    {"sensitivity": sensitivity, "float64": float64}[
        ap.parse_args().what]()
