"""Neural-network operators: the port of the JAX package's
``incubator_mxnet_tpu/ops/nn.py`` for dense, embedding, normalization,
activation, softmax and dropout, plus the registered
``scaled_dot_product_attention`` (``ops.attention``; with ``flash=True``
the flash kernels on a CUDA tensor).

The JAX numerics are kept: LayerNorm, BatchNorm, InstanceNorm and
GroupNorm compute statistics and the affine transform in f32 and return
the input dtype; BatchNorm returns ``(out, batch_mean, batch_var)`` and
the gluon layer updates the running statistics; Dropout is inverted
dropout whose mask is drawn from ``mx.random``'s generator for the
input's device (the ``generator=`` the front end passes) in place of the
JAX op's PRNG key. ``Convolution``, ``Pooling``, ``CTCLoss`` and the other
ops of the JAX module are not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError
from .attention import scaled_dot_product_attention as _sdpa
from .registry import register


@register("FullyConnected", aliases=("fully_connected",))
def fully_connected(data, weight, bias=None, num_hidden=None, no_bias=False,
                    flatten=True):
    """y = x W^T + b, weight (num_hidden, in_units)."""
    if flatten and data.ndim > 2:
        data = data.reshape(data.shape[0], -1)
    if data.shape[-1] != weight.shape[1]:
        raise MXNetError(f"FullyConnected: input width {data.shape[-1]} "
                         f"!= weight's {weight.shape[1]}")
    return F.linear(data, weight, None if no_bias else bias)


@register("Embedding", aliases=("embedding",))
def embedding(data, weight, input_dim=None, output_dim=None,
              dtype="float32", sparse_grad=False):
    """Row lookup, indices clipped to the table."""
    return F.embedding(data.long().clamp(0, weight.shape[0] - 1), weight)


@register("BatchNorm", aliases=("batch_norm",), num_outputs=3,
          training_aware=True)
def batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-5,
               momentum=0.9, fix_gamma=True, use_global_stats=False,
               axis=1, training=None):
    """Batch normalization; returns ``(out, batch_mean, batch_var)`` (the
    running statistics when not training), the statistics in the running
    statistics' dtype."""
    dt = data.dtype
    x = data.float()
    ax = axis % data.ndim
    axes = tuple(i for i in range(data.ndim) if i != ax)
    bshape = tuple(data.shape[i] if i == ax else 1 for i in range(data.ndim))
    g = torch.ones_like(gamma) if fix_gamma else gamma
    if training and not use_global_stats:
        mean = torch.mean(x, dim=axes)
        var = torch.var(x, dim=axes, unbiased=False)
    else:
        mean, var = moving_mean, moving_var
    inv = torch.rsqrt(var + eps)
    out = ((x - mean.reshape(bshape)) * (inv * g).reshape(bshape)
           + beta.reshape(bshape)).to(dt)
    if training and not use_global_stats:
        return out, mean.to(moving_mean.dtype), var.to(moving_var.dtype)
    return out, moving_mean, moving_var


@register("LayerNorm", aliases=("layer_norm",))
def layer_norm(data, gamma, beta, axis=-1, eps=1e-5):
    """Statistics and affine in f32, output in the input dtype."""
    if axis % data.ndim == data.ndim - 1:
        return F.layer_norm(data.float(), gamma.shape, gamma.float(),
                            beta.float(), eps).to(data.dtype)
    ax = axis % data.ndim
    x = data.float()
    mean = x.mean(dim=ax, keepdim=True)
    var = x.var(dim=ax, keepdim=True, unbiased=False)
    bshape = tuple(data.shape[a] if a == ax else 1 for a in range(data.ndim))
    out = (x - mean) * torch.rsqrt(var + eps)
    out = out * gamma.reshape(bshape).float() + \
        beta.reshape(bshape).float()
    return out.to(data.dtype)


@register("InstanceNorm", aliases=("instance_norm",))
def instance_norm(data, gamma, beta, eps=1e-3):
    """Per-instance, per-channel normalization of (N, C, ...) data."""
    x = data.float()
    axes = tuple(range(2, x.ndim))
    mean = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, keepdim=True, unbiased=False)
    bshape = (1, -1) + (1,) * (data.ndim - 2)
    out = (x - mean) * torch.rsqrt(var + eps)
    return (out * gamma.reshape(bshape) + beta.reshape(bshape)) \
        .to(data.dtype)


@register("GroupNorm", aliases=("group_norm",))
def group_norm(data, gamma, beta, num_groups=1, eps=1e-5):
    """Normalization over channel groups of (N, C, ...) data."""
    n, c = data.shape[:2]
    spatial = tuple(data.shape[2:])
    x = data.float().reshape((n, num_groups, c // num_groups) + spatial)
    axes = tuple(range(2, x.ndim))
    mean = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, keepdim=True, unbiased=False)
    x = ((x - mean) * torch.rsqrt(var + eps)).reshape(data.shape)
    bshape = (1, -1) + (1,) * (data.ndim - 2)
    return (x * gamma.reshape(bshape) + beta.reshape(bshape)).to(data.dtype)


_ACTIVATIONS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": F.softplus,
    "softsign": F.softsign,
}


@register("Activation", aliases=("activation",))
def activation(data, act_type="relu"):
    """relu, sigmoid, tanh, softrelu (softplus) or softsign."""
    if act_type not in _ACTIVATIONS:
        raise MXNetError(f"unknown act_type {act_type!r}")
    return _ACTIVATIONS[act_type](data)


@register("LeakyReLU", needs_key=True, training_aware=True)
def leaky_relu(data, gamma=None, act_type="leaky", slope=0.25,
               lower_bound=0.125, upper_bound=0.334, generator=None,
               training=None):
    """leaky, prelu, elu, selu, gelu (exact, erf) or rrelu (a slope drawn
    per element in training, the bounds' mean otherwise)."""
    if act_type == "leaky":
        return torch.where(data > 0, data, slope * data)
    if act_type == "prelu":
        g = gamma.reshape((1, -1) + (1,) * (data.ndim - 2)) \
            if gamma.ndim == 1 and data.ndim > 2 else gamma
        return torch.where(data > 0, data, g * data)
    if act_type == "elu":
        return torch.where(data > 0, data, slope * torch.expm1(data))
    if act_type == "selu":
        return 1.0507009873554805 * torch.where(
            data > 0, data, 1.6732632423543772 * torch.expm1(data))
    if act_type == "gelu":
        return F.gelu(data)
    if act_type == "rrelu":
        if training:
            s = torch.empty_like(data).uniform_(lower_bound, upper_bound,
                                                generator=generator)
        else:
            s = (lower_bound + upper_bound) / 2.0
        return torch.where(data > 0, data, s * data)
    raise MXNetError(f"unknown act_type {act_type!r}")


@register("gelu")
def gelu(data, approximate=False):
    """Gaussian error linear unit (exact unless ``approximate``)."""
    return F.gelu(data, approximate="tanh" if approximate else "none")


@register("softmax", aliases=("Softmax",))
def softmax(data, axis=-1, temperature=None, length=None):
    """Softmax along ``axis``; ``length`` (B,) masks positions past each
    row's length to 0."""
    if temperature is not None and temperature != 1.0:
        data = data / temperature
    if length is None:
        return torch.softmax(data, dim=axis)
    T = data.shape[axis]
    mask = torch.arange(T, device=data.device)[None, :] < \
        length[:, None].long()
    shape = [1] * data.ndim
    shape[0] = data.shape[0]
    shape[axis % data.ndim] = T
    mask = mask.reshape(shape)
    out = torch.softmax(torch.where(mask, data, float("-inf")), dim=axis)
    return torch.where(mask, out, torch.zeros((), dtype=out.dtype,
                                              device=out.device))


@register("log_softmax")
def log_softmax(data, axis=-1, temperature=None):
    if temperature is not None and temperature != 1.0:
        data = data / temperature
    return torch.log_softmax(data, dim=axis)


@register("softmax_cross_entropy")
def softmax_cross_entropy(data, label):
    """Summed cross entropy of (B, C) scores against (B,) labels."""
    logp = torch.log_softmax(data, dim=-1)
    return -torch.gather(logp, -1, label.long()[:, None]).sum()


@register("Dropout", aliases=("dropout",), needs_key=True,
          training_aware=True)
def dropout(data, p=0.5, mode="training", axes=(), generator=None,
            training=None):
    """Inverted dropout, ``x * mask / keep`` with the mask in x's dtype
    drawn from ``generator``; identity outside training (unless
    ``mode="always"``). ``axes`` broadcast one mask along them."""
    if (not training and mode != "always") or p == 0.0:
        return data
    shape = list(data.shape)
    for a in axes:
        shape[a] = 1
    keep = 1.0 - p
    mask = torch.empty(shape, dtype=data.dtype, device=data.device) \
        .bernoulli_(keep, generator=generator)
    return data * mask / keep


@register("scaled_dot_product_attention", aliases=("sdpa",))
def scaled_dot_product_attention(q, k, v, mask=None, scale=None,
                                 causal=False, flash=False,
                                 valid_length=None, layout="bthd"):
    """Multi-head attention core over (B, T, H, D) (``ops.attention``);
    ``flash=True`` with a key-length mask takes the flash path (the CUDA
    kernels on a CUDA tensor, their plain versions on the CPU). A
    non-boolean mask attends where it is nonzero."""
    if mask is not None and mask.dtype != torch.bool:
        mask = mask != 0
    return _sdpa(q, k, v, mask=mask, scale=scale, causal=causal,
                 flash=flash, valid_length=valid_length, layout=layout)
