"""Weight initializers: the port of the JAX package's
``incubator_mxnet_tpu/initializer.py``.

An initializer is called MXNet's way, ``init(name, arr)``: the name picks
the conventions (``*bias`` / ``*beta`` / running means to zeros,
``*gamma`` / running variances to ones, anything else the initializer's
own draw), and ``arr`` (an ``NDArray``) is filled in place. Draws come
from ``mx.random``'s generator for the array's device, in f32, and are
cast to the array's dtype. Calling an initializer on a ``torch.Tensor``
(``init(tensor, generator)``) runs its draw on the tensor directly, which
the port's ``nn.Module`` models use. JAX's threefry and torch's
generators give different numbers from one seed: weights cross between
the packages by copying, never through a seed. Initializers register by
name, so ``init='xavier'`` works.
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch
from torch import nn

from .base import MXNetError

__all__ = ["Initializer", "Uniform", "Normal", "Zero", "One", "Constant",
           "Xavier", "MSRAPrelu", "Orthogonal", "Bilinear", "LSTMBias",
           "TruncNorm", "Mixed", "InitDesc", "Load", "register", "create"]

_REGISTRY = {}


def register(name, aliases=()):
    """Class decorator: make the initializer creatable by ``name``."""
    def deco(cls):
        for n in (name,) + tuple(aliases):
            _REGISTRY[n.lower()] = cls
        return cls
    return deco


def _generator(tensor, generator):
    if generator is None:
        from .random import generator as default_generator
        generator = default_generator(tensor.device)
    return generator


class Initializer:
    """Base initializer; subclasses implement ``_init_tensor(tensor,
    generator)``, an in-place fill."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, name, arr=None, generator=None):
        if torch.is_tensor(name):
            with torch.no_grad():
                self._init_tensor(name, _generator(name, generator))
            return name
        if not isinstance(name, str):
            name, arr = arr, name
        override = getattr(name, "attrs", {}).get("__init__")
        if override:
            create(override)(str(name), arr)
            return
        self.init_weight(name, arr)

    def init_weight(self, name: str, arr):
        t = arr._data
        lname = name.lower()
        with torch.no_grad():
            if lname.endswith(("bias", "beta")) or "moving_mean" in lname \
                    or "running_mean" in lname:
                t.zero_()
            elif lname.endswith("gamma") or "moving_var" in lname \
                    or "running_var" in lname:
                t.fill_(1.0)
            else:
                self._init_tensor(t, _generator(t, None))

    def _init_tensor(self, tensor, generator):
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}({self._kwargs})"


def _fill_f32(tensor, draw):
    """``draw(f32 tensor)`` then copy into ``tensor`` (cast)."""
    w = torch.empty(tensor.shape, dtype=torch.float32, device=tensor.device)
    draw(w)
    tensor.copy_(w)


@register("uniform")
class Uniform(Initializer):
    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_tensor(self, tensor, generator):
        _fill_f32(tensor, lambda w: w.uniform_(-self.scale, self.scale,
                                               generator=generator))


@register("normal")
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_tensor(self, tensor, generator):
        _fill_f32(tensor, lambda w: w.normal_(0.0, self.sigma,
                                              generator=generator))


@register("zeros", aliases=("zero",))
class Zero(Initializer):
    def _init_tensor(self, tensor, generator):
        tensor.zero_()


@register("ones", aliases=("one",))
class One(Initializer):
    def _init_tensor(self, tensor, generator):
        tensor.fill_(1.0)


@register("constant")
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_tensor(self, tensor, generator):
        tensor.copy_(torch.as_tensor(np.asarray(self.value, np.float32))
                     .expand(tensor.shape))


def _fan(shape, factor_type):
    hw = 1
    for d in shape[2:]:
        hw *= d
    fan_in = (shape[1] if len(shape) > 1 else shape[0]) * hw
    fan_out = shape[0] * hw
    if factor_type == "avg":
        return (fan_in + fan_out) / 2.0
    if factor_type == "in":
        return float(fan_in)
    if factor_type == "out":
        return float(fan_out)
    raise MXNetError(f"unknown factor_type {factor_type}")


@register("xavier")
class Xavier(Initializer):
    """Glorot initialization."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_tensor(self, tensor, generator):
        scale = math.sqrt(self.magnitude /
                          max(_fan(tensor.shape, self.factor_type), 1.0))
        if self.rnd_type == "uniform":
            _fill_f32(tensor, lambda w: w.uniform_(-scale, scale,
                                                   generator=generator))
        elif self.rnd_type == "gaussian":
            _fill_f32(tensor, lambda w: w.normal_(0.0, scale,
                                                  generator=generator))
        else:
            raise MXNetError(f"unknown rnd_type {self.rnd_type}")


@register("msraprelu")
class MSRAPrelu(Xavier):
    """He initialization."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register("orthogonal")
class Orthogonal(Initializer):
    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_tensor(self, tensor, generator):
        nout = tensor.shape[0]
        nin = int(np.prod(tensor.shape[1:])) if tensor.dim() > 1 else 1
        tmp = torch.empty((nout, nin), dtype=torch.float32,
                          device=tensor.device)
        if self.rand_type == "uniform":
            tmp.uniform_(-1.0, 1.0, generator=generator)
        else:
            tmp.normal_(0.0, 1.0, generator=generator)
        u, _, v = torch.linalg.svd(tmp, full_matrices=False)
        q = u if tuple(u.shape) == (nout, nin) else v
        tensor.copy_((self.scale * q).reshape(tensor.shape))


@register("bilinear")
class Bilinear(Initializer):
    """Bilinear upsampling kernels for deconvolution."""

    def _init_tensor(self, tensor, generator):
        shape = tuple(tensor.shape)
        weight = np.zeros(shape, dtype=np.float32)
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        flat = weight.reshape(-1)
        for i in range(flat.size):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            flat[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        tensor.copy_(torch.from_numpy(weight))


@register("lstmbias")
class LSTMBias(Initializer):
    """Forget-gate bias: zeros, with the second quarter at
    ``forget_bias``."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_tensor(self, tensor, generator):
        n = tensor.shape[0] // 4
        tensor.zero_()
        tensor[n:2 * n] = self.forget_bias


@register("truncnorm")
class TruncNorm(Initializer):
    """Normal(mean, stdev) truncated at two standard deviations (the
    GluonNLP ``TruncNorm`` BERT and GPT use), drawn in f32."""

    def __init__(self, mean=0.0, stdev=0.01, **kwargs):
        super().__init__(**kwargs)
        self.mean = float(mean)
        self.stdev = float(stdev)

    def _init_tensor(self, tensor, generator):
        _fill_f32(tensor, lambda w: nn.init.trunc_normal_(
            w, mean=self.mean, std=self.stdev,
            a=self.mean - 2 * self.stdev, b=self.mean + 2 * self.stdev,
            generator=generator))


def create(init) -> Initializer:
    """An initializer from an instance, a registered name or None (the
    default, ``Uniform()``)."""
    if isinstance(init, (Initializer, Load)):
        return init
    if init is None:
        return Uniform()
    if isinstance(init, str):
        cls = _REGISTRY.get(init.lower())
        if cls is None:
            raise MXNetError(f"initializer {init!r} is not registered "
                             f"(one of {sorted(_REGISTRY)})")
        return cls()
    raise MXNetError(f"cannot create initializer from {init!r}")


class InitDesc(str):
    """A parameter name carrying ``attrs`` (an ``__init__`` entry there
    overrides the initializer) and ``global_init``."""

    def __new__(cls, name, attrs=None, global_init=None):
        obj = super().__new__(cls, name)
        obj.attrs = attrs or {}
        obj.global_init = global_init
        return obj


class Mixed(Initializer):
    """Per-name-pattern dispatch: regexes tried in order, the first that
    matches initializes."""

    def __init__(self, patterns, initializers):
        super().__init__(patterns=patterns, initializers=initializers)
        if len(patterns) != len(initializers):
            raise MXNetError("Mixed: len(patterns) != len(initializers)")
        self._map = [(re.compile(p), init)
                     for p, init in zip(patterns, initializers)]

    def init_weight(self, name, arr):
        for prog, init in self._map:
            if prog.match(name):
                init(name, arr)
                return
        raise MXNetError(
            f"Mixed: parameter {name!r} did not match any pattern — "
            f"add a '.*' catch-all as the last pattern")


@register("load")
class Load:
    """Initialize from saved arrays: the exact name first, then with the
    ``arg:`` / ``aux:`` prefixes stripped; ``default_init`` covers the
    rest."""

    def __init__(self, param, default_init=None, verbose=False):
        if isinstance(param, str):
            from .ndarray import load as nd_load
            param = nd_load(param, ctx="cpu")
        self.param = {}
        for k, v in param.items():
            key = k.split(":", 1)[1] if k.startswith(("arg:", "aux:")) \
                else k
            self.param[key] = v
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr):
        if not isinstance(name, str):
            name, arr = arr, name
        if name in self.param:
            src = self.param[name]
            src = src._data if hasattr(src, "_data") else \
                torch.as_tensor(np.asarray(src))
            if tuple(src.shape) != tuple(arr.shape):
                raise MXNetError(
                    f"Load: shape mismatch for {name}: saved "
                    f"{tuple(src.shape)} vs expected {tuple(arr.shape)}")
            with torch.no_grad():
                arr._data.copy_(src)
            if self.verbose:
                print(f"Initialized {name} from the loaded arrays")
        elif self.default_init is not None:
            self.default_init(name, arr)
        else:
            raise MXNetError(
                f"Load: no saved value for {name!r} and no default_init")
