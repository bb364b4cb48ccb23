"""Random samplers: the port of the JAX package's
``incubator_mxnet_tpu/ops/random_ops.py``.

Each op takes ``generator=`` (a ``torch.Generator``) where the JAX op
takes a PRNG key; the imperative front end fills it with ``mx.random``'s
generator for the device of the op's array inputs, or of ``ctx`` / the
current context when it has none, and a sampler without array inputs
draws on its generator's device. Philox and threefry streams never
match, so the port's samples equal the JAX package's in distribution
(their moments), not in value; one ``mx.random.seed`` replays the same
samples. The compound samplers keep the JAX constructions: the negative
binomials are Poisson draws of a Gamma-distributed rate, Laplace is
``loc + scale * Laplace(0, 1)``, and the ``sample_*`` ops draw
``shape`` samples for each element of their parameter arrays.
"""

from __future__ import annotations

import torch

from .registry import register


def _shape(shape):
    if shape is None:
        return ()
    if isinstance(shape, int):
        return (shape,)
    return tuple(shape)


def _dt(dtype):
    from ..ndarray.ndarray import to_torch_dtype
    return to_torch_dtype(dtype)


def _uniform(shape, dtype, generator):
    return torch.empty(shape, dtype=dtype,
                       device=generator.device).uniform_(generator=generator)


def _normal(shape, dtype, generator):
    return torch.empty(shape, dtype=dtype,
                       device=generator.device).normal_(generator=generator)


def _gamma(alpha, generator):
    """Gamma(alpha, 1) draws, one for each element of ``alpha``."""
    return torch._standard_gamma(alpha, generator=generator)


def _poisson(rate, generator):
    return torch.poisson(rate, generator=generator)


def _full(shape, value, generator):
    return torch.full(shape, float(value), dtype=torch.float32,
                      device=generator.device)


def _bshape(params, shape):
    """(output shape, the parameters' broadcast shape) for a ``sample_*``
    op: ``shape`` draws for each parameter element."""
    return (tuple(params.shape) + _shape(shape),
            tuple(params.shape) + (1,) * len(_shape(shape)))


def _as(out, dtype):
    return out if dtype is None else out.to(_dt(dtype))


@register("random_uniform", aliases=("uniform", "_random_uniform"),
          needs_key=True)
def random_uniform(low=0.0, high=1.0, shape=None, dtype="float32",
                   generator=None):
    return torch.empty(_shape(shape), dtype=_dt(dtype),
                       device=generator.device).uniform_(
        low, high, generator=generator)


@register("random_normal", aliases=("normal", "_random_normal"),
          needs_key=True)
def random_normal(loc=0.0, scale=1.0, shape=None, dtype="float32",
                  generator=None):
    return loc + scale * _normal(_shape(shape), _dt(dtype), generator)


@register("random_gamma", aliases=("_random_gamma",), needs_key=True)
def random_gamma(alpha=1.0, beta=1.0, shape=None, dtype="float32",
                 generator=None):
    """Gamma with shape ``alpha`` and scale ``beta``."""
    a = _full(_shape(shape), alpha, generator)
    return (beta * _gamma(a, generator)).to(_dt(dtype))


@register("random_exponential", aliases=("_random_exponential",),
          needs_key=True)
def random_exponential(lam=1.0, shape=None, dtype="float32",
                       generator=None):
    return torch.empty(_shape(shape), dtype=_dt(dtype),
                       device=generator.device).exponential_(
        generator=generator) / lam


@register("random_poisson", aliases=("_random_poisson",), needs_key=True)
def random_poisson(lam=1.0, shape=None, dtype="float32", generator=None):
    return _poisson(_full(_shape(shape), lam, generator),
                    generator).to(_dt(dtype))


@register("random_randint", aliases=("randint", "_random_randint"),
          needs_key=True)
def random_randint(low=0, high=None, shape=None, dtype="int32",
                   generator=None):
    """Integers in [low, high)."""
    return torch.empty(_shape(shape), dtype=_dt(dtype),
                       device=generator.device).random_(
        int(low), int(high), generator=generator)


@register("random_bernoulli", aliases=("bernoulli",), needs_key=True)
def random_bernoulli(p=0.5, shape=None, dtype="float32", generator=None):
    return torch.bernoulli(_full(_shape(shape), p, generator),
                           generator=generator).to(_dt(dtype))


@register("sample_uniform", needs_key=True)
def sample_uniform(low, high, shape=None, dtype=None, generator=None):
    """``shape`` draws of U(low[i], high[i]) for each element i."""
    out, b = _bshape(low, shape)
    u = _uniform(out, low.dtype, generator)
    return _as(low.reshape(b) + u * (high - low).reshape(b), dtype)


@register("sample_normal", needs_key=True)
def sample_normal(mu, sigma, shape=None, dtype=None, generator=None):
    out, b = _bshape(mu, shape)
    z = _normal(out, mu.dtype, generator)
    return _as(mu.reshape(b) + z * sigma.reshape(b), dtype)


@register("sample_gamma", needs_key=True)
def sample_gamma(alpha, beta, shape=None, dtype=None, generator=None):
    out, b = _bshape(alpha, shape)
    g = _gamma(alpha.reshape(b).expand(out).contiguous(), generator)
    return _as(g * beta.reshape(b), dtype)


@register("sample_exponential", needs_key=True)
def sample_exponential(lam, shape=None, dtype=None, generator=None):
    out, b = _bshape(lam, shape)
    e = torch.empty(out, dtype=lam.dtype, device=lam.device).exponential_(
        generator=generator)
    return _as(e / lam.reshape(b), dtype)


@register("sample_poisson", needs_key=True)
def sample_poisson(lam, shape=None, dtype="float32", generator=None):
    out, b = _bshape(lam, shape)
    return _poisson(lam.reshape(b).expand(out).float(),
                    generator).to(_dt(dtype))


@register("sample_negative_binomial", needs_key=True)
def sample_negative_binomial(k, p, shape=None, dtype="float32",
                             generator=None):
    """NB(k[i], p[i]) as Poisson(Gamma(k, (1 - p) / p))."""
    out, b = _bshape(k, shape)
    rate = _gamma(k.reshape(b).expand(out).float(), generator) * \
        ((1.0 - p) / p).reshape(b)
    return _poisson(rate, generator).to(_dt(dtype))


@register("sample_generalized_negative_binomial", needs_key=True)
def sample_generalized_negative_binomial(mu, alpha, shape=None,
                                         dtype="float32", generator=None):
    """GNB(mu[i], alpha[i]): Poisson with a Gamma(1 / alpha, mu * alpha)
    rate; alpha == 0 is plain Poisson(mu)."""
    out, b = _bshape(mu, shape)
    a = alpha.reshape(b).float()
    mub = mu.reshape(b).float()
    safe = torch.where(a == 0, torch.ones_like(a), a)
    g = _gamma((1.0 / safe).expand(out).contiguous(), generator)
    rate = torch.where(a == 0, mub.expand(out), g * (mub * safe))
    return _poisson(rate, generator).to(_dt(dtype))


@register("sample_multinomial", aliases=("_sample_multinomial",),
          needs_key=True)
def sample_multinomial(data, shape=None, get_prob=False, dtype="int32",
                       generator=None):
    """Category ids drawn from each probability row (``shape`` draws a
    row); ``get_prob`` also returns their log-probabilities."""
    batch = tuple(data.shape[:-1])
    draw = _shape(shape)
    total = 1
    for d in draw:
        total *= d
    rows = data.reshape(-1, data.shape[-1]).float()
    samples = torch.multinomial(rows, max(total, 1), replacement=True,
                                generator=generator)
    samples = samples.reshape(batch + draw if total > 1 else batch)
    out = samples.to(_dt(dtype))
    if get_prob:
        logp = torch.log(torch.clamp(data, min=1e-38))
        picked = torch.gather(logp, -1, samples.reshape(batch + (-1,)))
        return out, picked.reshape(out.shape)
    return out


@register("random_laplace", aliases=("laplace", "_random_laplace"),
          needs_key=True)
def random_laplace(loc=0.0, scale=1.0, shape=None, dtype="float32",
                   generator=None):
    u = _uniform(_shape(shape), _dt(dtype), generator) - 0.5
    lap = -torch.sign(u) * torch.log1p(-2.0 * torch.abs(u))
    return loc + scale * lap


@register("random_randn", aliases=("randn",), needs_key=True)
def random_randn(*shape, loc=0.0, scale=1.0, dtype="float32",
                 generator=None):
    """``nd.random.randn(*shape)``."""
    if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
        shape = tuple(shape[0])
    return loc + scale * _normal(tuple(int(s) for s in shape), _dt(dtype),
                                 generator)


@register("random_negative_binomial",
          aliases=("negative_binomial", "_random_negative_binomial"),
          needs_key=True)
def random_negative_binomial(k=1, p=1.0, shape=None, dtype="float32",
                             generator=None):
    """NB(k, p) as Poisson(Gamma(k, (1 - p) / p))."""
    rate = _gamma(_full(_shape(shape), k, generator), generator) * \
        (1.0 - p) / p
    return _poisson(rate, generator).to(_dt(dtype))


@register("random_generalized_negative_binomial",
          aliases=("generalized_negative_binomial",
                   "_random_generalized_negative_binomial"), needs_key=True)
def random_generalized_negative_binomial(mu=1.0, alpha=1.0, shape=None,
                                         dtype="float32", generator=None):
    """GNB(mu, alpha): Poisson with a Gamma(1 / alpha, mu * alpha) rate
    (plain Poisson(mu) when alpha == 0)."""
    if alpha == 0:
        lam = _full(_shape(shape), mu, generator)
    else:
        lam = _gamma(_full(_shape(shape), 1.0 / alpha, generator),
                     generator) * mu * alpha
    return _poisson(lam, generator).to(_dt(dtype))
