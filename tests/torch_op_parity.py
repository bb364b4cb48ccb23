"""Shared JAX-parity checks of the operator case table
(``tests/test_torch_op_cases.py``) for the ``tests/test_torch_ops_*.py``
files: the port's ``nd.<op>`` on a case against the JAX op (the
registry function behind the JAX ``nd.<op>``, compiled as one program:
one compile a case instead of one a primitive), and its gradient against
``jax.vjp`` of the JAX op (custom gradients included) on the same
cotangents."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from incubator_mxnet_tpu.ops import registry as jreg

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import nd
from incubator_mxnet_tpu_torch.ops import registry as treg

from test_torch_op_cases import CASES, CHECKS, call, compare, host, invoke

GRAD_RTOL = 1e-5


# ops that read their data on the host: JAX runs them eagerly
EAGER = {"boolean_mask"}


def _jax_arrays(inputs, dtype):
    out = []
    for a in inputs:
        want = None
        if isinstance(a, tuple):
            a, want = a
        if a.dtype.kind == "f":
            out.append(jnp.asarray(a).astype(want or dtype))
        else:
            out.append(jnp.asarray(a.astype(np.int32)))
    return out


def jax_op(name, inputs, kw, dtype):
    """The JAX op on a case, compiled as one program (eager for
    ``EAGER``): the registry function ``nd.<name>`` runs."""
    def fn(*xs):
        return invoke(jreg.get(name).fn, name, list(xs), kw)

    xs = _jax_arrays(inputs, dtype)
    return fn(*xs) if name in EAGER else jax.jit(fn)(*xs)


@functools.lru_cache(maxsize=None)
def case_outputs(name, i, dtype):
    """A case's (inputs, the port's outputs, the JAX op's outputs), run
    once a process (a family's file may hold a case twice)."""
    make, kw, _, _ = CASES[name][i]
    inputs = make()
    return (inputs, call(nd, name, inputs, kw, dtype, ctx=mx.cpu()),
            jax_op(name, inputs, kw, dtype))


def op_equals_jax(name, i, dtype):
    rtol = CASES[name][i][2]
    inputs, got, want = case_outputs(name, i, dtype)
    if name in CHECKS:
        CHECKS[name](got, want, inputs, 1e-4)
    else:
        compare(got, want, rtol, dtype)


def _floats(outs):
    return list(outs) if isinstance(outs, (list, tuple)) else [outs]


def gradient_equals_jax(name):
    """The op's first case, f32: the port's gradient (torch.autograd of
    sum(out * cotangent) over the float outputs) against ``jax.vjp`` of
    the JAX op with the same seeded cotangents, for every float input (an
    input without a torch gradient counts as zero)."""
    make, kw, rtol, _ = CASES[name][0]
    inputs = [a[0] if isinstance(a, tuple) else a for a in make()]
    floats = [k for k, a in enumerate(inputs) if a.dtype.kind == "f"]
    jx = [jnp.asarray(a) for a in inputs]
    tx = [torch.from_numpy(a.copy()) for a in inputs]
    for k in floats:
        tx[k].requires_grad_(True)

    def jfn(*fl):
        xs = list(jx)
        for k, v in zip(floats, fl):
            xs[k] = v
        return invoke(jreg.get(name).fn, name, xs, kw)

    primals = [jx[k] for k in floats]
    shapes = _floats(jfn(*primals) if name in EAGER
                     else jax.eval_shape(jfn, *primals))
    rng = np.random.RandomState(11)
    cts = [np.asarray(rng.randn(*o.shape), np.float32) for o in shapes]

    def out_and_grads(primals, cts):
        out, vjp = jax.vjp(jfn, *primals)
        cot = type(out)(c.astype(o.dtype) for c, o in zip(cts, out)) \
            if isinstance(out, (list, tuple)) else cts[0].astype(out.dtype)
        return vjp(cot)

    # one compiled program (the forward and its VJP), not one compile a
    # primitive as eager JAX would
    run = out_and_grads if name in EAGER else jax.jit(out_and_grads)
    jgrads = run(primals, [jnp.asarray(c) for c in cts])
    tout = _floats(invoke(treg.get(name).fn, name, tx, kw))
    terms = [(o.float() * torch.from_numpy(c)).sum()
             for o, c in zip(tout, cts) if o.requires_grad]
    tgrads = torch.autograd.grad(sum(terms), [tx[k] for k in floats],
                                 allow_unused=True) if terms \
        else [None] * len(floats)
    for k, jg, tg in zip(floats, jgrads, tgrads):
        want = np.asarray(jg, np.float64)
        got = np.zeros_like(want) if tg is None else host(tg)
        atol = max(rtol, GRAD_RTOL) * float(np.abs(want).max(initial=0.0))
        np.testing.assert_allclose(got, want, rtol=max(rtol, GRAD_RTOL),
                                   atol=atol,
                                   err_msg=f"{name}: input {k}")
