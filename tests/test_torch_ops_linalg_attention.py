"""The port's linear-algebra ops (``ops/linalg.py``, ``nd.linalg``) and
the attention ops of this part (``masked_softmax``, ``div_sqrt_dim``, the
interleaved-projection products, the sliding-window ops) against the JAX
package on the CPU: every case of the table
(``tests/test_torch_op_cases.py``) at its stated rtol (bf16 at 1e-2);
``gesvd``, ``syevd`` and ``gelqf`` by reconstruction and orthogonality
within 1e-4, with the singular values, the eigenvalues and |L| held to
the JAX ones (their signs are the solver's); each differentiable op's
gradient against ``jax.vjp`` of the JAX op (the decompositions included,
on the sign-free heads of the gradient sweep); and ``nd.linalg.<short>``
is ``linalg_<short>`` in both packages.
"""

import numpy as np
import pytest
import torch

from incubator_mxnet_tpu import nd as jnd

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import nd

from test_torch_op_cases import (CHECKS, case_ids, compare, grad_names, host,
                                 ids, spd, u)
from torch_op_parity import gradient_equals_jax, op_equals_jax

import jax
import jax.numpy as jnp
from incubator_mxnet_tpu.ops import registry as jreg
from incubator_mxnet_tpu_torch.ops import registry as treg

CASE_IDS = case_ids("linalg_attention")
DECOMPOSITIONS = set(CHECKS)


@pytest.mark.parametrize("name,i,dtype", CASE_IDS, ids=ids(CASE_IDS))
def test_op_equals_jax(name, i, dtype):
    op_equals_jax(name, i, dtype)


@pytest.mark.parametrize("name", sorted(set(grad_names(
    {"linalg_attention"})) - DECOMPOSITIONS))
def test_gradient_equals_jax_vjp(name):
    gradient_equals_jax(name)


# sign-free heads of the decompositions (tests/test_op_gradient_sweep.py)
_HEADS = {
    "linalg_gelqf": (u(3, 4, lo=-0.5, hi=0.5),
                     lambda o, w: o[0].sum() + (o[1] * w).sum(), (3, 4)),
    "linalg_syevd": (spd(3), lambda o, w: o[1].sum()
                     + (o[0] * o[0] * w).sum(), (3, 3)),
    "linalg_gesvd": (u(3, 4, lo=-0.5, hi=0.5), lambda o, w: o[1].sum(),
                     (3, 4)),
}


@pytest.mark.parametrize("name", sorted(_HEADS))
def test_decomposition_gradient_equals_jax_vjp(name):
    a, head, wshape = _HEADS[name]
    w = np.random.RandomState(9).randn(*wshape).astype(np.float32)
    jg = jax.grad(lambda x: head(jreg.get(name).fn(x), jnp.asarray(w)))(
        jnp.asarray(a))
    x = torch.from_numpy(a.copy()).requires_grad_(True)
    (tg,) = torch.autograd.grad(head(treg.get(name).fn(x),
                                     torch.from_numpy(w)), [x])
    np.testing.assert_allclose(host(tg), np.asarray(jg), rtol=1e-4,
                               atol=1e-4 * float(np.abs(jg).max()))


def test_nd_linalg_namespace_equals_jax():
    assert sorted(n for n in dir(nd.linalg) if not n.startswith("_")
                  and callable(getattr(nd.linalg, n))
                  and n not in ("make_op_function",)) == \
        sorted(n for n in dir(jnd.linalg) if not n.startswith("_")
               and callable(getattr(jnd.linalg, n))
               and n not in ("make_op_function",))
    a = spd(3)
    with mx.cpu():
        got = nd.linalg.potrf(nd.array(a))
    compare(got, jnd.linalg.potrf(jnd.array(a)), 1e-5, "float32")
