"""The port's miscellaneous ops (``ops/misc.py``: cumulative and index
math, Correlation, Crop, the regression and SVM heads, the AMP casts and
finite checks, BilinearResize2D, histogram, ...) and the neural-network
ops of this part (``softmin``, ``SoftmaxActivation``, ``SoftmaxOutput``,
``CTCLoss``) against the JAX package on the CPU: every case of the table
(``tests/test_torch_op_cases.py``) at its stated rtol (bf16 at 1e-2), and
each differentiable op's gradient against ``jax.vjp`` of the JAX op
(custom VJPs included: the heads' backward ignores the head gradient) at
rtol 1e-5; ``CTCLoss``'s gradient case is ``slow``, as in the JAX
gradient sweep.
"""

import pytest

from test_torch_op_cases import case_ids, grad_names, ids
from torch_op_parity import gradient_equals_jax, op_equals_jax

CASE_IDS = case_ids("misc_nn")


@pytest.mark.parametrize("name,i,dtype", CASE_IDS, ids=ids(CASE_IDS))
def test_op_equals_jax(name, i, dtype):
    op_equals_jax(name, i, dtype)


@pytest.mark.parametrize("name", [
    # the JAX sweep marks CTCLoss's gradient case slow; so does this one
    pytest.param(n, marks=pytest.mark.slow) if n == "CTCLoss" else n
    for n in grad_names({"misc_nn"})])
def test_gradient_equals_jax_vjp(name):
    gradient_equals_jax(name)
