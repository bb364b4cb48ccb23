"""``mx.np``'s integer division where a divisor is 0, with no JAX in it:
the inputs (``DIVISION_CASES``, which ``tests/test_torch_numpy.py`` holds
against the JAX package on the CPU, values and dtypes) and the card's
test of the same calls against the port on the CPU.

jax.numpy gives defined values where an integer or bool divisor is 0
(``floor_divide`` all ones unsigned, -2 or -1 signed; ``remainder`` /
``mod`` 0; ``fmod`` 0, or the numerator of two bools), where torch raises
on the CPU and returns whatever its kernel returns on CUDA.
``test_division_by_zero_on_the_card_equals_the_cpu`` (``cuda``) imports
no JAX (``chip_smoke.py`` runs it with ``--noconftest``).
"""

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu_torch as mx

# numerators and divisors, zeros in the divisor beside nonzeros (and a
# zero numerator over a zero divisor)
_NUM = np.array([[3, -3, 0, 7], [-7, 5, 0, 1], [2, -1, 4, 0]])
_DEN = np.array([[0, 0, 0, 2], [3, -2, 1, 0], [0, 1, 0, 0]])
DIVISION_NAMES = ("floor_divide", "remainder", "mod", "fmod")
DIVISION_INPUTS = {
    "int8": (_NUM.astype(np.int8), _DEN.astype(np.int8)),
    "int32": (_NUM.astype(np.int32), _DEN.astype(np.int32)),
    "int64": (_NUM.astype(np.int64), _DEN.astype(np.int64)),
    "uint8": (np.abs(_NUM).astype(np.uint8) * 30,
              np.abs(_DEN).astype(np.uint8)),
    "bool": (_NUM != 0, _DEN != 0),
    "int32_bool": (_NUM.astype(np.int32), _DEN != 0),
}
# case name: (mx.np name, numerator, divisor)
DIVISION_CASES = {f"{n}_by_zero_{dt}": (n, *DIVISION_INPUTS[dt])
                  for n in DIVISION_NAMES for dt in DIVISION_INPUTS}


@pytest.mark.cuda
def test_division_by_zero_on_the_card_equals_the_cpu():
    """Every division case on the card equals the port on the CPU: the
    same values and the same dtype."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for case, (name, x, y) in sorted(DIVISION_CASES.items()):
        outs = []
        for ctx in (mx.gpu(0), mx.cpu()):
            with ctx:
                out = getattr(mx.np, name)(mx.np.array(x), mx.np.array(y))
                outs.append(out.asnumpy())
        got, want = outs
        assert got.dtype == want.dtype, (case, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=case)
