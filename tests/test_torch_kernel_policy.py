"""``ops.kernel_policy`` of the port against the JAX package's, on the
CPU: the parameter count and the saved-activation bytes equal the JAX
functions' on the same inputs; ``training_plan``'s batch equals the JAX
arithmetic when both are given the same ``hbm_bytes`` and no measured
anchor applies (and the measured clamp where one does);
``flash_kernel_plan`` is the port's CUDA dispatch
(``cuda_kernel_eligible``), not Pallas's."""

import pytest

from incubator_mxnet_tpu.ops import kernel_policy as jkp

from incubator_mxnet_tpu_torch.ops import kernel_policy as kp
from incubator_mxnet_tpu_torch.ops.flash_attention import \
    cuda_kernel_eligible

SHAPES = [(2, 128, 512, 1024, 128), (6, 512, 2048, 30522, 256),
          (12, 768, 3072, 30522, 512), (24, 1024, 4096, 30522, 512),
          (12, 768, 3072, 50257, 1024)]


@pytest.mark.parametrize("shape", SHAPES)
def test_param_count_equals_jax(shape):
    assert kp._param_count(*shape) == jkp._param_count(*shape)


@pytest.mark.parametrize("remat", [False, True, "dots"])
@pytest.mark.parametrize("dtype_bytes", [2, 4])
def test_saved_activation_bytes_equal_jax(remat, dtype_bytes):
    for L, u, h, _, T in SHAPES:
        for B in (1, 8, 32):
            assert kp._saved_activation_bytes(B, T, u, h, dtype_bytes,
                                              remat) == \
                jkp._saved_activation_bytes(B, T, u, h, dtype_bytes, remat)


@pytest.mark.parametrize("hbm", [2e9, 16e9, 40e9, 80e9])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_training_plan_batch_is_the_jax_arithmetic(hbm, dtype):
    for L, u, h, V, T in SHAPES:
        got = kp.training_plan(L, u, h, V, T, dtype=dtype, hbm_bytes=hbm)
        want = jkp.training_plan(L, u, h, V, T, dtype=dtype, hbm_bytes=hbm)
        assert set(got) == set(want)
        assert got["remat"] == want["remat"] == "dots"
        if (L, u) in kp._MEASURED_MAX_BATCH or \
                (L, u) in jkp._MEASURED_MAX_BATCH:
            # each package clamps to the batch its own hardware ran
            anchor = kp._MEASURED_MAX_BATCH.get((L, u))
            unclamped = dict(kp._MEASURED_MAX_BATCH)
            kp._MEASURED_MAX_BATCH.pop((L, u), None)
            try:
                free = kp.training_plan(L, u, h, V, T, dtype=dtype,
                                        hbm_bytes=hbm)["batch"]
            finally:
                kp._MEASURED_MAX_BATCH.clear()
                kp._MEASURED_MAX_BATCH.update(unclamped)
            assert got["batch"] == (free if anchor is None
                                    else min(free, anchor))
        else:
            assert got["batch"] == want["batch"]


def test_training_plan_defaults_to_the_card():
    plan = kp.training_plan(12, 768, 3072, 30522, 512)
    assert plan["batch"] == kp._MEASURED_MAX_BATCH[(12, 768)]
    assert plan["fwd_heads_per_program"] == plan["bwd_heads_per_program"] \
        == 1 and plan["dense"] is False
    assert kp.HBM_USABLE <= kp.HBM_BYTES


@pytest.mark.parametrize("D", [32, 64, 72, 128, 130, 256, 264])
@pytest.mark.parametrize("causal,Tk", [(False, None), (True, None),
                                       (True, 256)])
def test_flash_kernel_plan_is_the_cuda_dispatch(D, causal, Tk):
    plan = kp.flash_kernel_plan(512, 12, Tk=Tk, D=D, causal=causal)
    ok = cuda_kernel_eligible(D, causal, 512, 512 if Tk is None else Tk)
    assert plan["cuda"] is ok
    assert plan["heads_per_program"] == (1 if ok else None)
    assert plan["dense"] is False
    assert set(jkp.flash_kernel_plan(512, 12)) <= set(plan)
