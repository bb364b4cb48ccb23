"""The port's vision ops (``ops/vision.py``: UpSampling, BilinearSampler,
GridGenerator, SpatialTransformer, im2col / col2im, fft / ifft) against
the JAX package on the CPU: every case of the table
(``tests/test_torch_op_cases.py``) at its stated rtol (bf16 at 1e-2) and
each op's gradient against ``jax.vjp`` of the JAX op at rtol 1e-5 (or the
case's rtol, where larger); plus the properties of
``tests/test_vision_ops.py`` through the port's ``nd``: nearest
upsampling is repetition, bilinear upsampling keeps a constant, the
identity grid samples the input, out-of-range samples read zero, col2im
is the adjoint of im2col, and ifft(fft(x)) == d·x.
"""

import numpy as np
import pytest

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import nd

from test_torch_op_cases import case_ids, grad_names, ids
from torch_op_parity import gradient_equals_jax, op_equals_jax

CASE_IDS = case_ids("vision")


@pytest.mark.parametrize("name,i,dtype", CASE_IDS, ids=ids(CASE_IDS))
def test_op_equals_jax(name, i, dtype):
    op_equals_jax(name, i, dtype)


@pytest.mark.parametrize("name", grad_names({"vision"}))
def test_gradient_equals_jax_vjp(name):
    gradient_equals_jax(name)


@pytest.fixture(autouse=True)
def on_the_cpu():
    with mx.cpu():
        yield


def _identity_grid(B, H, W):
    xx, yy = np.meshgrid(np.linspace(-1, 1, W, dtype=np.float32),
                         np.linspace(-1, 1, H, dtype=np.float32))
    return np.broadcast_to(np.stack([xx, yy])[None], (B, 2, H, W)).copy()


def test_upsampling_nearest_and_bilinear():
    x = np.random.RandomState(0).randn(2, 3, 4, 5).astype(np.float32)
    out = nd.UpSampling(nd.array(x), scale=2, sample_type="nearest")
    np.testing.assert_array_equal(out.asnumpy(),
                                  x.repeat(2, axis=2).repeat(2, axis=3))
    a = np.random.RandomState(1).randn(1, 2, 8, 8).astype(np.float32)
    b = np.random.RandomState(2).randn(1, 3, 4, 4).astype(np.float32)
    out = nd.UpSampling(nd.array(a), nd.array(b), scale=1).asnumpy()
    np.testing.assert_array_equal(out[:, :2], a)
    np.testing.assert_array_equal(out[:, 2:], b.repeat(2, 2).repeat(2, 3))
    c = nd.UpSampling(nd.array(np.full((1, 2, 6, 6), 3.5, np.float32)),
                      scale=2, sample_type="bilinear").asnumpy()
    assert c.shape == (1, 2, 12, 12)
    np.testing.assert_allclose(c[:, :, 2:-2, 2:-2], 3.5, rtol=1e-5)


def test_samplers_and_grids():
    x = np.random.RandomState(3).randn(2, 3, 5, 7).astype(np.float32)
    out = nd.BilinearSampler(nd.array(x), nd.array(_identity_grid(2, 5, 7)))
    np.testing.assert_allclose(out.asnumpy(), x, rtol=1e-5, atol=1e-5)
    far = nd.BilinearSampler(nd.array(np.ones((1, 1, 4, 4), np.float32)),
                             nd.array(np.full((1, 2, 2, 2), -5.0,
                                              np.float32)))
    np.testing.assert_array_equal(far.asnumpy(), 0.0)
    grid = nd.GridGenerator(nd.array(np.array([[1, 0, 0, 0, 1, 0]],
                                              np.float32)),
                            transform_type="affine", target_shape=(4, 6))
    np.testing.assert_allclose(grid.asnumpy(), _identity_grid(1, 4, 6),
                               atol=1e-6)
    warp = nd.GridGenerator(nd.zeros((2, 2, 4, 5)), transform_type="warp")
    np.testing.assert_allclose(warp.asnumpy(), _identity_grid(2, 4, 5),
                               atol=1e-6)
    y = np.random.RandomState(5).randn(1, 2, 6, 6).astype(np.float32)
    shift = nd.SpatialTransformer(
        nd.array(y), nd.array(np.array([[1, 0, -2.0 / 5, 0, 1, 0]],
                                       np.float32)), target_shape=(6, 6))
    np.testing.assert_allclose(shift.asnumpy()[:, :, :, 1:], y[:, :, :, :-1],
                               rtol=1e-4, atol=1e-4)


def test_col2im_is_the_adjoint_of_im2col():
    rng = np.random.RandomState(8)
    x = rng.randn(1, 2, 6, 6).astype(np.float32)
    cols = nd.im2col(nd.array(x), kernel=(3, 3), stride=(1, 1))
    y = rng.randn(*cols.shape).astype(np.float32)
    back = nd.col2im(nd.array(y), output_size=(6, 6), kernel=(3, 3),
                     stride=(1, 1)).asnumpy()
    lhs = float((cols.asnumpy().astype(np.float64) * y).sum())
    assert abs(lhs - float((x.astype(np.float64) * back).sum())) \
        < 1e-4 * max(1.0, abs(lhs))


def test_fft_matches_numpy_and_ifft_is_unnormalized():
    x = np.random.RandomState(9).randn(3, 8).astype(np.float32)
    out = nd.contrib.fft(nd.array(x)).asnumpy()
    ref = np.fft.fft(x, axis=-1)
    np.testing.assert_allclose(out[:, 0::2], ref.real, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out[:, 1::2], ref.imag, rtol=1e-4, atol=1e-4)
    back = nd.contrib.ifft(nd.array(out)).asnumpy()
    np.testing.assert_allclose(back, 8 * x, rtol=1e-4, atol=1e-4)
