"""The operator case table of the port's registry, with no JAX in it:
numpy-built inputs, keywords and tolerances for every registered op, and
the card's test of every op against the port on the CPU.

``CASES[name]`` is a list of ``(make_inputs, keywords, rtol, bf16)``:
``make_inputs()`` returns the op's array inputs as numpy arrays (a
``(array, dtype)`` pair fixes one input's dtype), ``rtol`` is the f32
tolerance against the JAX package (0 exact, ``RED`` for reductions and
products whose summation order differs, ``TRANS`` for transcendental
functions whose polynomial approximations differ by a few ulps), and
``bf16`` asks for the case once more with its float inputs in bfloat16
(then at rtol 1e-2). ``BASE_CASES`` are the ops the port registered
first (``tests/test_torch_ndarray.py`` holds them against JAX);
``FAMILY`` sorts the rest by the test file that holds them against JAX
(``contrib`` and ``vision``: ``tests/test_torch_ops_contrib.py`` and
``tests/test_torch_ops_vision.py``; the detection ops' tied-score cases
come first).

Classes, as ``tests/test_op_gradient_sweep.py`` classifies the JAX
registry: ``NONDIFF`` (integer, boolean, constant or piecewise-constant
outputs, and the optimizer updates), ``CUSTOM_GRAD`` (heads whose
backward is the loss gradient), ``DISTRIBUTION`` (samplers, held by
their moments in ``MOMENTS``); every other op is differentiable and its
first case is its gradient case.

``test_ops_on_the_card_equal_the_cpu`` (``cuda``) runs every case on the
card and on the CPU through the port, f32 within ``CARD_RTOL`` (or the
case's rtol if larger) of the output's largest |entry|, bf16 within
2e-2; ``CHECKS`` compares the sign-ambiguous decompositions by
reconstruction and orthogonality instead; the samplers are held by their
moments on the card. It imports no JAX (``chip_smoke.py`` runs it with
``--noconftest``).
"""

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu_torch as mx
from incubator_mxnet_tpu_torch import nd
from incubator_mxnet_tpu_torch.ops import registry as treg

RS = np.random.RandomState


def f(*shape, lo=None, seed=0):
    a = RS(seed).randn(*shape).astype(np.float32)
    return np.abs(a) + lo if lo is not None else a


def ints(hi, *shape, lo=0, seed=1):
    return RS(seed).randint(lo, hi, shape).astype(np.int32)


def u(*shape, lo=-1.0, hi=1.0, seed=0):
    return RS(seed).uniform(lo, hi, shape).astype(np.float32)


def a32(x):
    return np.asarray(x, np.float32)


def i32(x):
    return np.asarray(x, np.int32)


def spd(n, seed=0, batch=()):
    m = RS(seed).randn(*batch, n, n).astype(np.float32)
    return (m @ np.swapaxes(m, -1, -2) +
            n * np.eye(n, dtype=np.float32)).astype(np.float32)


def lower(n, seed=0):
    """A well-conditioned lower-triangular matrix (its upper half is
    noise the triangular ops must not read)."""
    m = RS(seed).randn(n, n).astype(np.float32)
    return (np.tril(m, -1) * 0.3 + np.diag(np.abs(np.diag(m)) + 1.5)
            + np.triu(m, 1) * 7.0).astype(np.float32)


def with_special(*shape, seed=0):
    a = f(*shape, seed=seed)
    flat = a.reshape(-1)
    flat[1], flat[4] = np.nan, np.inf
    flat[-1] = -np.inf
    return a


def with_nan(*shape, seed=0):
    a = f(*shape, seed=seed)
    a.reshape(-1)[[1, 6]] = np.nan
    return a


TIES = np.array([[1, 3, 3, 2, 3], [0, 0, 1, 1, 0], [2, 2, 2, 2, 2]],
                np.float32)
N_DRAW = 20000

RED, TRANS = 1e-5, 2e-6
# name: (inputs, keywords, rtol, also bf16)
BASE_CASES = {
    "AdaptiveAvgPooling2D": [(lambda: [f(2, 3, 7, 5)],
                              dict(output_size=(3, 2)), RED, True),
                             (lambda: [f(2, 3, 8, 4)],
                              dict(output_size=2), RED, False)],
    "Activation": [(lambda: [f(3, 5)], dict(act_type=a), TRANS, True)
                   for a in ("relu", "sigmoid", "tanh", "softrelu",
                             "softsign")],
    "BatchNorm": [
        (lambda: [f(4, 3, 2), f(3, seed=2), f(3, seed=3), f(3, seed=4),
                  f(3, lo=0.5, seed=5)],
         dict(fix_gamma=False, training=t), RED, False)
        for t in (True, False)],
    "BlockGrad": [(lambda: [f(2, 3)], {}, 0, True)],
    "Convolution": [
        (lambda: [f(2, 3, 9, 8), f(4, 3, 3, 3, seed=2), f(4, seed=3)],
         dict(kernel=(3, 3), stride=(2, 1), pad=(1, 1), num_filter=4), RED,
         True),
        (lambda: [f(2, 4, 7), f(4, 1, 3, seed=2)],
         dict(kernel=(3,), num_filter=4, num_group=4, no_bias=True), RED,
         False)],
    "Deconvolution": [(lambda: [f(2, 3, 5, 4), f(3, 2, 3, 3, seed=2)],
                       dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                            adj=(1, 1), num_filter=2), RED, True)],
    "L2Normalization": [(lambda: [f(3, 4, 5)], dict(mode=m), RED, False)
                        for m in ("instance", "channel", "spatial")],
    "LRN": [(lambda: [f(2, 6, 3, 3)], dict(nsize=3), RED, False)],
    "Pooling": [
        (lambda: [f(2, 3, 7, 7)],
         dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type=t,
              pooling_convention=c), RED, True)
        for t in ("max", "avg", "sum") for c in ("valid", "full")] + [
        (lambda: [f(2, 3, 7, 7)],
         dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), pool_type="avg",
              pooling_convention="full", count_include_pad=False), RED,
         False),
        (lambda: [f(2, 3, 5, 4)], dict(global_pool=True, pool_type="avg"),
         RED, True)],
    "Cast": [(lambda: [f(2, 3) * 10], dict(dtype=d), 0, False)
             for d in ("bfloat16", "int32", "float32")],
    "Dropout": [(lambda: [f(4, 4)], dict(p=0.5), 0, True)],
    "Embedding": [(lambda: [ints(12, 3, 4, lo=-2), f(10, 6)],
                   dict(input_dim=10, output_dim=6), 0, True)],
    "FullyConnected": [
        (lambda: [f(4, 2, 3), f(5, 6, seed=2), f(5, seed=3)],
         dict(num_hidden=5), RED, True),
        (lambda: [f(4, 2, 3), f(5, 3, seed=2)],
         dict(num_hidden=5, no_bias=True, flatten=False), RED, True)],
    "GroupNorm": [(lambda: [f(2, 4, 3, 3), f(4, seed=2), f(4, seed=3)],
                   dict(num_groups=2), RED, False)],
    "InstanceNorm": [(lambda: [f(2, 3, 5), f(3, seed=2), f(3, seed=3)],
                      {}, RED, False)],
    "LayerNorm": [(lambda: [f(3, 8), f(8, seed=2), f(8, seed=3)],
                   dict(eps=1e-12), RED, True),
                  (lambda: [f(3, 4, 5), f(4, seed=2), f(4, seed=3)],
                   dict(axis=1), RED, False)],
    "LeakyReLU": [(lambda: [f(3, 4)], dict(act_type=a, slope=0.3), TRANS,
                   True) for a in ("leaky", "elu", "selu", "gelu")] + [
        (lambda: [f(2, 3, 4), f(3, seed=2)], dict(act_type="prelu"), 0,
         False)],
    "_slice_index": [(lambda: [f(4, 5)], dict(index=(slice(1, 3), 2)), 0,
                      True)],
    "abs": [(lambda: [f(3, 4)], {}, 0, True)],
    "add_n": [(lambda: [f(3, 2), f(3, 2, seed=2), f(3, 2, seed=3)], {}, 0,
               True)],
    "argmax": [(lambda: [f(4, 6)], dict(axis=1), 0, False),
               (lambda: [f(4, 6)], {}, 0, False)],
    "argmin": [(lambda: [f(4, 6)], dict(axis=0, keepdims=True), 0, False)],
    "batch_dot": [(lambda: [f(2, 3, 4), f(2, 5, 4, seed=2)],
                   dict(transpose_b=True), RED, True),
                  (lambda: [f(2, 4, 3), f(2, 4, 5, seed=2)],
                   dict(transpose_a=True), RED, False)],
    "batch_take": [(lambda: [f(2, 6, 3), ints(6, 2, 4)], {}, 0, True)],
    "broadcast_add": [(lambda: [f(3, 1, 4), f(2, 4, seed=2)], {}, 0, True)],
    "broadcast_div": [(lambda: [f(3, 4), f(1, 4, lo=0.5, seed=2)], {}, 0,
                       True)],
    "broadcast_equal": [(lambda: [ints(3, 4, 5).astype(np.float32),
                                  ints(3, 4, 5, seed=2).astype(np.float32)],
                         {}, 0, False)],
    "broadcast_greater": [(lambda: [f(3, 4), f(3, 4, seed=2)], {}, 0,
                           False)],
    "broadcast_greater_equal": [(lambda: [f(3, 4), f(1, 4, seed=2)], {}, 0,
                                 False)],
    "broadcast_hypot": [(lambda: [f(3, 4), f(3, 4, seed=2)], {}, TRANS,
                         False)],
    "broadcast_lesser": [(lambda: [f(3, 4), f(3, 4, seed=2)], {}, 0,
                          False)],
    "broadcast_lesser_equal": [(lambda: [f(3, 4), f(3, 1, seed=2)], {}, 0,
                                False)],
    "broadcast_like": [(lambda: [f(1, 4), f(3, 4, seed=2)], {}, 0, True)],
    "broadcast_logical_and": [(lambda: [ints(2, 3, 4).astype(np.float32),
                                        ints(2, 3, 4, seed=2)
                                        .astype(np.float32)], {}, 0,
                               False)],
    "broadcast_logical_or": [(lambda: [ints(2, 3, 4).astype(np.float32),
                                       ints(2, 3, 4, seed=2)
                                       .astype(np.float32)], {}, 0, False)],
    "broadcast_logical_xor": [(lambda: [ints(2, 3, 4).astype(np.float32),
                                        ints(2, 3, 4, seed=2)
                                        .astype(np.float32)], {}, 0,
                               False)],
    "broadcast_maximum": [(lambda: [f(3, 4), f(3, 4, seed=2)], {}, 0,
                           True)],
    "broadcast_minimum": [(lambda: [f(3, 4), f(3, 4, seed=2)], {}, 0,
                           True)],
    "broadcast_mod": [(lambda: [f(3, 4) * 5, f(3, 4, lo=0.5, seed=2)], {},
                       TRANS, False)],
    "broadcast_mul": [(lambda: [f(3, 4), f(4, seed=2)], {}, 0, True)],
    "broadcast_not_equal": [(lambda: [ints(3, 4, 5).astype(np.float32),
                                      ints(3, 4, 5, seed=2)
                                      .astype(np.float32)], {}, 0, False)],
    "broadcast_power": [(lambda: [f(3, 4, lo=0.1), f(3, 4, seed=2)], {},
                         TRANS, False)],
    "broadcast_sub": [(lambda: [f(3, 4), f(3, 4, seed=2)], {}, 0, True)],
    "broadcast_to": [(lambda: [f(1, 4)], dict(shape=(3, 0)), 0, True)],
    "ceil": [(lambda: [f(3, 4) * 3], {}, 0, False)],
    "clip": [(lambda: [f(3, 4)], dict(a_min=-0.5, a_max=0.7), 0, True)],
    "concat": [(lambda: [f(2, 3), f(2, 4, seed=2)], dict(dim=1), 0, True)],
    "cos": [(lambda: [f(3, 4)], {}, TRANS, False)],
    "dot": [(lambda: [f(3, 4), f(4, 5, seed=2)], {}, RED, True),
            (lambda: [f(4, 3), f(5, 4, seed=2)],
             dict(transpose_a=True, transpose_b=True), RED, False),
            (lambda: [f(2, 3, 4), f(4, 5, seed=2)], {}, RED, False)],
    "erf": [(lambda: [f(3, 4)], {}, TRANS, False)],
    "exp": [(lambda: [f(3, 4)], {}, TRANS, True)],
    "expand_dims": [(lambda: [f(3, 4)], dict(axis=1), 0, True)],
    "expm1": [(lambda: [f(3, 4)], {}, TRANS, False)],
    "flatten": [(lambda: [f(2, 3, 4)], {}, 0, True)],
    "floor": [(lambda: [f(3, 4) * 3], {}, 0, False)],
    "full_like": [(lambda: [f(3, 4)], dict(fill_value=2.5), 0, True)],
    "gelu": [(lambda: [f(3, 4)], {}, TRANS, True)],
    "identity": [(lambda: [f(3, 4)], {}, 0, True)],
    "log": [(lambda: [f(3, 4, lo=0.1)], {}, TRANS, True)],
    "log1p": [(lambda: [f(3, 4, lo=0.0)], {}, TRANS, False)],
    "log_softmax": [(lambda: [f(3, 7)], dict(axis=-1), RED, True)],
    "logsumexp": [(lambda: [f(3, 7)], dict(axis=-1), RED, True),
                  (lambda: [f(3, 7)], dict(axis=0, keepdims=True), RED,
                   False)],
    "max": [(lambda: [f(3, 4, 5)], dict(axis=(0, 2)), 0, True)],
    "mean": [(lambda: [f(3, 4, 5)], dict(axis=1, exclude=True), RED,
              False), (lambda: [f(3, 4)], {}, RED, True)],
    "min": [(lambda: [f(3, 4, 5)], dict(axis=-1, keepdims=True), 0,
             False)],
    "negative": [(lambda: [f(3, 4)], {}, 0, True)],
    "norm": [(lambda: [f(3, 4)], {}, RED, False),
             (lambda: [f(3, 4)], dict(ord=1, axis=1), RED, False),
             (lambda: [f(3, 4, 2)], dict(axis=(1, 2), keepdims=True), RED,
              False)],
    "pad": [(lambda: [f(2, 3, 4)],
             dict(pad_width=(0, 0, 1, 2, 2, 1), constant_value=0.5), 0,
             True),
            (lambda: [f(2, 3, 4, 5)],
             dict(mode="reflect", pad_width=(0, 0, 0, 0, 2, 1, 1, 3)), 0,
             False),
            (lambda: [f(2, 3, 4, 5)],
             dict(mode="edge", pad_width=(0, 0, 0, 0, 1, 1, 0, 2)), 0,
             True)],
    "one_hot": [(lambda: [ints(6, 3, 2, lo=-1)],
                 dict(depth=5, on_value=2.0, off_value=-1.0), 0, False),
                (lambda: [ints(5, 4)], dict(depth=5, dtype="int32"), 0,
                 False)],
    "ones_like": [(lambda: [f(3, 4)], {}, 0, True)],
    "pick": [(lambda: [f(4, 5), ints(7, 4, lo=-1)], dict(axis=-1), 0,
              True),
             (lambda: [f(4, 5), ints(4, 5)], dict(axis=0, keepdims=True), 0,
              False)],
    "prod": [(lambda: [f(3, 4)], dict(axis=1), RED, False)],
    "reciprocal": [(lambda: [f(3, 4, lo=0.5)], {}, 0, True)],
    "relu": [(lambda: [f(3, 4)], {}, 0, True)],
    "reshape": [(lambda: [f(2, 3, 4)], dict(shape=s), 0, True)
                for s in ((0, -1), (-3, 0), (6, -1), (-4, 1, 2, 0, 0),
                          (-2,), (4, 0, -1))] + [
        (lambda: [f(2, 3, 4)], dict(shape=(0, -1), reverse=True), 0,
         False)],
    "reshape_like": [(lambda: [f(2, 6), f(3, 4, seed=2)], {}, 0, True)],
    "round": [(lambda: [f(3, 4) * 3], {}, 0, False)],
    "rsqrt": [(lambda: [f(3, 4, lo=0.2)], {}, TRANS, False)],
    "scaled_dot_product_attention": [
        (lambda: [f(2, 5, 2, 4), f(2, 5, 2, 4, seed=2),
                  f(2, 5, 2, 4, seed=3), np.array([5, 3], np.int32)],
         dict(flash=False), RED, False)],
    "sigmoid": [(lambda: [f(3, 4)], {}, TRANS, True)],
    "sign": [(lambda: [f(3, 4)], {}, 0, True)],
    "sin": [(lambda: [f(3, 4)], {}, TRANS, False)],
    "slice": [(lambda: [f(4, 5, 3)],
               dict(begin=(1, None), end=(3, 4)), 0, True),
              (lambda: [f(6, 5)],
               dict(begin=(0, 1), end=(6, 5), step=(2, 2)), 0, False)],
    "slice_axis": [(lambda: [f(4, 5)], dict(axis=1, begin=1, end=4), 0,
                    True),
                   (lambda: [f(4, 5)], dict(axis=-2, begin=2, end=None), 0,
                    False)],
    "smooth_l1": [(lambda: [f(3, 4)], dict(scalar=2.0), 0, False)],
    "softmax": [(lambda: [f(3, 7)], {}, RED, True),
                (lambda: [f(3, 7), np.array([7, 2, 4], np.int32)],
                 dict(axis=-1, temperature=2.0), RED, False)],
    "softmax_cross_entropy": [(lambda: [f(4, 6), ints(6, 4)], {}, RED,
                               False)],
    "softsign": [(lambda: [f(3, 4)], {}, 0, False)],
    "split": [(lambda: [f(4, 6)], dict(num_outputs=3, axis=1), 0, True),
              (lambda: [f(4, 6)],
               dict(num_outputs=2, axis=0, squeeze_axis=False), 0, False)],
    "sqrt": [(lambda: [f(3, 4, lo=0.0)], {}, 0, True)],
    "square": [(lambda: [f(3, 4)], {}, 0, True)],
    "squeeze": [(lambda: [f(3, 1, 4)], dict(axis=1), 0, True)],
    "stack": [(lambda: [f(2, 3), f(2, 3, seed=2)], dict(axis=1), 0, True)],
    "sum": [(lambda: [f(3, 4, 5)], dict(axis=(0, 2)), RED, True),
            (lambda: [f(3, 4, 5)], dict(axis=1, exclude=True,
                                        keepdims=True), RED, False)],
    "swapaxes": [(lambda: [f(2, 3, 4)], dict(dim1=0, dim2=2), 0, True)],
    "take": [(lambda: [f(5, 3), ints(8, 2, 3, lo=-2)], {}, 0, True),
             (lambda: [f(5, 3), ints(8, 4, lo=-2)],
              dict(axis=1, mode="wrap"), 0, False)],
    "tanh": [(lambda: [f(3, 4)], {}, TRANS, True)],
    "transpose": [(lambda: [f(2, 3, 4)], dict(axes=(1, 2, 0)), 0, True),
                  (lambda: [f(2, 3, 4)], {}, 0, False)],
    "where": [(lambda: [ints(2, 3, 4).astype(np.float32), f(3, 4),
                        f(3, 4, seed=2)], {}, 0, True)],
    "zeros_like": [(lambda: [f(3, 4)], {}, 0, True)],
}


def _scalar_cases():
    out = {}
    for name, x, s, rtol, bf in [
            ("_plus_scalar", lambda: f(3, 4), 0.7, 0, True),
            ("_minus_scalar", lambda: f(3, 4), 0.7, 0, True),
            ("_rminus_scalar", lambda: f(3, 4), 0.7, 0, True),
            ("_mul_scalar", lambda: f(3, 4), -1.3, 0, True),
            ("_div_scalar", lambda: f(3, 4), 1.7, TRANS, True),
            ("_rdiv_scalar", lambda: f(3, 4, lo=0.5), 1.7, TRANS, False),
            ("_mod_scalar", lambda: f(3, 4) * 3, 1.3, TRANS, False),
            ("_rmod_scalar", lambda: f(3, 4, lo=0.5), 2.0, TRANS, False),
            ("_power_scalar", lambda: f(3, 4, lo=0.3), 2.5, TRANS, False),
            ("_rpower_scalar", lambda: f(3, 4), 2.0, TRANS, False),
            ("_maximum_scalar", lambda: f(3, 4), 0.1, 0, True),
            ("_minimum_scalar", lambda: f(3, 4), 0.1, 0, True),
            ("_equal_scalar", lambda: a32([[1, 2], [2, 3]]), 2.0, 0, False),
            ("_not_equal_scalar", lambda: a32([[1, 2], [2, 3]]), 2.0, 0,
             False),
            ("_greater_scalar", lambda: f(3, 4), 0.2, 0, False),
            ("_greater_equal_scalar", lambda: a32([1, 2, 3]), 2.0, 0,
             False),
            ("_lesser_scalar", lambda: f(3, 4), 0.2, 0, False),
            ("_lesser_equal_scalar", lambda: a32([1, 2, 3]), 2.0, 0,
             False)]:
        out[name] = [((lambda x=x: [x()]), dict(scalar=s), rtol, bf)]
    return out


def _unary_cases():
    neg = a32([-0.5, -1.5, -2.3, 0.7, 2.2, 4.5])
    halves = a32([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 0.3, -2.7])
    out = {}
    for name, x, rtol, bf in [
            ("arccos", lambda: u(3, 4, lo=-0.8, hi=0.8), TRANS, False),
            ("arccosh", lambda: u(3, 4, lo=1.2, hi=3.0), TRANS, False),
            ("arcsin", lambda: u(3, 4, lo=-0.8, hi=0.8), TRANS, False),
            ("arcsinh", lambda: f(3, 4), TRANS, False),
            ("arctan", lambda: f(3, 4), TRANS, False),
            ("arctanh", lambda: u(3, 4, lo=-0.8, hi=0.8), TRANS, False),
            ("cbrt", lambda: f(3, 4), TRANS, False),
            ("cosh", lambda: f(3, 4), TRANS, False),
            ("degrees", lambda: f(3, 4), TRANS, True),
            ("erfinv", lambda: u(3, 4, lo=-0.9, hi=0.9), TRANS, False),
            ("fix", lambda: f(3, 4) * 3, 0, False),
            ("gamma", lambda: u(3, 4, lo=0.5, hi=3.0), 1e-5, False),
            ("gammaln", lambda: u(3, 4, lo=0.5, hi=3.0), 1e-5, False),
            ("hard_sigmoid", lambda: f(3, 4) * 3, 0, True),
            ("log10", lambda: f(3, 4, lo=0.1), TRANS, True),
            ("log2", lambda: f(3, 4, lo=0.1), TRANS, True),
            ("logical_not", lambda: ints(2, 3, 4).astype(np.float32), 0,
             False),
            ("radians", lambda: f(3, 4), TRANS, True),
            ("rcbrt", lambda: f(3, 4, lo=0.3), TRANS, False),
            ("rint", lambda: halves, 0, False),
            ("sinh", lambda: f(3, 4), TRANS, False),
            ("tan", lambda: f(3, 4), TRANS, False),
            ("trunc", lambda: f(3, 4) * 3, 0, False)]:
        out[name] = [((lambda x=x: [x()]), {}, rtol, bf)]
    out["gamma"].append((lambda: [neg], {}, 1e-5, False))
    out["gammaln"].append((lambda: [neg], {}, 1e-5, False))
    out["rint"].append((lambda: [f(3, 4) * 3], {}, 0, False))
    return out


TENSOR_CASES = {
    **_scalar_cases(), **_unary_cases(),
    "nansum": [(lambda: [with_nan(3, 4)], dict(axis=1), RED, False),
               (lambda: [with_nan(3, 4)], {}, RED, False)],
    "nanprod": [(lambda: [with_nan(3, 4)], dict(axis=0), RED, False)],
    "argmax_channel": [(lambda: [f(3, 5)], {}, 0, False)],
    "shape_array": [(lambda: [f(2, 3, 4)], {}, 0, False)],
    "size_array": [(lambda: [f(2, 3, 4)], {}, 0, False)],
    "flip": [(lambda: [f(2, 3, 4)], dict(axis=1), 0, True),
             (lambda: [f(2, 3, 4)], dict(axis=(0, 2)), 0, False)],
    "tile": [(lambda: [f(2, 3)], dict(reps=(2, 2)), 0, True),
             (lambda: [f(2, 3)], dict(reps=3), 0, False)],
    "repeat": [(lambda: [f(2, 3)], dict(repeats=2, axis=1), 0, True),
               (lambda: [f(2, 3)], dict(repeats=2), 0, False)],
    "split_v2": [(lambda: [f(4, 6)], dict(indices_or_sections=3, axis=1),
                  0, True),
                 (lambda: [f(4, 6)],
                  dict(indices_or_sections=(1, 4), axis=1), 0, False),
                 (lambda: [f(3, 2)],
                  dict(indices_or_sections=3, squeeze_axis=True), 0,
                  False)],
    "slice_like": [(lambda: [f(4, 5), f(2, 3, seed=2)], {}, 0, True),
                   (lambda: [f(4, 5), f(2, 3, seed=2)], dict(axes=(1,)),
                    0, False)],
    "broadcast_axis": [(lambda: [f(1, 3, 1)], dict(axis=(0, 2),
                                                   size=(2, 4)), 0, True)],
    "amp_cast": [(lambda: [f(3, 4)], dict(dtype="bfloat16"), 0, False),
                 (lambda: [f(3, 4)], dict(dtype="float16"), 0, False)],
    "diag": [(lambda: [f(4)], dict(k=1), 0, True),
             (lambda: [f(3, 4)], dict(k=-1), 0, False),
             (lambda: [f(2, 3, 3)], {}, 0, False)],
    "tril": [(lambda: [f(4, 5)], dict(k=-1), 0, True),
             (lambda: [f(2, 3, 3)], {}, 0, False)],
    "triu": [(lambda: [f(4, 5)], dict(k=1), 0, True),
             (lambda: [f(2, 3, 3)], {}, 0, False)],
    "meshgrid": [(lambda: [f(3), f(2, seed=2)], {}, 0, True),
                 (lambda: [f(3), f(2, seed=2)], dict(indexing="ij"), 0,
                  False)],
    "depth_to_space": [(lambda: [f(1, 8, 2, 3)], dict(block_size=2), 0,
                        True)],
    "space_to_depth": [(lambda: [f(1, 2, 4, 6)], dict(block_size=2), 0,
                        True)],
    "gather_nd": [(lambda: [f(3, 4), i32([[0, 2, 1], [1, 3, 0]])], {}, 0,
                   True)],
    "scatter_nd": [(lambda: [f(3), i32([[0, 2, 2]])], dict(shape=(4,)), 0,
                    False)],
    "index_copy": [(lambda: [f(4, 3), i32([0, 2]), f(2, 3, seed=2)], {}, 0,
                    True)],
    "index_add": [(lambda: [f(4, 3), i32([1, 1, 3]), f(3, 3, seed=2)], {},
                   TRANS, False)],
    "boolean_mask": [(lambda: [f(4, 3), i32([1, 0, 1, 1])], {}, 0, True),
                     (lambda: [f(4, 3), i32([1, 0, 1])], dict(axis=1), 0,
                      False)],
    "SequenceMask": [
        (lambda: [f(5, 3, 2), a32([2, 5, 3])],
         dict(use_sequence_length=True, value=-1.0), 0, True),
        (lambda: [f(3, 5, 2), a32([2, 5, 3])],
         dict(use_sequence_length=True, axis=1), 0, False)],
    "SequenceLast": [(lambda: [f(5, 3, 2), a32([2, 5, 1])],
                      dict(use_sequence_length=True), 0, True),
                     (lambda: [f(5, 3, 2)], {}, 0, False)],
    "SequenceReverse": [(lambda: [f(5, 3, 2), a32([2, 5, 3])],
                         dict(use_sequence_length=True), 0, True),
                        (lambda: [f(5, 3, 2)], {}, 0, False)],
    "topk": [(lambda: [f(3, 6)], dict(k=3, ret_typ="value"), 0, True),
             (lambda: [f(3, 6)], dict(k=2), 0, False),
             (lambda: [f(3, 6)], dict(k=2, ret_typ="both", axis=0), 0,
              False),
             (lambda: [f(3, 6)], dict(k=2, ret_typ="mask"), 0, False),
             (lambda: [f(3, 6)], dict(k=2, is_ascend=True,
                                      dtype="int32"), 0, False),
             (lambda: [TIES], dict(k=3, ret_typ="both"), 0, False),
             (lambda: [TIES], dict(k=3, ret_typ="both", is_ascend=True),
              0, False)],
    "sort": [(lambda: [f(3, 6)], {}, 0, True),
             (lambda: [f(3, 6)], dict(axis=0, is_ascend=False), 0, False)],
    "argsort": [(lambda: [f(3, 6)], {}, 0, False),
                (lambda: [TIES], {}, 0, False),
                (lambda: [TIES], dict(is_ascend=False, dtype="int32"), 0,
                 False)],
    "shuffle": [(lambda: [np.arange(24, dtype=np.float32).reshape(8, 3)],
                 {}, 0, False)],
    "make_loss": [(lambda: [f(3, 4)], dict(grad_scale=2.0,
                                           normalization="batch"), 0, True)],
    "LinearRegressionOutput": [(lambda: [f(4, 3), f(4, 3, seed=2)],
                                dict(grad_scale=0.5), 0, True)],
}

MISC_NN_CASES = {
    "khatri_rao": [(lambda: [f(2, 3), f(4, 3, seed=2)], {}, 0, False)],
    "digamma": [(lambda: [u(3, 4, lo=0.5, hi=3.0)], {}, 1e-5, False)],
    "cumsum": [(lambda: [f(3, 4)], dict(axis=1), RED, True),
               (lambda: [f(3, 4)], {}, RED, False)],
    "cumprod": [(lambda: [f(3, 4, lo=0.5)], dict(axis=0), RED, False)],
    "moments": [(lambda: [f(3, 4, 5)], dict(axes=(0, 2)), RED, False),
                (lambda: [f(3, 4)], dict(axes=(1,), keepdims=True), RED,
                 False)],
    "unravel_index": [(lambda: [a32([0, 5, 11, 13, -3])],
                       dict(shape=(3, 4)), 0, False)],
    "ravel_multi_index": [(lambda: [a32([[0, 1, 2], [3, 0, 1]])],
                           dict(shape=(3, 4)), 0, False)],
    "choose_element_0index": [(lambda: [f(3, 4), a32([0, 2, 1])], {}, 0,
                               False)],
    "fill_element_0index": [(lambda: [f(3, 4), f(3, seed=2),
                                      a32([0, 2, 1])], {}, 0, False)],
    "Correlation": [
        (lambda: [f(1, 2, 5, 5), f(1, 2, 5, 5, seed=2)], {}, RED, False),
        (lambda: [f(1, 2, 6, 6), f(1, 2, 6, 6, seed=2)],
         dict(kernel_size=3, max_displacement=2, stride2=2, pad_size=2),
         RED, False),
        (lambda: [f(1, 2, 5, 5), f(1, 2, 5, 5, seed=2)],
         dict(is_multiply=False), RED, False)],
    "Crop": [(lambda: [f(1, 2, 5, 6)],
              dict(num_args=1, h_w=(3, 4), offset=(1, 1)), 0, True),
             (lambda: [f(1, 2, 5, 6), f(1, 1, 3, 3, seed=2)],
              dict(num_args=2, center_crop=True), 0, False)],
    "LogisticRegressionOutput": [(lambda: [f(4, 3), u(4, 3, lo=0, hi=1)],
                                  dict(grad_scale=2.0), TRANS, False)],
    "MAERegressionOutput": [(lambda: [f(4, 3), f(4, 3, seed=2)], {}, 0,
                             False)],
    "SVMOutput": [(lambda: [f(4, 5), ints(5, 4).astype(np.float32)], {}, 0,
                   False),
                  (lambda: [f(4, 5), ints(5, 4).astype(np.float32)],
                   dict(use_linear=True, margin=0.5), 0, False)],
    "amp_multicast": [
        (lambda: [f(3), (f(3, seed=2), "bfloat16")], dict(num_outputs=2),
         0, False),
        (lambda: [f(3), (f(3, seed=2), "bfloat16")],
         dict(num_outputs=2, cast_narrow=True), 0, False)],
    "all_finite": [(lambda: [f(3, 4)], {}, 0, False),
                   (lambda: [with_special(3, 4)], {}, 0, False)],
    "multi_all_finite": [(lambda: [f(3), f(2, 2, seed=2)],
                          dict(num_arrays=2), 0, False),
                         (lambda: [f(3), with_nan(2, 4)],
                          dict(num_arrays=2), 0, False)],
    "BilinearResize2D": [
        (lambda: [f(1, 2, 3, 4)], dict(height=5, width=7), 1e-5, True),
        (lambda: [f(1, 2, 3, 4)], dict(scale_height=2.0, scale_width=1.5),
         1e-5, False),
        (lambda: [f(1, 2, 3, 4), f(1, 1, 4, 6, seed=2)], dict(mode="like"),
         1e-5, False)],
    "index_array": [(lambda: [f(2, 3)], {}, 0, False),
                    (lambda: [f(2, 3, 2)], dict(axes=(2, 0)), 0, False)],
    "quadratic": [(lambda: [f(3, 4)], dict(a=0.3, b=-0.7, c=1.1), TRANS,
                   True)],
    "allclose": [(lambda: [f(3, 4), f(3, 4) + 1e-7], {}, 0, False),
                 (lambda: [f(3, 4), f(3, 4, seed=2)], {}, 0, False)],
    "arange_like": [(lambda: [f(2, 3)], dict(start=1.0, step=0.5), 0,
                     False),
                    (lambda: [f(2, 5)], dict(axis=1, repeat=2), 0, False)],
    "histogram": [(lambda: [f(50)], dict(bins=5), 1e-6, False),
                  (lambda: [f(50)], dict(bins=4, range=(-1.0, 1.0)), 0,
                   False),
                  (lambda: [f(50), a32([-2.0, -0.5, 0.0, 0.3, 2.0])], {},
                   0, False),
                  (lambda: [np.full((6,), 2.0, np.float32)], dict(bins=3),
                   0, False)],
    "isnan": [(lambda: [with_special(3, 4)], {}, 0, True)],
    "isinf": [(lambda: [with_special(3, 4)], {}, 0, True)],
    "isfinite": [(lambda: [with_special(3, 4)], {}, 0, True)],
    "softmin": [(lambda: [f(3, 5)], {}, RED, True)],
    "SoftmaxActivation": [(lambda: [f(2, 3, 4)], {}, RED, True),
                          (lambda: [f(2, 3, 4)], dict(mode="channel"), RED,
                           False)],
    "SoftmaxOutput": [
        (lambda: [f(4, 5), a32([0, 2, 4, 1])], {}, RED, True),
        (lambda: [f(4, 5), a32([0, 2, 4, 1])],
         dict(use_ignore=True, ignore_label=2, normalization="valid",
              grad_scale=2.0), RED, False),
        (lambda: [f(2, 3, 4), a32([[0, 2, 1, 1], [2, 0, 0, 1]])],
         dict(multi_output=True, normalization="batch"), RED, False),
        (lambda: [f(4, 5), a32([[0], [2], [4], [1]])],
         dict(smooth_alpha=0.1), RED, False)],
    "CTCLoss": [
        (lambda: [f(6, 3, 5), a32([[1, 2, -1], [3, 3, 4], [2, -1, -1]])],
         {}, RED, False),
        (lambda: [f(6, 3, 5), a32([[1, 2, 0], [3, 3, 3], [2, 1, 0]]),
                  a32([6, 5, 4]), a32([2, 3, 2])],
         dict(use_data_lengths=True, use_label_lengths=True), RED, False),
        (lambda: [f(6, 3, 5), a32([[0, 1, -1], [3, 3, 3], [2, -1, -1]])],
         dict(blank_label="last"), RED, False)],
}

RANDOM_CASES = {
    "random_uniform": [(lambda: [], dict(low=-1.0, high=3.0,
                                         shape=(N_DRAW,)), 0, False)],
    "random_normal": [(lambda: [], dict(loc=1.5, scale=2.0,
                                        shape=(N_DRAW,)), 0, False)],
    "random_gamma": [(lambda: [], dict(alpha=3.0, beta=0.5,
                                       shape=(N_DRAW,)), 0, False)],
    "random_exponential": [(lambda: [], dict(lam=2.0, shape=(N_DRAW,)), 0,
                            False)],
    "random_poisson": [(lambda: [], dict(lam=3.0, shape=(N_DRAW,)), 0,
                        False)],
    "random_randint": [(lambda: [], dict(low=-2, high=5, shape=(N_DRAW,)),
                        0, False)],
    "random_bernoulli": [(lambda: [], dict(p=0.3, shape=(N_DRAW,)), 0,
                          False)],
    "random_laplace": [(lambda: [], dict(loc=0.5, scale=1.5,
                                         shape=(N_DRAW,)), 0, False)],
    "random_randn": [(lambda: [], dict(loc=-1.0, scale=0.5), 0, False)],
    "random_negative_binomial": [(lambda: [], dict(k=3, p=0.4,
                                                   shape=(N_DRAW,)), 0,
                                  False)],
    "random_generalized_negative_binomial": [
        (lambda: [], dict(mu=2.0, alpha=0.5, shape=(N_DRAW,)), 0, False)],
    "sample_uniform": [(lambda: [a32([0.0, 2.0]), a32([1.0, 5.0])],
                        dict(shape=(N_DRAW,)), 0, False)],
    "sample_normal": [(lambda: [a32([0.0, -2.0]), a32([1.0, 0.5])],
                       dict(shape=(N_DRAW,)), 0, False)],
    "sample_gamma": [(lambda: [a32([2.0, 5.0]), a32([1.0, 0.5])],
                      dict(shape=(N_DRAW,)), 0, False)],
    "sample_exponential": [(lambda: [a32([1.0, 4.0])],
                            dict(shape=(N_DRAW,)), 0, False)],
    "sample_poisson": [(lambda: [a32([1.0, 6.0])], dict(shape=(N_DRAW,)),
                        0, False)],
    "sample_negative_binomial": [(lambda: [a32([2.0, 5.0]),
                                           a32([0.5, 0.7])],
                                  dict(shape=(N_DRAW,)), 0, False)],
    "sample_generalized_negative_binomial": [
        (lambda: [a32([2.0, 3.0]), a32([0.5, 0.0])], dict(shape=(N_DRAW,)),
         0, False)],
    "sample_multinomial": [(lambda: [a32([[0.2, 0.5, 0.3],
                                          [0.7, 0.1, 0.2]])],
                            dict(shape=(N_DRAW,)), 0, False)],
}

# the updates at rtol 1e-6: the JAX reference is compiled, and XLA may
# contract w - lr * g into one fused multiply-add (an ulp)
_W, _G, _M = (lambda: f(3, 4)), (lambda: f(3, 4, seed=2)), \
    (lambda: f(3, 4, seed=3) * 0.1)
_V = (lambda: f(3, 4, lo=0.1, seed=4) * 0.01)


def _opt(arrays, rtol=1e-6, **kw):
    return [(lambda: [a() for a in arrays], kw, rtol, False)]


OPTIMIZER_CASES = {
    "sgd_update": _opt([_W, _G], lr=0.1, wd=0.01, rescale_grad=0.5,
                       clip_gradient=0.8),
    "sgd_mom_update": _opt([_W, _G, _M], lr=0.1, momentum=0.9, wd=0.01),
    "nag_mom_update": _opt([_W, _G, _M], lr=0.1, momentum=0.9, wd=0.01),
    "adam_update": _opt([_W, _G, _M, _V], lr=0.01, wd=0.01,
                        clip_gradient=1.0),
    "adamw_update": _opt([_W, _G, _M, _V], lr=0.01, wd=0.01, eta=0.5),
    "rmsprop_update": _opt([_W, _G, _V], lr=0.01, wd=0.01,
                           clip_weights=0.5),
    "rmspropalex_update": _opt([_W, _G, _V, _M, _M], lr=0.01),
    "ftrl_update": _opt([_W, _G, _M, _V], lr=0.1, wd=0.01),
    "signsgd_update": _opt([_W, _G], lr=0.1, wd=0.01),
    "signum_update": _opt([_W, _G, _M], lr=0.1, momentum=0.9, wd_lh=0.01),
    "lamb_update_phase1": _opt([_W, _G, _M, _V], t=3, wd=0.01),
    "lamb_update_phase2": _opt([_W, _G], rtol=1e-5, lr=0.01,
                               lower_bound=0.1, upper_bound=10.0),
    # 1e-4: with a Python ``t`` the port forms the bias corrections in
    # double precision, the JAX op in f32 (1 - 0.999^2 loses ~3e-5)
    "ftml_update": _opt([_W, _G, _M, _V, _M], rtol=1e-4, lr=0.01, t=2,
                        wd=0.01),
    "adagrad_update": _opt([_W, _G, _V], lr=0.1, wd=0.01),
    "adadelta_update": _opt([_W, _G, _V, _V], wd=0.01),
    "mp_sgd_update": [(lambda: [(_W(), "bfloat16"), (_G(), "bfloat16"),
                                _W()], dict(lr=0.1, wd=0.01), 1e-6, False)],
    "mp_sgd_mom_update": [(lambda: [(_W(), "bfloat16"), (_G(), "bfloat16"),
                                    _M(), _W()],
                           dict(lr=0.1, momentum=0.9), 1e-6, False)],
    "mp_nag_mom_update": [(lambda: [(_W(), "bfloat16"), (_G(), "bfloat16"),
                                    _M(), _W()],
                           dict(lr=0.1, momentum=0.9), 1e-6, False)],
    "mp_adam_update": [(lambda: [(_W(), "bfloat16"), (_G(), "bfloat16"),
                                 _M(), _V(), _W()], dict(lr=0.01), 1e-6,
                        False)],
    "mp_adamw_update": [(lambda: [(_W(), "bfloat16"), (_G(), "bfloat16"),
                                  _M(), _V(), _W()], dict(lr=0.01, wd=0.1),
                         1e-6, False)],
    "multi_sgd_update": _opt([_W, lambda: f(2), _G, lambda: f(2, seed=5)],
                             lrs=[0.1, 0.2], wds=[0.0, 0.01]),
    "multi_sgd_mom_update": _opt(
        [_W, lambda: f(2), _G, lambda: f(2, seed=5), _M,
         lambda: f(2, seed=6)], lrs=[0.1, 0.2], wds=[0.0, 0.01],
        momentum=0.9),
    "multi_mp_sgd_update": [(lambda: [
        (_W(), "bfloat16"), (f(2), "bfloat16"), (_G(), "bfloat16"),
        (f(2, seed=5), "bfloat16"), _W(), f(2)],
        dict(lrs=[0.1, 0.2], wds=[0.0, 0.01]), 1e-6, False)],
    "multi_mp_sgd_mom_update": [(lambda: [
        (_W(), "bfloat16"), (f(2), "bfloat16"), (_G(), "bfloat16"),
        (f(2, seed=5), "bfloat16"), _M(), f(2, seed=6), _W(), f(2)],
        dict(lrs=[0.1, 0.2], momentum=0.9), 1e-6, False)],
    "preloaded_multi_sgd_update": _opt(
        [_W, lambda: f(2), _G, lambda: f(2, seed=5), lambda: a32([0.1, 0.2]),
         lambda: a32([0.0, 0.01])]),
    "preloaded_multi_sgd_mom_update": _opt(
        [_W, lambda: f(2), _G, lambda: f(2, seed=5), _M,
         lambda: f(2, seed=6), lambda: a32([0.1, 0.2]),
         lambda: a32([0.0, 0.01])], momentum=0.9),
    "preloaded_multi_mp_sgd_update": [(lambda: [
        (_W(), "bfloat16"), (f(2), "bfloat16"), (_G(), "bfloat16"),
        (f(2, seed=5), "bfloat16"), _W(), f(2), a32([0.1, 0.2]),
        a32([0.0, 0.01])], {}, 1e-6, False)],
    "preloaded_multi_mp_sgd_mom_update": [(lambda: [
        (_W(), "bfloat16"), (f(2), "bfloat16"), (_G(), "bfloat16"),
        (f(2, seed=5), "bfloat16"), _M(), f(2, seed=6), _W(), f(2),
        a32([0.1, 0.2]), a32([0.0, 0.01])], dict(momentum=0.9),
        1e-6, False)],
    "multi_sum_sq": [(lambda: [f(3, 4), f(5), (f(2, 2), "bfloat16")],
                      dict(num_arrays=3), RED, False)],
    "multi_lars": [(lambda: [a32([0.1, 0.2, 0.3]), a32([4.0, 0.0, 1.0]),
                             a32([1.0, 2.0, 0.5]), a32([0.0, 0.01, 0.1])],
                    dict(eta=0.01, rescale_grad=0.5), 1e-6, False)],
}
# the multi_* ops' list inputs: (lists, arrays in each)
LIST_GROUPS = {
    "multi_sgd_update": (2, 2), "multi_sgd_mom_update": (3, 2),
    "multi_mp_sgd_update": (3, 2), "multi_mp_sgd_mom_update": (4, 2),
    "preloaded_multi_sgd_update": (2, 2),
    "preloaded_multi_sgd_mom_update": (3, 2),
    "preloaded_multi_mp_sgd_update": (3, 2),
    "preloaded_multi_mp_sgd_mom_update": (4, 2),
}

LINALG_ATTENTION_CASES = {
    "linalg_gemm": [(lambda: [f(2, 3), f(3, 4, seed=2), f(2, 4, seed=3)],
                     dict(alpha=1.3, beta=0.7), RED, True),
                    (lambda: [f(2, 3, 2), f(2, 4, 3, seed=2),
                              f(2, 2, 4, seed=3)],
                     dict(transpose_a=True, transpose_b=True), RED, False)],
    "linalg_gemm2": [(lambda: [f(2, 3), f(3, 4, seed=2)], dict(alpha=1.3),
                      RED, True),
                     (lambda: [f(2, 3, 2), f(2, 3, 4, seed=2)],
                      dict(transpose_a=True), RED, False)],
    "linalg_potrf": [(lambda: [spd(4)], {}, RED, False),
                     (lambda: [spd(3, batch=(2,))], {}, RED, False)],
    "linalg_potri": [(lambda: [np.linalg.cholesky(spd(4))
                               .astype(np.float32)], {}, 1e-4, False)],
    "linalg_trsm": [(lambda: [lower(3), f(3, 2, seed=2)], dict(alpha=2.0),
                     1e-5, False),
                    (lambda: [lower(3), f(3, 2, seed=2)],
                     dict(transpose=True), 1e-5, False),
                    (lambda: [lower(3), f(2, 3, seed=2)],
                     dict(rightside=True), 1e-5, False),
                    (lambda: [lower(3).T.copy(), f(2, 3, seed=2)],
                     dict(rightside=True, transpose=True, lower=False),
                     1e-5, False)],
    "linalg_trmm": [(lambda: [lower(3), f(3, 2, seed=2)], {}, RED, False),
                    (lambda: [lower(3), f(2, 3, seed=2)],
                     dict(rightside=True, transpose=True, alpha=0.5), RED,
                     False)],
    "linalg_syrk": [(lambda: [f(2, 3)], dict(alpha=1.1), RED, True),
                    (lambda: [f(2, 3)], dict(transpose=True), RED, False)],
    "linalg_gelqf": [(lambda: [u(3, 4, lo=-0.5, hi=0.5)], {}, 1e-4,
                      False)],
    "linalg_syevd": [(lambda: [spd(3)], {}, 1e-4, False)],
    "linalg_gesvd": [(lambda: [u(3, 4, lo=-0.5, hi=0.5)], {}, 1e-4,
                      False)],
    "linalg_sumlogdiag": [(lambda: [spd(3)], {}, TRANS, False)],
    "linalg_extractdiag": [(lambda: [f(3, 3)], {}, 0, True),
                           (lambda: [f(2, 3, 3)], dict(offset=1), 0,
                            False)],
    "linalg_makediag": [(lambda: [f(3)], {}, 0, True),
                        (lambda: [f(2, 3)], dict(offset=-1), 0, False)],
    "linalg_extracttrian": [(lambda: [f(3, 3)], {}, 0, True),
                            (lambda: [f(3, 3)], dict(lower=False), 0,
                             False),
                            (lambda: [f(2, 4, 4)], dict(offset=-1), 0,
                             False)],
    "linalg_maketrian": [(lambda: [f(6)], {}, 0, True),
                         (lambda: [f(2, 3)], dict(offset=1), 0, False)],
    "linalg_slogdet": [(lambda: [f(3, 3)], {}, 1e-5, False)],
    "linalg_det": [(lambda: [f(3, 3)], {}, 1e-5, False)],
    "linalg_inverse": [(lambda: [spd(3)], {}, 1e-5, False)],
    "masked_softmax": [(lambda: [f(2, 4), a32([[1, 1, 0, 1],
                                               [0, 1, 1, 1]])], {}, RED,
                        True),
                       (lambda: [f(2, 3, 4)], dict(axis=1), RED, False)],
    "div_sqrt_dim": [(lambda: [f(2, 3, 8)], {}, TRANS, True)],
    "interleaved_matmul_selfatt_qk": [(lambda: [f(3, 2, 24)],
                                       dict(heads=2), RED, True)],
    "interleaved_matmul_selfatt_valatt": [
        (lambda: [f(3, 2, 24), f(4, 3, 3, seed=2)], dict(heads=2), RED,
         True)],
    "interleaved_matmul_encdec_qk": [
        (lambda: [f(3, 2, 8), f(4, 2, 16, seed=2)], dict(heads=2), RED,
         True)],
    "interleaved_matmul_encdec_valatt": [
        (lambda: [f(4, 2, 16), f(4, 3, 4, seed=2)], dict(heads=2), RED,
         True)],
    "sldwin_atten_mask_like": [
        (lambda: [f(4, 6, 6), a32([5, 3])],
         dict(dilation=1, num_heads=2, w=2), 0, False),
        (lambda: [f(4, 6, 6), a32([6, 4])],
         dict(dilation=2, num_heads=2, w=1, symmetric=False), 0, False)],
    "sldwin_atten_score": [
        (lambda: [f(2, 6, 8), f(2, 6, 8, seed=2)],
         dict(dilation=1, num_heads=2, w=2), RED, True),
        (lambda: [f(2, 6, 8), f(2, 6, 8, seed=2)],
         dict(dilation=2, num_heads=2, w=1, symmetric=False), RED, False)],
    "sldwin_atten_context": [
        (lambda: [f(4, 6, 6), f(2, 6, 8, seed=2)],
         dict(dilation=1, num_heads=2, w=2), RED, True)],
}

# --------------------------------------------------------------------- #
# contrib (detection, deformable convolution, misc) and vision ops
# --------------------------------------------------------------------- #
def boxes(n, seed=0, lo=0.0, hi=1.0, lead=()):
    """``n`` corner boxes (x1, y1, x2, y2) with x1 < x2, y1 < y2."""
    c = RS(seed).uniform(lo, hi, lead + (n, 2, 2))
    c.sort(axis=-1)
    return c[..., [0, 1, 0, 1], [0, 0, 1, 1]].astype(np.float32)


def nms_rows(seed=0):
    """(2, 8, 6) rows [id, score, x1, y1, x2, y2]: tied scores, boxes that
    overlap in pairs, two classes, -1 rows and a background row."""
    b = boxes(4, seed=seed, hi=0.6, lead=(2,))
    b = np.concatenate([b, b + 0.02], axis=1)       # pairs overlap
    ids = a32([[0, 0, 1, 1, 0, 0, 1, 1], [1, 0, 0, 0, 1, 1, 0, 0]])
    scores = a32([[0.9, 0.5, 0.5, 0.9, 0.9, 0.5, -1, 0.5],
                  [0.3, 0.3, 0.3, -1, 0.3, 0.7, 0.7, -1]])
    return np.concatenate([ids[..., None], scores[..., None], b], -1)


def anchors_grid(side=4):
    """(1, side*side*2, 4) corner anchors over [0, 1]."""
    c = (np.arange(side, dtype=np.float32) + 0.5) / side
    cy, cx = np.meshgrid(c, c, indexing="ij")
    out = [np.stack([cx - s, cy - s, cx + s, cy + s], -1)
           for s in (0.15, 0.3)]
    return np.stack(out, 2).reshape(1, -1, 4).astype(np.float32)


def mbt_labels():
    """(2, 3, 5) ground truth, class -1 padding rows."""
    return a32([[[1, 0.1, 0.1, 0.45, 0.4], [0, 0.55, 0.5, 0.95, 0.9],
                 [-1, 0, 0, 0, 0]],
                [[2, 0.3, 0.3, 0.7, 0.75], [-1, 0, 0, 0, 0],
                 [-1, 0, 0, 0, 0]]])


def tied_cls(N, seed=0):
    """(2, 4, N) class scores rounded to 0.25: ties in bulk."""
    return (np.round(f(2, 4, N, seed=seed) * 4) / 4).astype(np.float32)


def rpn_probs(A, H, W, seed=0):
    """(1, 2A, H, W) RPN scores rounded to 0.1: ties in bulk."""
    return (np.round(RS(seed).rand(1, 2 * A, H, W) * 10) / 10) \
        .astype(np.float32)


_ROIS = a32([[0, 0.6, 0.6, 5.3, 6.1], [1, 1.2, 0.5, 7.9, 4.4],
             [0, 2.2, 3.1, 3.0, 3.5]])

CONTRIB_CASES = {
    "box_nms": [
        (lambda: [nms_rows()], dict(id_index=0), 0, False),
        (lambda: [nms_rows(1)], dict(id_index=0, force_suppress=True,
                                     topk=3, overlap_thresh=0.3), 0, False),
        (lambda: [nms_rows(2)], dict(id_index=0, background_id=0,
                                     in_format="center",
                                     out_format="corner"), 0, False),
        (lambda: [nms_rows(3)[1]], dict(valid_thresh=0.3, out_format=
                                        "center"), 0, False)],
    "Proposal": [
        (lambda: [np.concatenate([rpn_probs(9, 4, 5), rpn_probs(
            9, 4, 5, seed=1)]), f(2, 36, 4, 5, seed=2) * 0.1,
                  a32([[64, 80, 1.0], [60, 70, 1.0]])],
         dict(scales=(2, 4, 8), rpn_pre_nms_top_n=50,
              rpn_post_nms_top_n=12), TRANS, False),
        (lambda: [rpn_probs(9, 4, 4), f(1, 36, 4, 4, seed=3) * 0.3,
                  a32([[64, 64, 1.0]])],
         dict(scales=(2, 4, 8), rpn_min_size=40, rpn_pre_nms_top_n=100,
              rpn_post_nms_top_n=40, threshold=0.5), TRANS, False),
        (lambda: [rpn_probs(3, 3, 3, seed=4), f(1, 12, 3, 3, seed=5) * 0.2,
                  a32([[48, 48, 1.0]])],
         dict(scales=(4,), rpn_pre_nms_top_n=8, rpn_post_nms_top_n=12),
         TRANS, False)],
    "MultiBoxTarget": [
        (lambda: [anchors_grid(), mbt_labels(), tied_cls(32)],
         dict(negative_mining_ratio=3.0), TRANS, False),
        (lambda: [anchors_grid(), mbt_labels(), tied_cls(32, seed=1)],
         dict(negative_mining_ratio=2.0, minimum_negative_samples=5,
              negative_mining_thresh=0.4, overlap_threshold=0.3), TRANS,
         False),
        (lambda: [anchors_grid(), mbt_labels(), tied_cls(32)], {}, TRANS,
         False)],
    "MultiBoxDetection": [
        (lambda: [np.abs(tied_cls(32)), f(2, 128, seed=2) * 0.1,
                  anchors_grid()], {}, 0, False),
        (lambda: [np.abs(tied_cls(32, seed=3)), f(2, 128, seed=4) * 0.1,
                  anchors_grid()],
         dict(nms_topk=5, threshold=0.3, force_suppress=True), 0, False)],
    "MultiBoxPrior": [
        (lambda: [f(1, 3, 4, 5)], dict(sizes=(0.5, 0.25),
                                       ratios=(1, 2, 0.5), clip=True), 0,
         False),
        (lambda: [f(2, 3, 3, 2)], dict(sizes=(0.3,), ratios=(1, 3),
                                       steps=(0.2, 0.25),
                                       offsets=(0.3, 0.6)), 0, False)],
    "box_iou": [(lambda: [boxes(5), boxes(7, seed=1)], {}, RED, False),
                (lambda: [boxes(3, seed=2, lead=(2,)),
                          boxes(4, seed=3, lead=(2,))],
                 dict(format="center"), RED, False)],
    "ROIAlign": [
        (lambda: [f(2, 3, 8, 8), _ROIS * a32([1, 2, 2, 2, 2])],
         dict(pooled_size=(2, 2), sample_ratio=-1, max_samples=4,
              spatial_scale=0.5), RED, False),
        (lambda: [f(2, 3, 8, 8), _ROIS], dict(pooled_size=(2, 3)), RED,
         True),
        (lambda: [f(2, 2 * 4, 6, 6), _ROIS * a32([1, .7, .7, .7, .7])],
         dict(pooled_size=(2, 2), position_sensitive=True, sample_ratio=0),
         RED, False)],
    "ROIPooling": [
        (lambda: [f(2, 3, 8, 8), a32([[0, 2.5, 1.5, 6.5, 5.49],
                                      [1, 0, 0, 7, 7],
                                      [0, 3.2, 3.3, 3.4, 3.6]])],
         dict(pooled_size=(2, 2)), 0, True),
        (lambda: [f(1, 2, 9, 7), a32([[0, 1, 3, 12, 17], [0, 5, 5, 9, 6]])],
         dict(pooled_size=(3, 2), spatial_scale=0.5), 0, False)],
    "box_encode": [
        (lambda: [a32([[1, 0, -1, 1], [1, 1, 0, -1]]),
                  a32([[0, 2, 1, 1], [2, 0, 0, 1]]),
                  boxes(4, seed=1, lead=(2,)), boxes(3, seed=2, lead=(2,))],
         {}, TRANS, False),
        (lambda: [a32([[1, 1, -1]]), a32([[1, -1, 0]]),
                  boxes(3, seed=3, lead=(1,)), boxes(2, seed=4, lead=(1,))],
         dict(means=(0.1, -0.1, 0.0, 0.2), stds=(0.2, 0.2, 0.5, 0.5)),
         TRANS, False)],
    "box_decode": [(lambda: [u(2, 3, 4, lo=-0.2, hi=0.2),
                             boxes(3, seed=1, lead=(1,))], {}, TRANS,
                    False),
                   (lambda: [u(2, 3, 4, lo=-2.0, hi=2.0),
                             boxes(3, seed=2, lead=(2,))],
                    dict(format="center", clip=0.1, std0=0.3), TRANS,
                    False)],
    "bipartite_matching": [
        (lambda: [a32([[0.5, 0.8, 0.8], [0.8, 0.3, 0.8], [0.1, 0.8, 0.6],
                       [0.8, 0.8, 0.2]])], dict(threshold=0.4), 0, False),
        (lambda: [a32([[0.5, 0.2, 0.2], [0.2, 0.3, 0.2], [0.1, 0.2, 0.6],
                       [0.7, 0.2, 0.9]])], dict(is_ascend=True,
                                                threshold=0.5), 0, False),
        (lambda: [np.round(u(2, 3, 4, lo=0, hi=1) * 4) / 4],
         dict(threshold=0.2, topk=2), 0, False)],
    "gradientmultiplier": [(lambda: [f(3, 4)], dict(scalar=-0.5), 0,
                            True)],
    "group_adagrad_update": [
        (lambda: [f(4, 3), f(4, 3, seed=2), f(4, lo=0.1, seed=3)],
         dict(lr=0.1), 1e-6, False),
        (lambda: [f(4, 3, 2), f(4, 3, 2, seed=2),
                  f(4, 1, 1, lo=0.1, seed=3)],
         dict(lr=0.05, rescale_grad=0.5, clip_gradient=0.7), 1e-6, False)],
    "DeformableConvolution": [
        (lambda: [f(1, 4, 5, 5), u(1, 18, 3, 3, lo=-0.8, hi=0.8, seed=2),
                  f(2, 4, 3, 3, seed=3)],
         dict(kernel=(3, 3), num_filter=2, no_bias=True), RED, False),
        (lambda: [f(2, 4, 6, 6), u(2, 36, 3, 3, lo=-1.5, hi=1.5, seed=2),
                  f(4, 2, 3, 3, seed=3), f(4, seed=4)],
         dict(kernel=(3, 3), stride=(2, 2), pad=(1, 1), dilate=(1, 1),
              num_filter=4, num_group=2, num_deformable_group=2), RED,
         False)],
    "ModulatedDeformableConvolution": [
        (lambda: [f(1, 4, 5, 5), u(1, 18, 3, 3, lo=-0.8, hi=0.8, seed=2),
                  u(1, 9, 3, 3, lo=0.2, hi=1.0, seed=5),
                  f(2, 4, 3, 3, seed=3), f(2, seed=4)],
         dict(kernel=(3, 3), num_filter=2), RED, False)],
    "count_sketch": [(lambda: [f(2, 8), ints(4, 8),
                               RS(6).choice([-1.0, 1.0], 8)
                               .astype(np.float32)],
                      dict(out_dim=4), RED, False)],
    "hawkes_ll": [
        (lambda: [f(3, lo=0.2), f(3, lo=0.1, seed=2) * 0.3,
                  f(3, lo=0.5, seed=3), f(2, 3, lo=0.0, seed=4) * 0.2,
                  f(2, 4, lo=0.1, seed=5), ints(3, 2, 4), i32([4, 2])],
         dict(max_time=10.0), RED, False)],
    "mrcnn_mask_target": [
        (lambda: [boxes(3, seed=1, hi=8.0, lead=(2,)),
                  (f(2, 2, 8, 8) > 0).astype(np.float32),
                  a32([[0, 1, 1], [1, 0, 0]]), a32([[1, 2, -1], [0, 2, 1]])],
         dict(num_classes=3, mask_size=(4, 4)), RED, False)],
}

VISION_CASES = {
    "UpSampling": [
        (lambda: [f(1, 2, 5, 6)], dict(scale=2, sample_type="bilinear"),
         RED, True),
        (lambda: [f(2, 3, 4, 5)], dict(scale=2), 0, True),
        (lambda: [f(1, 2, 8, 8), f(1, 3, 4, 4, seed=2)], dict(scale=1),
         0, False),
        (lambda: [f(1, 2, 4, 3)], dict(scale=3, sample_type="bilinear"),
         RED, False),
        (lambda: [f(1, 2, 4, 4), f(2, 1, 4, 4, seed=2)],
         dict(scale=2, sample_type="bilinear"), RED, False)],
    "BilinearSampler": [(lambda: [f(2, 3, 5, 7), u(2, 2, 4, 6, lo=-1.2,
                                                    hi=1.2, seed=2)],
                         {}, RED, True)],
    "GridGenerator": [(lambda: [f(2, 6)], dict(target_shape=(4, 5)), RED,
                       False),
                      (lambda: [f(2, 2, 4, 5)],
                       dict(transform_type="warp"), RED, False)],
    "SpatialTransformer": [
        (lambda: [f(1, 2, 6, 6), a32([[0.9, 0.1, 0.05, -0.1, 0.8, 0.02]])],
         dict(target_shape=(5, 5)), RED, False)],
    "im2col": [(lambda: [f(2, 3, 5, 5)], dict(kernel=(2, 2), stride=(2, 2),
                                              pad=(1, 1)), 0, True),
               (lambda: [f(1, 2, 7, 6)], dict(kernel=(3, 2), dilate=(2, 1),
                                              stride=(1, 2)), 0, False)],
    "col2im": [(lambda: [f(2, 12, 9)], dict(output_size=(5, 5),
                                            kernel=(2, 2), stride=(2, 2),
                                            pad=(1, 1)), RED, False),
               (lambda: [f(1, 18, 16)], dict(output_size=(6, 6),
                                             kernel=(3, 3)), RED, False)],
    "fft": [(lambda: [f(3, 8)], {}, RED, False)],
    "ifft": [(lambda: [f(3, 16)], {}, RED, False)],
}

FAMILY = {**{n: "base" for n in BASE_CASES},
          **{n: "tensor" for n in TENSOR_CASES},
          **{n: "misc_nn" for n in MISC_NN_CASES},
          **{n: "random" for n in RANDOM_CASES},
          **{n: "optimizer" for n in OPTIMIZER_CASES},
          **{n: "linalg_attention" for n in LINALG_ATTENTION_CASES},
          **{n: "contrib" for n in CONTRIB_CASES},
          **{n: "vision" for n in VISION_CASES}}
CASES = {**BASE_CASES, **TENSOR_CASES, **MISC_NN_CASES, **RANDOM_CASES,
         **OPTIMIZER_CASES, **LINALG_ATTENTION_CASES, **CONTRIB_CASES,
         **VISION_CASES}

# --------------------------------------------------------------------- #
# classes (tests/test_op_gradient_sweep.py's buckets)
# --------------------------------------------------------------------- #
NONDIFF = {
    "_equal_scalar", "_not_equal_scalar", "_greater_scalar",
    "_greater_equal_scalar", "_lesser_scalar", "_lesser_equal_scalar",
    "broadcast_equal", "broadcast_not_equal", "broadcast_greater",
    "broadcast_greater_equal", "broadcast_lesser", "broadcast_lesser_equal",
    "broadcast_logical_and", "broadcast_logical_or",
    "broadcast_logical_xor", "logical_not", "isfinite", "isinf", "isnan",
    "allclose", "all_finite", "multi_all_finite",
    "argmax", "argmin", "argsort", "argmax_channel", "histogram", "one_hot",
    "ravel_multi_index", "unravel_index", "shape_array", "size_array",
    "index_array", "zeros_like", "ones_like", "full_like", "arange_like",
    "ceil", "floor", "fix", "rint", "round", "trunc", "sign",
    "sldwin_atten_mask_like",
    # anchors, matching, NMS and target assignment
    "MultiBoxPrior", "box_nms", "bipartite_matching", "MultiBoxDetection",
    "MultiBoxTarget", "Proposal", "mrcnn_mask_target", "box_encode",
    "group_adagrad_update",
    *OPTIMIZER_CASES,
}
CUSTOM_GRAD = {"SoftmaxOutput", "LinearRegressionOutput",
               "LogisticRegressionOutput", "MAERegressionOutput",
               "SVMOutput", "make_loss", "BlockGrad", "gradientmultiplier"}
DISTRIBUTION = {*RANDOM_CASES, "shuffle", "Dropout"}

# (mean, variance) of each sampler case's draws, a row for each row of a
# sample_* op's parameters (the sweep's DIST_CHECK moments, and the same
# algebra for the rest)
MOMENTS = {
    "random_uniform": [(1.0, 16.0 / 12.0)],
    "random_normal": [(1.5, 4.0)],
    "random_gamma": [(1.5, 0.75)],
    "random_exponential": [(0.5, 0.25)],
    "random_poisson": [(3.0, 3.0)],
    "random_randint": [(1.0, (49 - 1) / 12.0)],
    "random_bernoulli": [(0.3, 0.21)],
    "random_laplace": [(0.5, 4.5)],
    "random_negative_binomial": [(4.5, 11.25)],
    "random_generalized_negative_binomial": [(2.0, 4.0)],
    "sample_uniform": [(0.5, 1 / 12.0), (3.5, 9 / 12.0)],
    "sample_normal": [(0.0, 1.0), (-2.0, 0.25)],
    "sample_gamma": [(2.0, 2.0), (2.5, 1.25)],
    "sample_exponential": [(1.0, 1.0), (0.25, 0.0625)],
    "sample_poisson": [(1.0, 1.0), (6.0, 6.0)],
    "sample_negative_binomial": [(2.0, 4.0), (5 * 0.3 / 0.7,
                                              5 * 0.3 / 0.49)],
    "sample_generalized_negative_binomial": [(2.0, 4.0), (3.0, 3.0)],
    "sample_multinomial": [(1.1, 0.49), (0.5, 0.65)],
}

# ops whose first input is a list of arrays
LISTED = {"add_n", "concat", "stack"}
# (positional arrays, names of the trailing arrays passed by keyword)
BY_KEYWORD = {"softmax": (1, ("length",)),
              "scaled_dot_product_attention": (3, ("valid_length",)),
              "SequenceMask": (1, ("sequence_length",)),
              "SequenceLast": (1, ("sequence_length",)),
              "SequenceReverse": (1, ("sequence_length",)),
              "masked_softmax": (1, ("mask",)),
              "histogram": (1, ("bins",)),
              "BilinearResize2D": (1, ("like",)),
              "sldwin_atten_mask_like": (1, ("valid_length",))}
CASE_IDS = [(name, i, dt) for name in sorted(CASES)
            for i in range(len(CASES[name]))
            for dt in (("float32", "bfloat16") if CASES[name][i][3]
                       else ("float32",))]


def case_ids(family):
    return [c for c in CASE_IDS if FAMILY[c[0]] == family]


def ids(cases):
    return [f"{n}-{i}-{d}" for n, i, d in cases]


def grad_names(families):
    """The differentiable ops of ``families`` (custom gradients
    included): each one's first case is its gradient case."""
    return sorted(n for n in CASES if FAMILY[n] in families
                  and n not in NONDIFF and n not in DISTRIBUTION)


# --------------------------------------------------------------------- #
# calling an op of either package on a case
# --------------------------------------------------------------------- #
def host(x):
    """An NDArray or tensor as a float64 numpy array."""
    if torch.is_tensor(x):
        x = x.detach().float().cpu().numpy()
    elif hasattr(x, "asnumpy"):
        x = x.asnumpy()
    return np.asarray(x).astype(np.float64)


def make_arrays(pkg, inputs, dtype, **place):
    """Each numpy input as an array of ``pkg``: floats in ``dtype`` (bf16
    made from f32), ints as int32; a (array, dtype) pair in its dtype."""
    out = []
    for a in inputs:
        want = None
        if isinstance(a, tuple):
            a, want = a
        if a.dtype.kind == "f":
            x = pkg.array(a, dtype="float32", **place)
            want = want or dtype
            out.append(x.astype(want) if want != "float32" else x)
        else:
            out.append(pkg.array(a, dtype="int32", **place))
    return out


def invoke(fn, name, arrays, kw):
    """``fn`` (an ``nd`` function or a registered op's ``fn``) on a
    case's arrays, passed as the op takes them: one list (``LISTED``),
    lists then arrays (``LIST_GROUPS``), or trailing arrays by keyword
    (``BY_KEYWORD``)."""
    if name in LISTED:
        return fn(list(arrays), **kw)
    if name in LIST_GROUPS:
        n_lists, per = LIST_GROUPS[name]
        lists = [list(arrays[i * per:(i + 1) * per]) for i in range(n_lists)]
        return fn(*lists, *arrays[n_lists * per:], **kw)
    npos, names = BY_KEYWORD.get(name, (len(arrays), ()))
    return fn(*arrays[:npos], **dict(zip(names, arrays[npos:])), **kw)


def call(pkg, name, inputs, kw, dtype, **place):
    """``pkg.<name>`` on a case's inputs."""
    return invoke(getattr(pkg, name), name,
                  make_arrays(pkg, inputs, dtype, **place), kw)


def _gelqf(got, want, inputs, tol):
    L, Q = (host(g) for g in got)
    A = inputs[0].astype(np.float64)
    np.testing.assert_allclose(L @ Q, A, atol=tol)
    np.testing.assert_allclose(Q @ Q.T, np.eye(Q.shape[0]), atol=tol)
    np.testing.assert_allclose(np.abs(L), np.abs(host(want[0])), atol=tol)
    assert np.allclose(np.triu(L, 1), 0.0)


def _syevd(got, want, inputs, tol):
    U, w = (host(g) for g in got)
    np.testing.assert_allclose(w, host(want[1]), rtol=tol, atol=tol)
    np.testing.assert_allclose(U.T @ np.diag(w) @ U,
                               inputs[0].astype(np.float64),
                               atol=tol * np.abs(inputs[0]).max())
    np.testing.assert_allclose(U @ U.T, np.eye(U.shape[0]), atol=tol)


def _gesvd(got, want, inputs, tol):
    U, s, V = (host(g) for g in got)
    np.testing.assert_allclose(s, host(want[1]), rtol=tol, atol=tol)
    np.testing.assert_allclose(U @ np.diag(s) @ V,
                               inputs[0].astype(np.float64), atol=tol)
    np.testing.assert_allclose(U.T @ U, np.eye(U.shape[1]), atol=tol)
    np.testing.assert_allclose(V @ V.T, np.eye(V.shape[0]), atol=tol)


# sign-ambiguous decompositions: reconstruction, orthogonality and the
# sign-free values (singular values, eigenvalues, |L|) instead of entries
CHECKS = {"linalg_gelqf": _gelqf, "linalg_syevd": _syevd,
          "linalg_gesvd": _gesvd}


def compare(got, want, rtol, dtype):
    """Structure, shape, dtype; values within rtol (bf16: 1e-2) with an
    atol of rtol times the output's largest |entry|."""
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want)
        for g, w in zip(got, want):
            compare(g, w, rtol, dtype)
        return
    assert got.shape == want.shape
    assert str(got.dtype) == str(want.dtype), (got.dtype, want.dtype)
    g, w = host(got), host(want)
    if dtype == "bfloat16":
        rtol = max(rtol, 1e-2)
    finite = np.isfinite(w)
    np.testing.assert_array_equal(np.isfinite(g), finite)
    np.testing.assert_array_equal(g[~finite], w[~finite])
    atol = rtol * float(np.abs(w[finite]).max(initial=0.0))
    np.testing.assert_allclose(g[finite], w[finite], rtol=rtol, atol=atol)


def check_moments(name, samples):
    """Each row's sample mean within 5 standard errors of the analytic
    mean, its variance within the gradient sweep's margin (5 SE of the
    variance with a factor 3 for the tails)."""
    rows = host(samples).reshape(len(MOMENTS[name]), -1)
    for s, (mean, var) in zip(rows, MOMENTS[name]):
        n = s.size
        assert abs(s.mean() - mean) < 5 * np.sqrt(var / n), \
            f"{name}: mean {s.mean()} vs {mean}"
        assert abs(s.var() - var) < 5 * var * np.sqrt(2.0 / (n - 1)) * 3, \
            f"{name}: variance {s.var()} vs {var}"


def check_sampler(name, out, inputs, kw):
    """A sampler case's draws: shape, dtype, support and moments (or, for
    ``shuffle``, a permutation of the rows)."""
    if name == "shuffle":
        rows = sorted(map(tuple, host(out).tolist()))
        assert rows == sorted(map(tuple, inputs[0].astype(np.float64)
                                  .tolist()))
        return
    if name == "Dropout":
        return
    if name == "random_randn":
        assert out.shape == () and str(out.dtype) == "float32"
        return
    x = host(out)
    if name in ("random_randint",):
        assert x.min() >= kw["low"] and x.max() < kw["high"]
    check_moments(name, out)


# --------------------------------------------------------------------- #
# the card
# --------------------------------------------------------------------- #
CARD_RTOL = 1e-5


@pytest.mark.cuda
def test_ops_on_the_card_equal_the_cpu():
    """Every case of every registered op on the card against the port on
    the CPU; the samplers by their moments on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert sorted(CASES) == treg.list_all_ops()
    failures = []
    for name, i, dtype in CASE_IDS:
        make, kw, rtol, _ = CASES[name][i]
        inputs = make()
        try:
            with mx.gpu(0):
                got = call(nd, name, inputs, kw, dtype)
            if name in DISTRIBUTION:
                check_sampler(name, got, inputs, kw)
                continue
            with mx.cpu():
                want = call(nd, name, inputs, kw, dtype)
            if name in CHECKS:
                CHECKS[name](got, want, inputs, 1e-4)
            else:
                compare(got, want, max(rtol, CARD_RTOL), dtype)
        except Exception as e:             # gather every op's verdict
            failures.append(f"{name}-{i}-{dtype}: {type(e).__name__}: "
                            f"{str(e)[:300]}")
    assert not failures, "\n".join(failures)
