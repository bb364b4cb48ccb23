"""AMP op lists: a copy of the JAX package's
``incubator_mxnet_tpu/amp/lists.py``, op for op. ``amp.init`` casts the
float inputs of ``TARGET_DTYPE_OPS`` to the AMP dtype and pins
``FP32_OPS`` to float32; ``WIDEST_TYPE_CASTS`` is kept for introspection
(the ops already promote to their widest input).
"""

# FLOP-dominated ops whose inputs are cast to the AMP dtype: on the card
# they run on the tensor cores (reference list: convolution / FC / RNN /
# interleaved_matmul_* kernels)
TARGET_DTYPE_OPS = [
    "FullyConnected",
    "Convolution",
    "Deconvolution",
    "dot",
    "batch_dot",
    "interleaved_matmul_selfatt_qk",
    "interleaved_matmul_selfatt_valatt",
    "interleaved_matmul_encdec_qk",
    "interleaved_matmul_encdec_valatt",
]

# numerically sensitive ops forced to run in float32 (reference FP32_FUNCS:
# softmax/norm/exp/log/loss ops)
FP32_OPS = [
    "softmax",
    "log_softmax",
    "softmax_cross_entropy",
    "SoftmaxOutput",
    "BatchNorm",
    "LayerNorm",
    "InstanceNorm",
    "GroupNorm",
    "L2Normalization",
    "norm",
    "exp",
    "log",
    "log2",
    "log10",
    "log1p",
    "expm1",
    "rsqrt",
    "erfinv",
    "reciprocal",
    "mean",
    "sum",
]

# everything else propagates the widest input dtype (reference
# WIDEST_TYPE_CASTS): the registry ops already follow torch's promotion,
# so no action is needed; the list exists for introspection parity.
WIDEST_TYPE_CASTS = ["broadcast_add", "broadcast_mul", "elemwise_add",
                     "concat", "where", "add_n"]
