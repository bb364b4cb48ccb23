"""Optimizer update operators: the port of the JAX package's
``incubator_mxnet_tpu/ops/optimizer_ops.py``.

The rules are the optimizer's own (``optimizer/ops.py``), registered here
under the JAX names, so ``nd.sgd_mom_update(w, g, m, lr=..., out=[w, m])``
and the ``Optimizer`` classes run one copy of each. Each returns new
tensors in the JAX op's output order (``sgd_mom_update``: weight,
momentum; ``mp_*``: the low-precision weight, the state, the f32
master); the ``multi_*`` forms take lists (``wrap_list``) and return
every tensor's outputs in turn.
"""

from __future__ import annotations

from ..optimizer import ops as _rules
from .registry import register

for _name, _n, _wrap in [
        ("sgd_update", 1, False), ("sgd_mom_update", 2, False),
        ("nag_mom_update", 2, False), ("adam_update", 3, False),
        ("adamw_update", 3, False), ("rmsprop_update", 2, False),
        ("rmspropalex_update", 4, False), ("ftrl_update", 3, False),
        ("signsgd_update", 1, False), ("signum_update", 2, False),
        ("lamb_update_phase1", 3, False), ("lamb_update_phase2", 1, False),
        ("ftml_update", 4, False), ("adagrad_update", 2, False),
        ("adadelta_update", 3, False), ("mp_sgd_update", 2, False),
        ("mp_sgd_mom_update", 3, False), ("mp_nag_mom_update", 3, False),
        ("mp_adam_update", 4, False), ("mp_adamw_update", 4, False),
        ("multi_sgd_update", None, True),
        ("multi_sgd_mom_update", None, True),
        ("multi_mp_sgd_update", None, True),
        ("multi_mp_sgd_mom_update", None, True),
        ("preloaded_multi_sgd_update", None, True),
        ("preloaded_multi_sgd_mom_update", None, True),
        ("preloaded_multi_mp_sgd_update", None, True),
        ("preloaded_multi_mp_sgd_mom_update", None, True),
        ("multi_sum_sq", 1, True), ("multi_lars", 1, False)]:
    register(_name, num_outputs=_n, wrap_list=_wrap)(getattr(_rules, _name))
