"""``BucketingModule``: variable-length training over buckets, the port
of the JAX package's ``incubator_mxnet_tpu/module/bucketing_module.py``.

Each bucket key gets a ``Module`` of its own symbol (``sym_gen(key)``),
bound at the bucket's first batch with the default bucket's parameter
arrays and optimizer states shared by reference, so one update is seen
by every bucket. Each bucket's executor keeps its own programs (on the
card, a CUDA graph per signature).
"""

from __future__ import annotations

from typing import Callable, Dict

from ..base import MXNetError
from .module import BaseModule, Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    def __init__(self, sym_gen: Callable, default_bucket_key=None,
                 context=None, logger=None, **kwargs):
        super().__init__(logger)
        if default_bucket_key is None:
            raise MXNetError("default_bucket_key is required")
        self._sym_gen = sym_gen
        self._default_key = default_bucket_key
        self._context = context
        self._kwargs = kwargs
        self._buckets: Dict[object, Module] = {}
        self._curr: Module = None
        self._bind_args = None

    def _make_module(self, key, gen=None) -> Module:
        sym, data_names, label_names = gen or self._sym_gen(key)
        return Module(sym, data_names=data_names, label_names=label_names,
                      context=self._context, logger=self.logger,
                      **self._kwargs)

    @property
    def symbol(self):
        return self._curr.symbol if self._curr else None

    # -- BaseModule interface ----------------------------------------- #
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, grad_req="write",
             **_):
        if self.binded and not force_rebind:
            return
        self._bind_args = dict(for_training=for_training,
                               inputs_need_grad=inputs_need_grad,
                               grad_req=grad_req)
        master = self._make_module(self._default_key)
        master.bind(data_shapes, label_shapes, **self._bind_args)
        self._buckets[self._default_key] = master
        self._curr = master
        self.binded = True

    def init_params(self, **kwargs):
        self._buckets[self._default_key].init_params(**kwargs)
        self.params_initialized = True

    def init_optimizer(self, **kwargs):
        master = self._buckets[self._default_key]
        master.init_optimizer(**kwargs)
        # re-borrow into every bucket already bound (they took the
        # master's optimizer state at bind time, which may predate this)
        for key, mod in self._buckets.items():
            if mod is not master:
                mod._optimizer = master._optimizer
                mod._opt_states = master._opt_states
                mod.optimizer_initialized = True
        self.optimizer_initialized = True

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None,
                      gen=None):
        """Select (binding it at its first use) the module of ``bucket_key``."""
        if bucket_key not in self._buckets:
            mod = self._make_module(bucket_key, gen=gen)
            mod.bind(data_shapes, label_shapes,
                     shared_module=self._buckets[self._default_key],
                     **self._bind_args)
            self._buckets[bucket_key] = mod
        self._curr = self._buckets[bucket_key]

    def forward(self, data_batch, is_train=None):
        key = getattr(data_batch, "bucket_key", self._default_key)
        # derive input names from THIS bucket's symbol (sym_gen may emit
        # bucket-specific data/label names), not the default bucket's;
        # generate at most once per new bucket and hand the result through
        gen = None
        data_shapes = getattr(data_batch, "provide_data", None)
        label_shapes = getattr(data_batch, "provide_label", None)
        need_names = data_shapes is None or \
            (label_shapes is None and data_batch.label is not None)
        if need_names:
            if key in self._buckets:
                names_mod = self._buckets[key]
                data_names = names_mod._data_names
                label_names = names_mod._label_names
            else:
                gen = self._sym_gen(key)
                _, data_names, label_names = gen
            if data_shapes is None:
                data_shapes = [(n, a.shape)
                               for n, a in zip(data_names, data_batch.data)]
            if label_shapes is None and data_batch.label is not None:
                label_shapes = [(n, a.shape) for n, a in
                                zip(label_names, data_batch.label)]
        self.switch_bucket(key, data_shapes, label_shapes, gen=gen)
        self._curr.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        self._curr.backward(out_grads)

    def update(self):
        self._curr.update()

    def get_outputs(self, merge_multi_context=True):
        return self._curr.get_outputs(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._curr.update_metric(eval_metric, labels)

    def get_params(self):
        return self._buckets[self._default_key].get_params()

    def set_params(self, *args, **kwargs):
        self._buckets[self._default_key].set_params(*args, **kwargs)
        self.params_initialized = True
