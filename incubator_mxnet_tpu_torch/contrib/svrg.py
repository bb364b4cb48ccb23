"""SVRG optimization: the port of the JAX package's
``incubator_mxnet_tpu/contrib/svrg.py`` (parity:
python/mxnet/contrib/svrg_optimization/{svrg_module,svrg_optimizer}.py).

Stochastic Variance-Reduced Gradient: every ``update_freq`` epochs a full
pass stores snapshot weights w~ and the full-data gradient mu; minibatch
updates then use the variance-reduced direction
    g_vr = g_i(w) - g_i(w~) + mu.

Instead of the reference's pair of Modules and a KVStore-intercepting
optimizer (_SVRGOptimizer rewriting key names), the snapshot is a dict
of copies and the variance-reduced gradient is one extra forward /
backward at the snapshot weights per batch through the same executor.
The executor holds its arrays by address (one CUDA graph per signature
on the card), so weights are swapped with ``set_params`` (``copy_``)
and the variance-reduced gradient is written into the gradient buffers
in place.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..base import MXNetError
from ..module.module import Module

__all__ = ["SVRGModule"]


class SVRGModule(Module):
    """Module with SVRG variance reduction (reference: SVRGModule).

    Extra arg ``update_freq``: take a new full-gradient snapshot every
    ``update_freq`` epochs. Use exactly like Module; call
    ``update_full_grads(train_data)`` at the epochs ``is_update_epoch``
    flags (``fit`` does both automatically).
    """

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), update_freq=2, **kwargs):
        super().__init__(symbol, data_names=data_names,
                         label_names=label_names, **kwargs)
        if update_freq < 1:
            raise MXNetError("update_freq must be >= 1")
        self.update_freq = int(update_freq)
        self._snapshot: Optional[Dict[str, "object"]] = None
        self._mu: Optional[Dict[str, "object"]] = None

    # -- snapshot ------------------------------------------------------ #
    def is_update_epoch(self, epoch: int) -> bool:
        return epoch % self.update_freq == 0

    def update_full_grads(self, train_data):
        """One full pass at the current weights: store snapshot weights
        w~ and the averaged full gradient mu (reference:
        SVRGModule.update_full_grads), summed on the device."""
        arg_params, _ = self.get_params()
        self._snapshot = {k: v.copy() for k, v in arg_params.items()}

        sums: Dict[str, torch.Tensor] = {}
        n_batches = 0
        train_data.reset()
        for batch in train_data:
            self.forward(batch, is_train=True)
            self.backward()
            with torch.no_grad():
                for name, grad in self._exec.grad_dict.items():
                    if grad is None:
                        continue
                    if name in sums:
                        sums[name] += grad._data
                    else:
                        sums[name] = grad._data.detach().clone()
            n_batches += 1
        train_data.reset()
        if n_batches == 0:
            raise MXNetError("update_full_grads: empty data iterator")
        from ..ndarray import NDArray
        self._mu = {k: NDArray(v / n_batches) for k, v in sums.items()}

    # -- variance-reduced step ---------------------------------------- #
    def forward_backward(self, data_batch):
        """fwd+bwd at the snapshot weights first, then at the current
        weights; grad := g(w) - g(w~) + mu. Order matters: the LAST
        forward is at the current weights, so executor outputs (and
        therefore update_metric) reflect w, not w~; aux state (e.g. BN
        running stats) is saved/restored around the snapshot pass so it
        only ever advances with current-weight activations."""
        if self._snapshot is None:
            super().forward_backward(data_batch)
            return
        current = {k: v.copy() for k, v in self.get_params()[0].items()}
        aux_saved = {k: v.copy()
                     for k, v in self._exec.aux_dict.items()}
        self.set_params(self._snapshot, allow_missing=True,
                        force_init=True)
        super().forward_backward(data_batch)
        grad_snap = {k: (g.copy() if g is not None else None)
                     for k, g in self._exec.grad_dict.items()}
        self.set_params(current, aux_params=aux_saved,
                        allow_missing=True, force_init=True)
        super().forward_backward(data_batch)
        # write the variance-reduced gradient back into the executor
        for name, g in self._exec.grad_dict.items():
            if g is None or name not in self._mu:
                continue
            gs = grad_snap.get(name)
            vr = g - gs + self._mu[name] if gs is not None \
                else g + self._mu[name]
            with torch.no_grad():
                g._data.copy_(vr._data)

    # -- fit with automatic snapshotting ------------------------------- #
    def fit(self, train_data, eval_data=None, eval_metric="acc",
            optimizer="sgd", optimizer_params=None, num_epoch=1,
            batch_end_callback=None, epoch_end_callback=None,
            initializer=None, kvstore="local"):
        from ..module.module import _BatchEndParam, _as_list

        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True)
        self.init_params(initializer=initializer)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params or {})
        from .. import metric as metric_mod
        em = metric_mod.create(eval_metric) \
            if not hasattr(eval_metric, "update") else eval_metric
        for epoch in range(num_epoch):
            if self.is_update_epoch(epoch):
                self.update_full_grads(train_data)
            em.reset()
            train_data.reset()
            for nbatch, batch in enumerate(train_data):
                self.forward_backward(batch)
                self.update()
                self.update_metric(em, batch.label)
                for cb in _as_list(batch_end_callback or []):
                    cb(_BatchEndParam(epoch, nbatch, em))
            if epoch_end_callback:
                epoch_end_callback(epoch, self.symbol,
                                   *self.get_params())
            if eval_data is not None:
                self.score(eval_data, em)
        return em
