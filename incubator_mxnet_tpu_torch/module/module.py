"""``Module``: MXNet 1.x's symbolic trainer, the port of the JAX package's
``incubator_mxnet_tpu/module/module.py``.

``BaseModule`` holds the loops (``fit``, ``score``, ``predict``);
``Module`` binds one symbol into one ``symbol.Executor`` on its context
(``gpu(0)`` unless the caller asks for the CPU). The executor's arrays
are bound once: ``forward`` copies each batch into them (a host batch
crosses to the device there), ``set_params`` / ``init_params`` write the
parameters in place, and ``update`` runs the optimizer's ``update`` one
parameter at a time (as the JAX ``Module`` does), writing the new weight
and state into the same tensors, so the executor's CUDA graphs see every
step. ``save_checkpoint`` writes ``<prefix>-symbol.json``,
``<prefix>-NNNN.params`` (``arg:`` / ``aux:`` keys) and, with the
optimizer states, a capsule ``<prefix>-NNNN.states``; ``Module.load``
reads either package's files (a pickled ``.states`` too).
"""

from __future__ import annotations

import logging
import pickle
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import initializer as _init_mod
from .. import metric as _metric_mod
from .. import optimizer as _opt_mod
from ..base import MXNetError
from ..context import Context, current_context
from ..io import DataDesc
from ..ndarray import NDArray
from ..optimizer.fused import tree_leaves
from ..symbol.executor import Executor
from ..symbol.symbol import Symbol

__all__ = ["BaseModule", "Module"]


def _norm_shapes(shapes) -> List[Tuple[str, tuple]]:
    out = []
    for s in shapes or []:
        if isinstance(s, DataDesc):
            out.append((s.name, tuple(s.shape)))
        else:
            out.append((s[0], tuple(s[1])))
    return out


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


class _BatchEndParam:
    def __init__(self, epoch, nbatch, eval_metric):
        self.epoch = epoch
        self.nbatch = nbatch
        self.eval_metric = eval_metric
        self.locals = None


class BaseModule:
    """The train and evaluation loops (parity: ``BaseModule``)."""

    def __init__(self, logger=None):
        self.logger = logger or logging.getLogger("incubator_mxnet_tpu")
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False

    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None, reset=True,
              epoch=0, batch_end_callback=None):
        if not isinstance(eval_metric, _metric_mod.EvalMetric):
            eval_metric = _metric_mod.create(eval_metric)
        if reset:
            eval_data.reset()
        eval_metric.reset()
        for nbatch, batch in enumerate(eval_data):
            if num_batch is not None and nbatch >= num_batch:
                break
            self.forward(batch, is_train=False)
            self.update_metric(eval_metric, batch.label)
            if batch_end_callback is not None:
                for cb in _as_list(batch_end_callback):
                    cb(_BatchEndParam(epoch, nbatch, eval_metric))
        return eval_metric.get_name_value()

    def predict(self, eval_data, num_batch=None, reset=True):
        """The outputs over the iterator, concatenated, each batch's pad
        cut (parity: ``BaseModule.predict``)."""
        if reset:
            eval_data.reset()
        chunks: List[List[torch.Tensor]] = []
        for nbatch, batch in enumerate(eval_data):
            if num_batch is not None and nbatch >= num_batch:
                break
            self.forward(batch, is_train=False)
            outs = [o._data for o in self.get_outputs()]
            pad = getattr(batch, "pad", 0) or 0
            if pad:
                outs = [o[:o.shape[0] - pad] for o in outs]
            chunks.append(outs)
        if not chunks:
            return []
        cat = [NDArray(torch.cat([c[i] for c in chunks]))
               for i in range(len(chunks[0]))]
        return cat if len(cat) > 1 else cat[0]

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd", optimizer_params=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_init=False, begin_epoch=0,
            num_epoch=None, validation_metric=None):
        """The epoch loop (parity: ``Module.fit``)."""
        if num_epoch is None:
            raise MXNetError("fit: num_epoch is required")
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label, for_training=True)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        if not isinstance(eval_metric, _metric_mod.EvalMetric):
            eval_metric = _metric_mod.create(eval_metric)
        validation_metric = validation_metric or eval_metric
        for epoch in range(begin_epoch, num_epoch):
            eval_metric.reset()
            train_data.reset()
            for nbatch, batch in enumerate(train_data):
                self.forward_backward(batch)
                self.update()
                self.update_metric(eval_metric, batch.label)
                if batch_end_callback is not None:
                    for cb in _as_list(batch_end_callback):
                        cb(_BatchEndParam(epoch, nbatch, eval_metric))
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            if epoch_end_callback is not None:
                arg_p, aux_p = self.get_params()
                for cb in _as_list(epoch_end_callback):
                    cb(epoch, self.symbol, arg_p, aux_p)
            if eval_data is not None:
                res = self.score(eval_data, validation_metric, epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f",
                                     epoch, name, val)


class Module(BaseModule):
    """A module of one symbol (parity: ``mx.mod.Module``)."""

    def __init__(self, symbol: Symbol, data_names=("data",),
                 label_names=("softmax_label",), context=None, logger=None,
                 **_ignored):
        super().__init__(logger)
        self._symbol = symbol
        self._data_names = list(data_names)
        self._label_names = list(label_names or [])
        if isinstance(context, (list, tuple)):
            if len(context) != 1:
                raise MXNetError(
                    "Module: one context; the port runs one device a "
                    "process (data parallelism over processes: "
                    "parallel.SPMDTrainer or gluon.Trainer with a "
                    "dist_* kvstore)")
            context = context[0]
        self._context = context if isinstance(context, Context) else \
            Context(context) if context is not None else current_context()
        arg_names = symbol.list_arguments()
        self._param_names = [n for n in arg_names
                             if n not in self._data_names
                             and n not in self._label_names]
        self._aux_names = symbol.list_auxiliary_states()
        self._exec = None
        self._data_shapes = []
        self._label_shapes = []
        self._grad_req = "write"
        self._inputs_need_grad = False
        self._optimizer = None
        self._opt_states: Dict[str, object] = {}

    @property
    def symbol(self) -> Symbol:
        return self._symbol

    @property
    def data_names(self):
        return list(self._data_names)

    @property
    def output_names(self):
        return self._symbol.list_outputs()

    @property
    def data_shapes(self):
        return [DataDesc(n, s) for n, s in self._data_shapes]

    @property
    def label_shapes(self):
        return [DataDesc(n, s) for n, s in self._label_shapes]

    @property
    def output_shapes(self):
        shapes = dict(self._data_shapes + self._label_shapes)
        shapes.update({n: tuple(self._exec.arg_dict[n].shape)
                       for n in self._param_names})
        _, out_shapes, _ = self._symbol.infer_shape(**shapes)
        return list(zip(self.output_names, out_shapes))

    def _zeros(self, shape) -> NDArray:
        return NDArray(torch.zeros(shape, dtype=torch.float32,
                                   device=self._context.torch_device))

    # -- bind ---------------------------------------------------------- #
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, grad_req="write",
             shared_module=None):
        if self.binded and not force_rebind:
            return
        self._data_shapes = _norm_shapes(data_shapes)
        self._label_shapes = _norm_shapes(label_shapes)
        self._grad_req = grad_req if for_training else "null"
        self._inputs_need_grad = inputs_need_grad
        self._for_training = for_training
        known = dict(self._data_shapes + self._label_shapes)
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**known)
        if arg_shapes is None:
            raise MXNetError(
                "bind: cannot infer parameter shapes from data/label shapes;"
                f" arguments: {self._symbol.list_arguments()}")
        arg_names = self._symbol.list_arguments()
        self._arg_shape = dict(zip(arg_names, arg_shapes))
        self._aux_shape = dict(zip(self._aux_names, aux_shapes))
        if shared_module is not None and shared_module._exec is not None:
            # bucketing: the master module's arrays, shared by reference
            args = {n: shared_module._exec.arg_dict[n]
                    for n in self._param_names}
            aux = dict(shared_module._exec.aux_dict)
            self._opt_states = shared_module._opt_states
            self._optimizer = shared_module._optimizer
            self.params_initialized = shared_module.params_initialized
            self.optimizer_initialized = shared_module.optimizer_initialized
        else:
            args = {n: self._zeros(self._arg_shape[n])
                    for n in self._param_names}
            aux = {n: self._zeros(self._aux_shape[n]) for n in self._aux_names}
        for n, s in self._data_shapes + self._label_shapes:
            args[n] = self._zeros(s)
        req = {}
        for n in arg_names:
            if n in self._param_names:
                req[n] = self._grad_req
            elif n in self._data_names and inputs_need_grad and for_training:
                req[n] = "write"
            else:
                req[n] = "null"
        self._exec = self._symbol.bind(self._context, args=args,
                                       grad_req=req, aux_states=aux)
        self.binded = True

    # -- params -------------------------------------------------------- #
    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False):
        if self.params_initialized and not force_init:
            return
        if not self.binded:
            raise MXNetError("init_params: call bind first")
        initializer = initializer or _init_mod.Uniform(0.01)
        # Module.load's parameters land at the first init_params
        if arg_params is None:
            arg_params = getattr(self, "_loaded_args", None)
            self._loaded_args = None
        if aux_params is None:
            aux_params = getattr(self, "_loaded_aux", None)
            self._loaded_aux = None
        for name in self._param_names:
            dst = self._exec.arg_dict[name]
            if arg_params and name in arg_params:
                Executor._set_in_place(dst, arg_params[name], "parameter",
                                       name)
            else:
                if arg_params and not allow_missing:
                    raise MXNetError(
                        f"init_params: parameter {name!r} missing from "
                        f"arg_params and allow_missing=False")
                initializer(name, dst)
        for name in self._aux_names:
            dst = self._exec.aux_dict[name]
            if aux_params and name in aux_params:
                Executor._set_in_place(dst, aux_params[name], "aux state",
                                       name)
            else:
                if aux_params and not allow_missing:
                    raise MXNetError(
                        f"init_params: aux state {name!r} missing from "
                        f"aux_params and allow_missing=False")
                with torch.no_grad():
                    dst._data.fill_(
                        1.0 if name.endswith(("moving_var", "running_var"))
                        else 0.0)
        self.params_initialized = True

    def get_params(self):
        arg = {n: self._exec.arg_dict[n] for n in self._param_names}
        return arg, dict(self._exec.aux_dict)

    def set_params(self, arg_params, aux_params=None, allow_missing=False,
                   force_init=True, allow_extra=False):
        if not self.binded:
            raise MXNetError("set_params: call bind first")
        self._exec.copy_params_from(arg_params or {}, aux_params or {},
                                    allow_extra_params=allow_extra)
        self.params_initialized = True

    # -- optimizer ----------------------------------------------------- #
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=None, force_init=False):
        if self.optimizer_initialized and not force_init:
            return
        if isinstance(optimizer, _opt_mod.Optimizer):
            self._optimizer = optimizer
        else:
            self._optimizer = _opt_mod.create(
                optimizer, **(optimizer_params or {}))
        self._optimizer.param_idx2name = dict(enumerate(self._param_names))
        self._opt_states = {
            n: self._optimizer.create_state(
                i, self._exec.arg_dict[n]._data.detach())
            for i, n in enumerate(self._param_names)}
        preload = getattr(self, "_preload_opt_states", None)
        if preload is not None:
            self._load_opt_states(preload)
            self._preload_opt_states = None
        self.optimizer_initialized = True

    def _load_opt_states(self, fname):
        """A ``.states`` file: the capsule (either package's) or MXNet's
        pickle of host states."""
        from .. import checkpoint as _ckpt
        with open(fname, "rb") as f:
            payload = f.read()
        if _ckpt.is_capsule_bytes(payload):
            arrays, meta = _ckpt.load_capsule_bytes(payload)
            for n, count in (meta.get("opt_leaf_counts") or {}).items():
                if n in self._opt_states:
                    _ckpt.fill_state(self._opt_states[n], arrays, f"opt/{n}",
                                     expect=int(count))
            self._optimizer.num_update = int(meta.get("num_update", 0))
            self._optimizer._index_update_count = {
                int(k): int(v) for k, v in
                (meta.get("index_update_count") or {}).items()}
            return
        saved = pickle.loads(payload)
        with torch.no_grad():
            for n, s in saved.items():
                if n in self._opt_states:
                    for dst, src in zip(tree_leaves(self._opt_states[n]),
                                        tree_leaves(s)):
                        dst.copy_(torch.as_tensor(np.asarray(src)))

    # -- execution ----------------------------------------------------- #
    def forward(self, data_batch, is_train=None):
        if not self.binded:
            raise MXNetError("forward: call bind first")
        if is_train is None:
            is_train = getattr(self, "_for_training", True)
        feeds = dict(zip(self._data_names, data_batch.data))
        if data_batch.label is not None:
            feeds.update(zip(self._label_names, data_batch.label))
        # sparse batches (LibSVMIter's CSR) become dense at the graph's
        # boundary: the executor's graph reads a dense (B, feat) buffer
        feeds = {name: arr.tostype("default")
                 if getattr(arr, "stype", "default") != "default" else arr
                 for name, arr in feeds.items()}
        self._exec.forward(is_train=is_train, **feeds)

    def backward(self, out_grads=None):
        self._exec.backward(out_grads)

    def update(self):
        """One optimizer update per parameter, written in place."""
        if not self.optimizer_initialized:
            raise MXNetError("update: call init_optimizer first")
        for i, name in enumerate(self._param_names):
            grad = self._exec.grad_dict.get(name)
            if grad is None:
                continue
            weight = self._exec.arg_dict[name]._data
            state = self._opt_states[name]
            new_w, new_s = self._optimizer.update(
                i, weight.detach(), grad._data.detach(), state)
            with torch.no_grad():
                weight.copy_(new_w)
                for old, new in zip(tree_leaves(state), tree_leaves(new_s)):
                    if old is not new:
                        old.copy_(new)

    def get_outputs(self, merge_multi_context=True):
        return list(self._exec.outputs)

    def get_input_grads(self, merge_multi_context=True):
        if not self._inputs_need_grad:
            raise MXNetError("bind with inputs_need_grad=True first")
        return [self._exec.grad_dict[n] for n in self._data_names]

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self.get_outputs())

    # -- checkpoints --------------------------------------------------- #
    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        from ..model import save_checkpoint
        arg, aux = self.get_params()
        save_checkpoint(prefix, epoch, self._symbol, arg, aux)
        if save_optimizer_states:
            from .. import checkpoint as _ckpt
            tree, leaf_counts = {}, {}
            for n, s in self._opt_states.items():
                leaves, _ = _ckpt.flatten_state(s)
                leaf_counts[n] = len(leaves)
                for j, leaf in enumerate(leaves):
                    tree[f"opt/{n}/{j}"] = leaf
            meta = {"kind": "module-states",
                    "opt_leaf_counts": leaf_counts,
                    "num_update": int(self._optimizer.num_update),
                    # Adam / LAMB bias correction needs the per-parameter
                    # counts
                    "index_update_count": {
                        str(k): int(v) for k, v in
                        self._optimizer._index_update_count.items()}}
            _ckpt.save_capsule_file(f"{prefix}-{epoch:04d}.states", tree,
                                    meta)

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        from ..model import load_checkpoint
        sym, arg, aux = load_checkpoint(prefix, epoch)
        mod = Module(sym, **kwargs)
        mod._loaded_args = arg      # applied by the first init_params
        mod._loaded_aux = aux
        if load_optimizer_states:
            mod._preload_opt_states = f"{prefix}-{epoch:04d}.states"
        return mod
