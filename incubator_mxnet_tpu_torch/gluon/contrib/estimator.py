"""The Estimator fit loop: the port of the JAX package's
``incubator_mxnet_tpu/gluon/contrib/estimator.py`` (parity:
python/mxnet/gluon/contrib/estimator/estimator.py, MXNet >= 1.6).

One train driver over (net, loss, metrics, trainer) with an event-handler
protocol: handlers implement any of ``train_begin``, ``epoch_begin``,
``batch_begin``, ``batch_end``, ``epoch_end``, ``train_end``. A
``CheckpointHandler`` writes ``save_parameters`` files, which either
package loads."""

from __future__ import annotations

import time
from typing import List, Optional

from ...base import MXNetError
from ... import autograd
from ... import metric as _metric_mod
from .. import Trainer, loss as _loss_mod

__all__ = ["Estimator", "TrainBegin", "TrainEnd", "EpochBegin", "EpochEnd",
           "BatchBegin", "BatchEnd", "LoggingHandler",
           "CheckpointHandler", "EarlyStoppingHandler", "StopTraining"]


class StopTraining(Exception):
    """Raised by a handler to end fit() early (early stopping)."""


class TrainBegin:
    def train_begin(self, estimator):
        pass


class TrainEnd:
    def train_end(self, estimator):
        pass


class EpochBegin:
    def epoch_begin(self, estimator):
        pass


class EpochEnd:
    def epoch_end(self, estimator):
        pass


class BatchBegin:
    def batch_begin(self, estimator):
        pass


class BatchEnd:
    def batch_end(self, estimator):
        pass


class LoggingHandler(TrainBegin, EpochEnd, BatchEnd):
    """Throughput + metric logging (the Speedometer analogue)."""

    def __init__(self, log_interval=50):
        self.log_interval = log_interval
        self._tick = None
        self._samples = 0

    def train_begin(self, est):
        self._tick = time.time()

    def batch_end(self, est):
        self._samples += est.last_batch_size
        if est.batch_idx % self.log_interval == 0:
            dt = max(time.time() - self._tick, 1e-9)
            vals = ", ".join(f"{n}={v:.4f}"
                             for n, v in est.train_metrics_values())
            est.logger(f"epoch {est.epoch} batch {est.batch_idx}: "
                       f"{self._samples / dt:.1f} samples/s {vals}")
            self._tick, self._samples = time.time(), 0

    def epoch_end(self, est):
        vals = ", ".join(f"{n}={v:.4f}"
                         for n, v in est.train_metrics_values())
        est.logger(f"epoch {est.epoch} done: {vals}")


class CheckpointHandler(EpochEnd):
    """Save params each epoch (parity: estimator CheckpointHandler)."""

    def __init__(self, model_dir, model_prefix="model"):
        self.model_dir = model_dir
        self.model_prefix = model_prefix

    def epoch_end(self, est):
        import os
        path = os.path.join(self.model_dir,
                            f"{self.model_prefix}-{est.epoch:04d}.params")
        est.net.save_parameters(path)
        est.logger(f"saved checkpoint {path}")


class EarlyStoppingHandler(EpochEnd):
    """Stop when a monitored metric stops improving."""

    def __init__(self, monitor="loss", mode="min", patience=2):
        self.monitor = monitor
        self.mode = mode
        self.patience = patience
        self._best = None
        self._bad = 0

    def epoch_end(self, est):
        vals = dict(est.train_metrics_values())
        if self.monitor not in vals:
            return
        v = vals[self.monitor]
        better = self._best is None or \
            (v < self._best if self.mode == "min" else v > self._best)
        if better:
            self._best, self._bad = v, 0
        else:
            self._bad += 1
            if self._bad >= self.patience:
                raise StopTraining


class Estimator:
    """fit() driver (parity: gluon.contrib.estimator.Estimator)."""

    def __init__(self, net, loss, train_metrics=None, trainer=None,
                 context=None, logger=print):
        self.net = net
        self.loss = loss if isinstance(loss, _loss_mod.Loss) else loss
        metrics = train_metrics or []
        if not isinstance(metrics, (list, tuple)):
            metrics = [metrics]
        self.train_metrics = [
            m if isinstance(m, _metric_mod.EvalMetric)
            else _metric_mod.create(m) for m in metrics]
        self._loss_metric = _metric_mod.Loss()
        self.trainer = trainer
        self.logger = logger
        self.epoch = 0
        self.batch_idx = 0
        self.last_batch_size = 0

    def train_metrics_values(self):
        vals = [("loss", self._loss_metric.get()[1])]
        for m in self.train_metrics:
            vals.append(m.get_name_value()[0])
        return vals

    def _dispatch(self, handlers, event):
        for h in handlers:
            fn = getattr(h, event, None)
            if fn is not None:
                fn(self)

    def evaluate(self, val_data, metrics=None):
        metrics = metrics or self.train_metrics
        for m in metrics:
            m.reset()
        for batch in val_data:
            if hasattr(batch, "data"):
                data, label = batch.data[0], batch.label[0]
            else:
                data, label = batch[0], batch[1]
            out = self.net(data)
            for m in metrics:
                m.update([label], [out])
        return [m.get_name_value()[0] for m in metrics]

    def fit(self, train_data, val_data=None, epochs=1,
            event_handlers: Optional[List] = None, batch_axis=0):
        if self.trainer is None:
            self.trainer = Trainer(self.net.collect_params(), "sgd",
                                   {"learning_rate": 0.01})
        handlers = list(event_handlers or [])
        if not any(isinstance(h, LoggingHandler) for h in handlers):
            handlers.append(LoggingHandler())
        try:
            self._dispatch(handlers, "train_begin")
            for epoch in range(epochs):
                self.epoch = epoch
                self._loss_metric.reset()
                for m in self.train_metrics:
                    m.reset()
                if hasattr(train_data, "reset"):
                    train_data.reset()
                self._dispatch(handlers, "epoch_begin")
                for i, batch in enumerate(train_data):
                    self.batch_idx = i
                    if hasattr(batch, "data"):
                        data, label = batch.data[0], batch.label[0]
                    else:
                        data, label = batch[0], batch[1]
                    self.last_batch_size = data.shape[batch_axis]
                    self._dispatch(handlers, "batch_begin")
                    with autograd.record():
                        out = self.net(data)
                        l = self.loss(out, label)
                    l.backward()
                    self.trainer.step(self.last_batch_size)
                    self._loss_metric.update(None, [l])
                    for m in self.train_metrics:
                        m.update([label], [out])
                    self._dispatch(handlers, "batch_end")
                if val_data is not None:
                    for name, v in self.evaluate(val_data):
                        self.logger(f"epoch {epoch} validation "
                                    f"{name}={v:.4f}")
                self._dispatch(handlers, "epoch_end")
        except StopTraining:
            self.logger(f"early stop at epoch {self.epoch}")
        self._dispatch(handlers, "train_end")
        return self
