"""Training callbacks: the port of the JAX package's
``incubator_mxnet_tpu/callback.py`` (``Speedometer``, ``ProgressBar``,
``do_checkpoint``, ``log_train_metric``,
``LogValidationMetricsCallback``)."""

from __future__ import annotations

import logging
import time

__all__ = ["Speedometer", "do_checkpoint", "log_train_metric",
           "ProgressBar", "LogValidationMetricsCallback"]


class Speedometer:
    """Log throughput every ``frequent`` batches (parity:
    mx.callback.Speedometer). Reports samples/sec; with ``auto_reset`` the
    attached eval metric resets after each log line."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self.init = False
        self.tic = 0.0
        self.last_count = 0

    def __call__(self, param):
        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count
        if self.init:
            if count % self.frequent == 0:
                speed = self.frequent * self.batch_size / \
                    (time.time() - self.tic)
                if param.eval_metric is not None:
                    name_value = param.eval_metric.get_name_value()
                    if self.auto_reset:
                        param.eval_metric.reset()
                    metrics = "\t".join(f"{n}={v:.6f}" for n, v in name_value)
                    logging.info(
                        "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec\t%s",
                        param.epoch, count, speed, metrics)
                else:
                    logging.info(
                        "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                        param.epoch, count, speed)
                self.tic = time.time()
        else:
            self.init = True
            self.tic = time.time()


class ProgressBar:
    """(parity: mx.callback.ProgressBar)"""

    def __init__(self, total, length=80):
        self.total = total
        self.length = length

    def __call__(self, param):
        count = param.nbatch
        filled = int(round(self.length * count / float(self.total)))
        percents = int(round(100.0 * count / float(self.total)))
        bar = "=" * filled + "-" * (self.length - filled)
        print(f"[{bar}] {percents}%", end="\r")


def do_checkpoint(prefix, period=1):
    """Epoch-end checkpoint callback (parity: mx.callback.do_checkpoint)."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            from .model import save_checkpoint
            save_checkpoint(prefix, iter_no + 1, sym, arg or {}, aux or {})

    return _callback


def log_train_metric(period, auto_reset=False):
    """(parity: mx.callback.log_train_metric)"""

    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            for name, value in name_value:
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()

    return _callback


class LogValidationMetricsCallback:
    """Log every validation metric at epoch end (parity:
    callback.LogValidationMetricsCallback)."""

    def __call__(self, param):
        if param.eval_metric is None:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info("Epoch[%d] Validation-%s=%f", param.epoch, name,
                         value)
