"""Evaluation metrics: the port of the JAX package's
``incubator_mxnet_tpu/metric.py``.

A metric takes ``NDArray``s or tensors on any device (array-likes too).
``update`` accumulates on the device of the metric's running sum, a 0-d
f32 tensor made on the current context when the metric is reset (the
card unless the caller asks for the CPU), and reads at most one tensor
back from the device: none for the accuracies and the regression, cross
entropy and loss metrics, one for the confusion counts of ``F1`` and
``MCC``, the kept count of ``Perplexity(ignore_label=...)`` and the pairs
of ``PearsonCorrelation``. ``get`` reads the sum. ``CustomMetric`` hands
its function numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError
from .context import resolve_device
from .ndarray import NDArray
from .ndarray.ndarray import host_array

__all__ = ["EvalMetric", "Torch", "Caffe", "Accuracy", "TopKAccuracy", "F1",
           "MCC", "MAE", "MSE", "RMSE", "CrossEntropy", "Perplexity",
           "NegativeLogLikelihood", "PearsonCorrelation", "Loss",
           "CustomMetric", "np_metric", "CompositeEvalMetric", "create",
           "register"]

_METRICS = {}


def register(name, aliases=()):
    """Register a metric class under ``name`` and ``aliases`` (any case)
    for ``create``."""

    def _do(cls):
        for n in (name,) + tuple(aliases):
            _METRICS[n.lower()] = cls
        return cls

    return _do


def create(metric, *args, **kwargs) -> "EvalMetric":
    """A metric from an instance (returned as is), a list (a composite), a
    function (a ``CustomMetric``) or a registered name."""
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, (list, tuple)):
        composite = CompositeEvalMetric()
        for m in metric:
            composite.add(create(m))
        return composite
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    key = str(metric).lower()
    if key not in _METRICS:
        raise MXNetError(f"metric '{metric}' is not registered. "
                         f"Known: {sorted(_METRICS)}")
    return _METRICS[key](*args, **kwargs)


def _tensor(x) -> torch.Tensor:
    if isinstance(x, NDArray):
        return x._data.detach()
    if torch.is_tensor(x):
        return x.detach()
    return torch.as_tensor(np.asarray(x))


def _host(x) -> np.ndarray:
    return host_array(_tensor(x))


def _squeeze_label(label, pred):
    """Labels shaped (B, 1) against (B, C) predictions lose the trailing
    singleton (the reference ravels labels)."""
    if (label.ndim == pred.ndim and label.shape[-1] == 1
            and pred.shape[-1] != 1):
        return label.reshape(label.shape[:-1])
    return label


def _flat_pairs(labels, preds):
    if isinstance(labels, (list, tuple)):
        if not isinstance(preds, (list, tuple)) or len(labels) != len(preds):
            raise MXNetError("labels and preds must pair up")
        return list(zip(labels, preds))
    return [(labels, preds)]


def _classes(label, pred, axis=-1):
    """int32 (label, predicted class) of a pair, the prediction's argmax
    taken where it has the extra class axis."""
    pred = _tensor(pred)
    label = _squeeze_label(_tensor(label), pred).to(pred.device)
    if pred.ndim > label.ndim:
        pred = pred.argmax(dim=axis)
    return label.to(torch.int32), pred.to(torch.int32)


class EvalMetric:
    """Base class: ``update(labels, preds)`` accumulates, ``get()`` returns
    ``(name, value)``, ``reset()`` starts over."""

    def __init__(self, name, output_names=None, label_names=None):
        self.name = name
        self.output_names = output_names
        self.label_names = label_names
        self.reset()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = torch.zeros((), dtype=torch.float32,
                                      device=resolve_device(None))

    def _add(self, value):
        self.sum_metric = self.sum_metric + value.to(
            self.sum_metric.device, torch.float32)

    def update(self, labels, preds):
        raise NotImplementedError

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, float(self.sum_metric) / self.num_inst

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name, value = [name], [value]
        return list(zip(name, value))

    def __str__(self):
        return f"EvalMetric: {dict(self.get_name_value())}"


@register("acc", aliases=("accuracy",))
class Accuracy(EvalMetric):
    def __init__(self, axis=-1, name="accuracy", **kwargs):
        self.axis = axis
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in _flat_pairs(labels, preds):
            label, pred = _classes(label, pred, self.axis)
            self._add((pred == label).sum())
            self.num_inst += label.numel()


@register("top_k_accuracy", aliases=("topk",))
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", **kwargs):
        self.top_k = top_k
        super().__init__(f"{name}_{top_k}", **kwargs)

    def update(self, labels, preds):
        for label, pred in _flat_pairs(labels, preds):
            pred = _tensor(pred)
            label = _squeeze_label(_tensor(label), pred).to(pred.device,
                                                              torch.int32)
            top = pred.topk(self.top_k, dim=-1).indices
            self._add((top == label[..., None]).any(dim=-1).sum())
            self.num_inst += label.numel()


class _Confusion(EvalMetric):
    """Binary confusion counts, summed on the host (one readback of the
    four counts an update)."""

    def reset(self):
        self._tp = self._tn = self._fp = self._fn = 0.0
        self.num_inst = 0
        self.sum_metric = torch.zeros((), dtype=torch.float32,
                                      device=resolve_device(None))

    def update(self, labels, preds):
        for label, pred in _flat_pairs(labels, preds):
            label, pred = _classes(label, pred)
            p1, l1 = pred == 1, label == 1
            p0, l0 = pred == 0, label == 0
            tp, tn, fp, fn = torch.stack([
                (p1 & l1).sum(), (p0 & l0).sum(), (p1 & l0).sum(),
                (p0 & l1).sum()]).tolist()
            self._tp += tp
            self._tn += tn
            self._fp += fp
            self._fn += fn
            self.num_inst += label.numel()


@register("f1")
class F1(_Confusion):
    """Binary F1 over everything since the last reset."""

    def __init__(self, name="f1", average="macro", **kwargs):
        self.average = average
        super().__init__(name, **kwargs)

    def get(self):
        prec = self._tp / max(self._tp + self._fp, 1e-12)
        rec = self._tp / max(self._tp + self._fn, 1e-12)
        return self.name, 2 * prec * rec / max(prec + rec, 1e-12)


@register("mcc")
class MCC(_Confusion):
    """Matthews correlation coefficient of binary predictions."""

    def __init__(self, name="mcc", **kwargs):
        super().__init__(name, **kwargs)

    def get(self):
        num = self._tp * self._tn - self._fp * self._fn
        den = np.sqrt((self._tp + self._fp) * (self._tp + self._fn) *
                      (self._tn + self._fp) * (self._tn + self._fn))
        return self.name, num / max(den, 1e-12)


class _RegressionMetric(EvalMetric):
    def update(self, labels, preds):
        for label, pred in _flat_pairs(labels, preds):
            pred = _tensor(pred).float()
            label = _tensor(label).to(pred.device).float() \
                .reshape(pred.shape)
            self._add(self._err(label, pred))
            self.num_inst += label.shape[0] if label.ndim else 1

    @staticmethod
    def _per_sample(err):
        if err.ndim > 1:
            return err.mean(dim=tuple(range(1, err.ndim))).sum()
        return err.sum()


@register("mae")
class MAE(_RegressionMetric):
    def __init__(self, name="mae", **kwargs):
        super().__init__(name, **kwargs)

    def _err(self, label, pred):
        return self._per_sample((label - pred).abs())


@register("mse")
class MSE(_RegressionMetric):
    def __init__(self, name="mse", **kwargs):
        super().__init__(name, **kwargs)

    def _err(self, label, pred):
        return self._per_sample((label - pred).square())


@register("rmse")
class RMSE(MSE):
    def __init__(self, name="rmse", **kwargs):
        super().__init__(name=name, **kwargs)

    def get(self):
        name, value = super().get()
        return name, float(np.sqrt(value))


def _picked_nll(label, pred, eps):
    """``-log(max(p[label], eps))`` per row, and the flat labels."""
    label = _tensor(label).to(torch.int64).reshape(-1)
    pred = _tensor(pred)
    pred = pred.reshape(-1, pred.shape[-1])
    p = pred.gather(-1, label[:, None].to(pred.device))[:, 0]
    return -torch.log(torch.clamp(p, min=eps)), label


@register("ce", aliases=("cross-entropy", "crossentropy"))
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", **kwargs):
        self.eps = eps
        super().__init__(name, **kwargs)

    def update(self, labels, preds):
        for label, pred in _flat_pairs(labels, preds):
            nll, label = _picked_nll(label, pred, self.eps)
            self._add(nll.sum())
            self.num_inst += label.shape[0]


@register("nll_loss")
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", **kwargs):
        super().__init__(eps=eps, name=name, **kwargs)


@register("perplexity")
class Perplexity(CrossEntropy):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 **kwargs):
        self.ignore_label = ignore_label
        super().__init__(name=name, **kwargs)

    def update(self, labels, preds):
        for label, pred in _flat_pairs(labels, preds):
            nll, label = _picked_nll(label, pred, self.eps)
            if self.ignore_label is not None:
                keep = (label != self.ignore_label).to(nll.device)
                nll = nll * keep
                self.num_inst += int(keep.sum())
            else:
                self.num_inst += label.shape[0]
            self._add(nll.sum())

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, float(np.exp(float(self.sum_metric)
                                       / self.num_inst))


@register("pearsonr")
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", **kwargs):
        super().__init__(name, **kwargs)

    def reset(self):
        self._xy = []
        self.num_inst = 0
        self.sum_metric = torch.zeros((), dtype=torch.float32,
                                      device=resolve_device(None))

    def update(self, labels, preds):
        for label, pred in _flat_pairs(labels, preds):
            label, pred = _tensor(label), _tensor(pred)
            pair = torch.stack([label.reshape(-1).double(),
                                pred.reshape(-1).double().to(label.device)])
            self._xy.append(pair.cpu().numpy())
            self.num_inst += pair.shape[1]

    def get(self):
        if not self._xy:
            return self.name, float("nan")
        x, y = np.concatenate(self._xy, axis=1)
        return self.name, float(np.corrcoef(x, y)[0, 1])


@register("loss")
class Loss(EvalMetric):
    """Running mean of raw loss values."""

    def __init__(self, name="loss", **kwargs):
        super().__init__(name, **kwargs)

    def update(self, _, preds):
        for pred in (preds if isinstance(preds, (list, tuple)) else [preds]):
            p = _tensor(pred)
            self._add(p.sum())
            self.num_inst += p.numel() or 1


@register("torch")
class Torch(Loss):
    """Legacy framework-output logging metric: a renamed ``Loss``."""

    def __init__(self, name="torch", **kwargs):
        super().__init__(name, **kwargs)


@register("caffe")
class Caffe(Loss):
    """Legacy framework-output logging metric: a renamed ``Loss``."""

    def __init__(self, name="caffe", **kwargs):
        super().__init__(name, **kwargs)


class CustomMetric(EvalMetric):
    """``feval(label, pred)`` on numpy arrays, returning a value or a
    ``(sum, count)`` pair."""

    def __init__(self, feval, name="custom", allow_extra_outputs=False,
                 **kwargs):
        self._feval = feval
        super().__init__(f"custom({getattr(feval, '__name__', name)})",
                         **kwargs)

    def update(self, labels, preds):
        for label, pred in _flat_pairs(labels, preds):
            out = self._feval(_host(label), _host(pred))
            s, n = out if isinstance(out, tuple) else (out, 1)
            self._add(torch.as_tensor(s))
            self.num_inst += n


def np_metric(name=None, allow_extra_outputs=False):
    """Decorator building a ``CustomMetric`` from a numpy function."""

    def deco(fn):
        return CustomMetric(fn, name=name or fn.__name__)

    return deco


class CompositeEvalMetric(EvalMetric):
    """Several metrics updated together; ``get`` returns their names and
    values as lists."""

    def __init__(self, metrics=None, name="composite", **kwargs):
        super().__init__(name, **kwargs)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def get(self):
        names, values = [], []
        for m in self.metrics:
            n, v = m.get()
            names.append(n)
            values.append(v)
        return names, values
