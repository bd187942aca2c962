"""Evaluation metrics.

Counterpart of ``mxnet_tpu/metric.py`` (its own copy: the port imports
nothing of the JAX package): the registry (``mx.metric.create``), the
class names, the ``update(labels, preds)`` / ``get_name_value()`` protocol
and the ``sum_metric`` / ``num_inst`` accumulators. Metric math is numpy
on the host, outside the train step, as in the JAX package: each update
copies its outputs off the card (``NDArray.asnumpy``). ``Loss`` (and its
``Torch`` / ``Caffe`` aliases) is the exception: it sums on the outputs'
device and reads the total once, in :meth:`Loss.get`.
"""
from __future__ import annotations

import math

import numpy

from .base import MXNetError
from .ndarray import NDArray

__all__ = [
    "EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy", "F1",
    "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy",
    "NegativeLogLikelihood", "PearsonCorrelation", "Loss", "Torch", "Caffe",
    "CustomMetric", "np", "create",
]

_REGISTRY = {}


def register(klass, *names):
    """Register a metric class under one or more lowercase names."""
    for alias in names or (klass.__name__.lower(),):
        _REGISTRY[alias.lower()] = klass
    return klass


def create(metric, *args, **kwargs):
    """Resolve a metric from a name, callable, instance, or list thereof."""
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        bundle = CompositeEvalMetric()
        for item in metric:
            bundle.add(create(item, *args, **kwargs))
        return bundle
    if isinstance(metric, str):
        try:
            return _REGISTRY[metric.lower()](*args, **kwargs)
        except KeyError:
            raise MXNetError("Metric must be either callable or in registry; "
                             "got %r" % metric)
    raise TypeError("metric should be string, callable, EvalMetric or list")


def _fwd(local_vars, *extra):
    """Collect the standard ctor passthrough kwargs from a locals() dict."""
    keys = ("output_names", "label_names") + extra
    return {k: local_vars[k] for k in keys}


def _host(x):
    """Bring a device array (or anything array-like) to numpy."""
    return x.asnumpy() if isinstance(x, NDArray) else numpy.asarray(x)


def check_label_shapes(labels, preds, shape=0):
    """Lengths (shape=0) or full shapes (shape=1) must agree."""
    want = len(labels) if shape == 0 else labels.shape
    got = len(preds) if shape == 0 else preds.shape
    if want != got:
        raise ValueError(
            "Shape of labels {} does not match shape of predictions {}"
            .format(want, got))


class EvalMetric:
    """Accumulating metric: update() folds batches into
    (sum_metric, num_inst); get() reports their ratio."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names, self.label_names = output_names, label_names
        self._kwargs = kwargs
        self.reset()

    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))

    def get_config(self):
        cfg = dict(self._kwargs,
                   metric=type(self).__name__,
                   name=self.name,
                   output_names=self.output_names,
                   label_names=self.label_names)
        return cfg

    def _select(self, mapping, wanted):
        return ([mapping[k] for k in wanted] if wanted is not None
                else list(mapping.values()))

    def update_dict(self, label, pred):
        self.update(self._select(label, self.label_names),
                    self._select(pred, self.output_names))

    def update(self, labels, preds):
        raise NotImplementedError()

    def reset(self):
        self.sum_metric = 0.0
        self.num_inst = 0

    def get(self):
        if not self.num_inst:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        names = name if isinstance(name, list) else [name]
        values = value if isinstance(value, list) else [value]
        return list(zip(names, values))


class _PairwiseMetric(EvalMetric):
    """Base for metrics consuming aligned (label, pred) numpy pairs.

    Subclasses implement ``_accumulate(label, pred) -> (value, weight)``.
    """

    check_shapes = True

    def update(self, labels, preds):
        if self.check_shapes:
            check_label_shapes(labels, preds)
        for raw_label, raw_pred in zip(labels, preds):
            # metrics are host-numpy by design (module docstring): one
            # copy per output, outside the train step
            value, weight = self._accumulate(_host(raw_label), _host(raw_pred))
            self.sum_metric += value
            self.num_inst += weight

    def _accumulate(self, label, pred):
        raise NotImplementedError()


@register
class CompositeEvalMetric(EvalMetric):
    """A bundle of metrics updated together and reported jointly."""

    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, **_fwd(locals()))
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        if 0 <= index < len(self.metrics):
            return self.metrics[index]
        return ValueError("Metric index {} is out of range 0 and {}"
                          .format(index, len(self.metrics)))

    def update_dict(self, labels, preds):
        if self.label_names is not None:
            labels = {k: v for k, v in labels.items()
                      if k in self.label_names}
        if self.output_names is not None:
            preds = {k: v for k, v in preds.items()
                     if k in self.output_names}
        for child in self.metrics:
            child.update_dict(labels, preds)

    def update(self, labels, preds):
        for child in self.metrics:
            child.update(labels, preds)

    def reset(self):
        for child in getattr(self, "metrics", ()):
            child.reset()

    def get(self):
        names, values = [], []
        for child in self.metrics:
            name, value = child.get()
            names.extend([name] if isinstance(name, str) else name)
            values.extend([value] if isinstance(value,
                                                (float, int, numpy.generic))
                          else value)
        return (names, values)

    def get_config(self):
        cfg = super().get_config()
        cfg["metrics"] = [child.get_config() for child in self.metrics]
        return cfg


class Accuracy(_PairwiseMetric):
    """Fraction of samples whose arg-max prediction equals the label."""

    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, **_fwd(locals(), "axis"))
        self.axis = axis

    def _accumulate(self, label, pred):
        if pred.shape != label.shape:
            pred = numpy.argmax(pred, axis=self.axis)
        pred = pred.astype("int32").ravel()
        label = label.astype("int32").ravel()
        check_label_shapes(label, pred, shape=1)
        return (pred == label).sum(), pred.size


register(Accuracy, "accuracy", "acc")


class TopKAccuracy(_PairwiseMetric):
    """Fraction of samples whose label is among the k highest scores."""

    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, **_fwd(locals(), "top_k"))
        if top_k <= 1:
            raise AssertionError(
                "Please use Accuracy if top_k is no more than 1")
        self.top_k = top_k
        self.name = "%s_%d" % (self.name, top_k)

    def _accumulate(self, label, pred):
        if pred.ndim > 2:
            raise AssertionError("Predictions should be no more than 2 dims")
        ranked = numpy.argsort(pred.astype("float32"), axis=1)
        label = label.astype("int32")
        check_label_shapes(label, ranked)
        if ranked.ndim == 1:
            return (ranked.ravel() == label.ravel()).sum(), ranked.shape[0]
        classes = ranked.shape[1]
        depth = min(classes, self.top_k)
        # the last `depth` columns of the ascending argsort are the top-k
        hits = (ranked[:, classes - depth:] == label.reshape(-1, 1)).sum()
        return hits, ranked.shape[0]


register(TopKAccuracy, "top_k_accuracy", "top_k_acc")


@register
class F1(_PairwiseMetric):
    """Binary F1 from vectorized confusion counts, averaged per batch."""

    def __init__(self, name="f1", output_names=None, label_names=None):
        super().__init__(name, **_fwd(locals()))

    def _accumulate(self, label, pred):
        label = label.astype("int32")
        decided = numpy.argmax(pred, axis=1)
        check_label_shapes(label, pred)
        if numpy.unique(label).size > 2:
            raise ValueError(
                "F1 currently only supports binary classification.")
        tp = float(((decided == 1) & (label == 1)).sum())
        fp = float(((decided == 1) & (label == 0)).sum())
        fn = float(((decided == 0) & (label == 1)).sum())
        precision = tp / (tp + fp) if tp + fp else 0.0
        recall = tp / (tp + fn) if tp + fn else 0.0
        score = (2 * precision * recall / (precision + recall)
                 if precision + recall else 0.0)
        return score, 1


@register
class Perplexity(EvalMetric):
    """exp(mean negative log prob of the target tokens), with an optional
    ignored padding label."""

    def __init__(self, ignore_label, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, **_fwd(locals(), "ignore_label", "axis"))
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        assert len(labels) == len(preds)
        total_nll, total_count = 0.0, 0
        for raw_label, raw_pred in zip(labels, preds):
            label = _host(raw_label)
            pred = _host(raw_pred)
            if label.size != pred.size // pred.shape[-1]:
                raise AssertionError("shape mismatch: %s vs. %s"
                                     % (label.shape, pred.shape))
            flat = label.reshape(-1).astype("int32")
            target_prob = pred.reshape(-1, pred.shape[-1])[
                numpy.arange(flat.size), flat]
            if self.ignore_label is not None:
                masked = (flat == self.ignore_label)
                total_count -= int(masked.sum())
                target_prob = numpy.where(masked, 1.0, target_prob)
            total_nll -= numpy.log(numpy.maximum(1e-10, target_prob)).sum()
            total_count += flat.size
        self.sum_metric += total_nll
        self.num_inst += total_count

    def get(self):
        if not self.num_inst:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


def _column(arr):
    """Regression inputs as 2-D column matrices."""
    return arr.reshape(arr.shape[0], 1) if arr.ndim == 1 else arr


class _ErrorStat(_PairwiseMetric):
    """Shared body for the per-batch mean-error family; subclasses set
    ``_reduce`` to map a difference matrix to a scalar."""

    _reduce = None

    def __init__(self, name=None, output_names=None, label_names=None):
        super().__init__(name or type(self).__name__.lower(),
                         **_fwd(locals()))

    def _accumulate(self, label, pred):
        diff = _column(label) - _column(pred)
        return type(self)._reduce(diff), 1


@register
class MAE(_ErrorStat):
    """Mean absolute error."""
    _reduce = staticmethod(lambda diff: numpy.abs(diff).mean())


@register
class MSE(_ErrorStat):
    """Mean squared error."""
    _reduce = staticmethod(lambda diff: (diff ** 2.0).mean())


@register
class RMSE(_ErrorStat):
    """Root mean squared error."""
    _reduce = staticmethod(lambda diff: numpy.sqrt((diff ** 2.0).mean()))


class _TargetNLL(_PairwiseMetric):
    """Summed -log(prob of true class) over samples (base for CE / NLL)."""

    def __init__(self, eps=1e-12, name=None, output_names=None,
                 label_names=None):
        super().__init__(name, **_fwd(locals(), "eps"))
        self.eps = eps

    def _accumulate(self, label, pred):
        flat = label.ravel()
        count = pred.shape[0]
        if flat.shape[0] != count:
            raise AssertionError((flat.shape[0], count))
        chosen = pred[numpy.arange(count, dtype=numpy.int64),
                      numpy.int64(flat)]
        return -numpy.log(chosen + self.eps).sum(), count


class CrossEntropy(_TargetNLL):
    """Cross entropy against one-hot labels given class probabilities:
    the summed -log(prob of the true class) over samples."""

    def __init__(self, eps=1e-12, name="cross-entropy", **kwargs):
        super().__init__(eps=eps, name=name, **kwargs)


register(CrossEntropy, "cross-entropy", "ce")


class NegativeLogLikelihood(_TargetNLL):
    """Negative log likelihood of the labels under predicted probabilities."""

    def __init__(self, eps=1e-12, name="nll-loss", **kwargs):
        super().__init__(eps=eps, name=name, **kwargs)


register(NegativeLogLikelihood, "nll-loss", "nll_loss")


@register
class PearsonCorrelation(_PairwiseMetric):
    """Mean per-batch Pearson correlation coefficient."""

    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, **_fwd(locals()))

    def _accumulate(self, label, pred):
        check_label_shapes(label, pred, 1)
        return numpy.corrcoef(pred.ravel(), label.ravel())[0, 1], 1


@register
class Loss(EvalMetric):
    """Running mean of a loss output (labels are ignored).

    The per-batch reduction stays on the outputs' device: ``pred.sum()``
    accumulates into a device scalar, so a fit loop logging Loss every
    batch pays no blocking copy per update — the one copy happens in
    :meth:`get`."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, **_fwd(locals()))

    def update(self, _, preds):
        for pred in preds:
            # reduce in float32 whatever the loss dtype: a bf16 running
            # sum drops every batch once it crosses ~256 (8-bit mantissa)
            if isinstance(pred, NDArray):
                part = pred.astype("float32").sum()
            else:
                part = numpy.asarray(pred, dtype=numpy.float64).sum()
            self.sum_metric = part + self.sum_metric
            self.num_inst += pred.size

    def get(self):
        if not self.num_inst:
            return (self.name, float("nan"))
        total = self.sum_metric
        if isinstance(total, NDArray):
            total = float(total.asnumpy())
        return (self.name, total / self.num_inst)


@register
class Torch(Loss):
    """Alias of Loss kept for reference parity (torch plugin outputs)."""

    def __init__(self, name="torch", output_names=None, label_names=None):
        super().__init__(name, **_fwd(locals()))


@register
class Caffe(Loss):
    """Alias of Loss kept for reference parity (caffe plugin outputs)."""

    def __init__(self, name="caffe", output_names=None, label_names=None):
        super().__init__(name, **_fwd(locals()))


@register
class CustomMetric(EvalMetric):
    """Wrap feval(label, pred) -> value or (sum, count) as a metric."""

    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = feval.__name__
            if "<" in name:
                name = "custom(%s)" % name
        super().__init__(name, **_fwd(locals(), "feval",
                                      "allow_extra_outputs"))
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds)
        for raw_pred, raw_label in zip(preds, labels):
            outcome = self._feval(_host(raw_label), _host(raw_pred))
            if isinstance(outcome, tuple):
                part, weight = outcome
            else:
                part, weight = outcome, 1
            self.sum_metric += part
            self.num_inst += weight

    def get_config(self):
        raise NotImplementedError("CustomMetric cannot be serialized")


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """Lift a plain numpy_feval(label, pred) function into a metric."""
    import functools

    @functools.wraps(numpy_feval)
    def feval(label, pred):
        return numpy_feval(label, pred)

    return CustomMetric(feval, name, allow_extra_outputs)
