"""Gluon loss blocks.

Counterpart of ``mxnet_tpu/gluon/loss.py`` (reference: gluon/loss.py): the
class names, constructor signatures and weighting semantics. Every loss
computes an elementwise term and hands it to one ``_finish`` step (sample
weights, the scalar weight, the mean over every axis but the batch axis,
``F.mean(..., exclude=True)``). ``CTCLoss`` only brings its layouts to
the ``ctc_loss`` op's (``ops/contrib.py``).
"""
from __future__ import annotations

from ..symbol import Symbol
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "HuberLoss", "HingeLoss", "SquaredHingeLoss",
           "LogisticLoss", "TripletLoss", "CTCLoss"]


def _apply_weighting(F, loss, weight=None, sample_weight=None):
    """Optional per-sample weights then optional scalar weight."""
    if sample_weight is not None:
        loss = F.broadcast_mul(loss, sample_weight)
    if weight is not None:
        if not isinstance(weight, (float, int)):
            raise AssertionError("weight must be a number")
        loss = loss * weight
    return loss


def _reshape_like(F, x, y):
    # a Symbol has no shape to read: its graph reshapes at run time
    if isinstance(x, Symbol):
        return F.reshape_like(x, y)
    return x.reshape(y.shape)


def _stable_bce(F, pred, label):
    """-log sigmoid pieces computed as relu(x) - x*y + softplus(-|x|)."""
    return (F.relu(pred) - pred * label
            + F.Activation(-F.abs(pred), act_type="softrelu"))


class Loss(HybridBlock):
    """Base class: holds the scalar weight and the batch axis."""

    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return "{name}(batch_axis={_batch_axis}, w={_weight})".format(
            name=type(self).__name__, **self.__dict__)

    def _finish(self, F, loss, sample_weight, weight=None):
        """Weighting + mean over everything except the batch axis."""
        loss = _apply_weighting(F, loss,
                                self._weight if weight is None else weight,
                                sample_weight)
        return F.mean(loss, axis=self._batch_axis, exclude=True)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


class L2Loss(Loss):
    """Half squared error."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        term = F.square(pred - _reshape_like(F, label, pred))
        return self._finish(F, term, sample_weight, weight=self._weight / 2)


class L1Loss(Loss):
    """Absolute error."""

    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        term = F.abs(pred - _reshape_like(F, label, pred))
        return self._finish(F, term, sample_weight)


class SigmoidBinaryCrossEntropyLoss(Loss):
    """BCE over logits (default) or over probabilities (from_sigmoid)."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        if self._from_sigmoid:
            term = -(F.log(pred + 1e-12) * label
                     + F.log(1. - pred + 1e-12) * (1. - label))
        else:
            term = _stable_bce(F, pred, label)
        return self._finish(F, term, sample_weight)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class SoftmaxCrossEntropyLoss(Loss):
    """CE with integer (sparse) or dense labels; logits by default."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        logp = pred if self._from_logits else F.log_softmax(pred,
                                                            axis=self._axis)
        if self._sparse_label:
            term = -F.pick(logp, label, axis=self._axis, keepdims=True)
        else:
            term = -F.sum(logp * _reshape_like(F, label, logp),
                          axis=self._axis, keepdims=True)
        return self._finish(F, term, sample_weight)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class KLDivLoss(Loss):
    """KL(label || softmax(pred)); pred already log-probs when from_logits."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        logp = pred if self._from_logits else F.log_softmax(pred,
                                                            axis=self._axis)
        term = label * (F.log(label + 1e-12) - logp)
        return self._finish(F, term, sample_weight)


class HuberLoss(Loss):
    """Quadratic near zero, linear past ``rho``."""

    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        err = F.abs(pred - _reshape_like(F, label, pred))
        term = F.where(err > self._rho,
                       err - 0.5 * self._rho,
                       (0.5 / self._rho) * F.square(err))
        return self._finish(F, term, sample_weight)


class _MarginLoss(Loss):
    """Common ctor for the margin-based hinge family."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin


class HingeLoss(_MarginLoss):
    """max(0, margin - pred*label) with signed labels."""

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        term = F.relu(self._margin - pred * _reshape_like(F, label, pred))
        return self._finish(F, term, sample_weight)


class SquaredHingeLoss(_MarginLoss):
    """Squared hinge."""

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        term = F.square(
            F.relu(self._margin - pred * _reshape_like(F, label, pred)))
        return self._finish(F, term, sample_weight)


class LogisticLoss(Loss):
    """BCE over logits with signed (default) or binary labels."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        if label_format not in ("signed", "binary"):
            raise ValueError(
                "label_format can only be signed or binary, recieved %s."
                % label_format)
        self._label_format = label_format

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        label = _reshape_like(F, label, pred)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0  # map {-1,1} -> {0,1}
        return self._finish(F, _stable_bce(F, pred, label), sample_weight)


class TripletLoss(_MarginLoss):
    """max(0, margin + d(pred,pos) - d(pred,neg)) with squared distances."""

    def hybrid_forward(self, F, pred, positive, negative):
        gap = (F.square(pred - _reshape_like(F, positive, pred))
               - F.square(pred - _reshape_like(F, negative, pred)))
        per_sample = F.sum(gap, axis=self._batch_axis, exclude=True)
        return _apply_weighting(F, F.relu(per_sample + self._margin),
                                self._weight, None)


class CTCLoss(Loss):
    """Connectionist Temporal Classification over the ``ctc_loss`` op:
    ``pred`` NTC or TNC, ``label`` NT or TN, optional ``pred_lengths`` /
    ``label_lengths``; the per-sample loss, weighted."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        if layout not in ("NTC", "TNC"):
            raise AssertionError(
                "Only 'NTC' and 'TNC' layouts for pred are supported. "
                "Got: %s" % layout)
        if label_layout not in ("NT", "TN"):
            raise AssertionError(
                "Only 'NT' and 'TN' layouts for label are supported. "
                "Got: %s" % label_layout)
        self._layout = layout
        self._label_layout = label_layout
        super().__init__(weight, label_layout.find("N"), **kwargs)

    def hybrid_forward(self, F, pred, label, pred_lengths=None,
                       label_lengths=None, sample_weight=None):
        if self._layout == "NTC":
            pred = F.swapaxes(pred, dim1=0, dim2=1)
        if self._batch_axis == 1:
            label = F.swapaxes(label, dim1=0, dim2=1)
        lengths = [x for x in (pred_lengths, label_lengths) if x is not None]
        raw = F.ctc_loss(pred, label, *lengths,
                         use_data_lengths=pred_lengths is not None,
                         use_label_lengths=label_lengths is not None)
        return _apply_weighting(F, raw, self._weight, sample_weight)
