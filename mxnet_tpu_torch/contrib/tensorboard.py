"""TensorBoard metric bridge.

Counterpart of ``mxnet_tpu/contrib/tensorboard.py`` (reference
contrib/tensorboard.py LogMetricsCallback): a batch-end callback emitting
every eval-metric value as a scalar. Accepts a log directory (resolving a
SummaryWriter from ``torch.utils.tensorboard`` where importable, else
tensorboardX) or any ready writer object exposing ``add_scalar(name,
value, global_step)``.
"""
from __future__ import annotations

__all__ = ["LogMetricsCallback"]


def _resolve_writer(logging_dir):
    for module in ("torch.utils.tensorboard", "tensorboardX"):
        try:
            import importlib

            mod = importlib.import_module(module)
            return mod.SummaryWriter(logging_dir)
        except ImportError:
            continue
    raise ImportError(
        "LogMetricsCallback needs a SummaryWriter: install "
        "tensorboard/tensorboardX, or pass summary_writer=")


class LogMetricsCallback(object):
    """Push eval-metric scalars to a SummaryWriter every batch."""

    def __init__(self, logging_dir=None, prefix=None, summary_writer=None):
        self.prefix = prefix
        self.step = 0
        self.summary_writer = (summary_writer if summary_writer is not None
                               else _resolve_writer(logging_dir))

    def _tagged(self, metric):
        for name, value in metric.get_name_value():
            yield (name if self.prefix is None
                   else "%s-%s" % (self.prefix, name)), value

    def __call__(self, param):
        if param.eval_metric is None:
            return
        self.step += 1
        for tag, value in self._tagged(param.eval_metric):
            self.summary_writer.add_scalar(tag, value, self.step)
