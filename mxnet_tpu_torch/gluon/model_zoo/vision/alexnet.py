"""AlexNet (Krizhevsky et al. 2012) for the model zoo.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/alexnet.py`` (the same
children in the same order, so parameter names and counts match and
``convert.gluon_params_from_jax`` carries weights across).

Same factory surface as the reference zoo; the feature extractor is built
from a declarative layer table instead of inline add() calls.
"""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn
from ....base import MXNetError

__all__ = ["AlexNet", "alexnet"]

# (kind, *args): conv = (channels, kernel, stride, pad); fc = (units,)
_LAYER_TABLE = (
    ("conv", 64, 11, 4, 2),
    ("pool",),
    ("conv", 192, 5, 1, 2),
    ("pool",),
    ("conv", 384, 3, 1, 1),
    ("conv", 256, 3, 1, 1),
    ("conv", 256, 3, 1, 1),
    ("pool",),
    ("flatten",),
    ("fc", 4096),
    ("drop",),
    ("fc", 4096),
    ("drop",),
)


def _materialise(seq, table):
    for kind, *args in table:
        if kind == "conv":
            ch, k, s, p = args
            seq.add(nn.Conv2D(ch, kernel_size=k, strides=s, padding=p,
                              activation="relu"))
        elif kind == "pool":
            seq.add(nn.MaxPool2D(pool_size=3, strides=2))
        elif kind == "flatten":
            seq.add(nn.Flatten())
        elif kind == "fc":
            seq.add(nn.Dense(args[0], activation="relu"))
        elif kind == "drop":
            seq.add(nn.Dropout(0.5))


class AlexNet(HybridBlock):
    """5-conv / 3-pool / 2-fc feature stack plus a linear classifier."""

    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            with self.features.name_scope():
                _materialise(self.features, _LAYER_TABLE)
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def alexnet(pretrained=False, **kwargs):
    """Build AlexNet; ``pretrained`` is unsupported offline."""
    if pretrained:
        raise MXNetError("pretrained weights need a download, which is not "
                         "available offline")
    return AlexNet(**kwargs)
