"""Inception v3 (Szegedy et al., "Rethinking the Inception Architecture").

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/inception.py`` (the same
children in the same order, so parameter names and counts match and
``convert.gluon_params_from_jax`` carries weights across).

Same factory surface as the reference zoo. Every mixed block is written as
data: a list of branches, each branch a list of conv-spec dicts optionally
preceded by a pooling tag or containing a ("split", a, b) fan-out pair. One
interpreter turns the tables into HybridBlocks. Input is 3x299x299.
"""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn
from .squeezenet import HybridConcurrent

__all__ = ["Inception3", "inception_v3"]


def C(channels, kernel, stride=None, pad=None):
    """Conv spec shorthand used by the block tables below."""
    spec = {"channels": channels, "kernel_size": kernel}
    if stride is not None:
        spec["strides"] = stride
    if pad is not None:
        spec["padding"] = pad
    return spec


def _bn_conv(spec):
    unit = nn.HybridSequential(prefix="")
    unit.add(nn.Conv2D(use_bias=False, **spec))
    unit.add(nn.BatchNorm(epsilon=0.001))
    unit.add(nn.Activation("relu"))
    return unit


class _Fork(HybridBlock):
    """Apply two conv paths to one input and concatenate on channels."""

    def __init__(self, left, right, **kwargs):
        super().__init__(**kwargs)
        self.a = _branch(left)
        self.b = _branch(right)

    def hybrid_forward(self, F, x):
        return F.Concat(self.a(x), self.b(x), dim=1, num_args=2)


def _branch(steps):
    """A branch: optional leading "avg"/"max" pool tag, then conv specs or
    ("split", left, right) fan-outs."""
    seq = nn.HybridSequential(prefix="")
    for step in steps:
        if step == "avg":
            seq.add(nn.AvgPool2D(pool_size=3, strides=1, padding=1))
        elif step == "max":
            seq.add(nn.MaxPool2D(pool_size=3, strides=2))
        elif isinstance(step, tuple) and step and step[0] == "split":
            seq.add(_Fork(step[1], step[2]))
        else:
            seq.add(_bn_conv(step))
    return seq


def _mixed(branches, prefix):
    block = HybridConcurrent(prefix=prefix)
    for steps in branches:
        block.add(_branch(steps))
    return block


def _table_a(pool_width):
    return [
        [C(64, 1)],
        [C(48, 1), C(64, 5, pad=2)],
        [C(64, 1), C(96, 3, pad=1), C(96, 3, pad=1)],
        ["avg", C(pool_width, 1)],
    ]


_TABLE_B = [
    [C(384, 3, stride=2)],
    [C(64, 1), C(96, 3, pad=1), C(96, 3, stride=2)],
    ["max"],
]


def _table_c(w):
    return [
        [C(192, 1)],
        [C(w, 1), C(w, (1, 7), pad=(0, 3)), C(192, (7, 1), pad=(3, 0))],
        [C(w, 1), C(w, (7, 1), pad=(3, 0)), C(w, (1, 7), pad=(0, 3)),
         C(w, (7, 1), pad=(3, 0)), C(192, (1, 7), pad=(0, 3))],
        ["avg", C(192, 1)],
    ]


_TABLE_D = [
    [C(192, 1), C(320, 3, stride=2)],
    [C(192, 1), C(192, (1, 7), pad=(0, 3)), C(192, (7, 1), pad=(3, 0)),
     C(192, 3, stride=2)],
    ["max"],
]

_SPLIT_13_31 = ("split", [C(384, (1, 3), pad=(0, 1))],
                [C(384, (3, 1), pad=(1, 0))])

_TABLE_E = [
    [C(320, 1)],
    [C(384, 1), _SPLIT_13_31],
    [C(448, 1), C(384, 3, pad=1), _SPLIT_13_31],
    ["avg", C(192, 1)],
]

# the full network: stem convs/pools then the mixed-block schedule
_STEM = (C(32, 3, stride=2), C(32, 3), C(64, 3, pad=1), "max",
         C(80, 1), C(192, 3), "max")
_SCHEDULE = (
    (_table_a(32), "A1_"), (_table_a(64), "A2_"), (_table_a(64), "A3_"),
    (_TABLE_B, "B_"),
    (_table_c(128), "C1_"), (_table_c(160), "C2_"),
    (_table_c(160), "C3_"), (_table_c(192), "C4_"),
    (_TABLE_D, "D_"),
    (_TABLE_E, "E1_"), (_TABLE_E, "E2_"),
)


class Inception3(HybridBlock):
    """Inception v3 trunk + dropout + linear classifier."""

    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            for step in _STEM:
                if step == "max":
                    self.features.add(nn.MaxPool2D(pool_size=3, strides=2))
                else:
                    self.features.add(_bn_conv(step))
            for table, prefix in _SCHEDULE:
                self.features.add(_mixed(table, prefix))
            self.features.add(nn.AvgPool2D(pool_size=8))
            self.features.add(nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def inception_v3(pretrained=False, **kwargs):
    """Build Inception v3; ``pretrained`` is unsupported offline."""
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are a download in the reference "
            "(model_store.py); offline build has none")
    return Inception3(**kwargs)
