"""SqueezeNet 1.0 / 1.1 (Iandola et al. 2016) for the model zoo.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/squeezenet.py`` (the same
children in the same order, so parameter names and counts match and
``convert.gluon_params_from_jax`` carries weights across).

Same factory surface as the reference zoo. Each version is a declarative
sequence of stem / fire / pool entries; a fire module squeezes to ``s``
channels then expands to 4s + 4s via parallel 1x1 / 3x3 paths.
"""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn
from ....base import MXNetError

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]


class HybridConcurrent(HybridBlock):
    """Apply every child to the same input and concatenate the results."""

    def __init__(self, axis=1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def add(self, block):
        self.register_child(block)

    def hybrid_forward(self, F, x):
        outs = [child(x) for child in self._children]
        return F.Concat(*outs, dim=self.axis, num_args=len(outs))


def _relu_conv(channels, kernel, padding=0):
    seq = nn.HybridSequential(prefix="")
    seq.add(nn.Conv2D(channels, kernel, padding=padding))
    seq.add(nn.Activation("relu"))
    return seq


def _fire(squeeze):
    """Fire module: 1x1 squeeze then concat of 1x1 and 3x3 expands."""
    expand = 4 * squeeze
    seq = nn.HybridSequential(prefix="")
    seq.add(_relu_conv(squeeze, 1))
    branches = HybridConcurrent()
    branches.add(_relu_conv(expand, 1))
    branches.add(_relu_conv(expand, 3, 1))
    seq.add(branches)
    return seq


# version -> (stem (channels, kernel), plan of fire-squeeze sizes and "P" pools)
_PLANS = {
    "1.0": ((96, 7), (16, 16, 32, "P", 32, 48, 48, 64, "P", 64)),
    "1.1": ((64, 3), (16, 16, "P", 32, 32, "P", 48, 48, 64, 64)),
}


class SqueezeNet(HybridBlock):
    """Fire-module CNN with a fully-convolutional classifier head."""

    def __init__(self, version, classes=1000, **kwargs):
        super().__init__(**kwargs)
        if version not in _PLANS:
            raise AssertionError(
                "Unsupported SqueezeNet version {version}: 1.0 or 1.1 "
                "expected".format(version=version))
        (stem_ch, stem_k), plan = _PLANS[version]
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.Conv2D(stem_ch, kernel_size=stem_k, strides=2))
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
            for entry in plan:
                if entry == "P":
                    self.features.add(nn.MaxPool2D(3, 2, ceil_mode=True))
                else:
                    self.features.add(_fire(entry))
            self.features.add(nn.Dropout(0.5))

            self.output = nn.HybridSequential(prefix="")
            self.output.add(nn.Conv2D(classes, kernel_size=1))
            self.output.add(nn.Activation("relu"))
            self.output.add(nn.GlobalAvgPool2D())
            self.output.add(nn.Flatten())

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def get_squeezenet(version, pretrained=False, **kwargs):
    if pretrained:
        raise MXNetError("pretrained weights need a download, which is not "
                         "available offline")
    return SqueezeNet(version, **kwargs)


def squeezenet1_0(**kwargs):
    return get_squeezenet("1.0", **kwargs)


def squeezenet1_1(**kwargs):
    return get_squeezenet("1.1", **kwargs)
