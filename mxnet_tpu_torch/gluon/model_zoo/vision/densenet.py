"""DenseNet (Huang et al., "Densely Connected Convolutional Networks").

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/densenet.py`` (the same
children in the same order, so parameter names and counts match and
``convert.gluon_params_from_jax`` carries weights across).

Same factory surface as the reference zoo. Built around one BN-ReLU-conv
primitive shared by dense layers and transitions; the feature-width
bookkeeping walks the block table once.
"""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201"]

# depth -> (stem width, growth rate, layers per dense block)
_SPECS = {121: (64, 32, [6, 12, 24, 16]),
          161: (96, 48, [6, 12, 36, 24]),
          169: (64, 32, [6, 12, 32, 32]),
          201: (64, 32, [6, 12, 48, 32])}


def _bn_relu_conv(seq, channels, kernel, pad=0):
    seq.add(nn.BatchNorm())
    seq.add(nn.Activation("relu"))
    seq.add(nn.Conv2D(channels, kernel_size=kernel, padding=pad,
                      use_bias=False))


class _DenseLayer(HybridBlock):
    """Bottlenecked growth unit; output is input ++ new features."""

    def __init__(self, growth_rate, bn_size, dropout, **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential(prefix="")
        _bn_relu_conv(self.body, bn_size * growth_rate, 1)
        _bn_relu_conv(self.body, growth_rate, 3, pad=1)
        if dropout:
            self.body.add(nn.Dropout(dropout))

    def hybrid_forward(self, F, x):
        return F.Concat(x, self.body(x), dim=1, num_args=2)


def _dense_stage(count, bn_size, growth_rate, dropout, index):
    stage = nn.HybridSequential(prefix="stage%d_" % index)
    with stage.name_scope():
        for _ in range(count):
            stage.add(_DenseLayer(growth_rate, bn_size, dropout))
    return stage


def _transition(width):
    """Halve spatial resolution and compress channels between stages."""
    seq = nn.HybridSequential(prefix="")
    _bn_relu_conv(seq, width, 1)
    seq.add(nn.AvgPool2D(pool_size=2, strides=2))
    return seq


class DenseNet(HybridBlock):
    """Stem, alternating dense blocks and transitions, BN-ReLU head."""

    def __init__(self, num_init_features, growth_rate, block_config,
                 bn_size=4, dropout=0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.Conv2D(num_init_features, kernel_size=7,
                                        strides=2, padding=3, use_bias=False))
            self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2, padding=1))
            width = num_init_features
            last = len(block_config) - 1
            for i, count in enumerate(block_config):
                self.features.add(_dense_stage(count, bn_size, growth_rate,
                                               dropout, i + 1))
                width += count * growth_rate
                if i != last:
                    width //= 2
                    self.features.add(_transition(width))
            self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.AvgPool2D(pool_size=7))
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def _densenet(depth, pretrained=False, **kwargs):
    if pretrained:
        raise NotImplementedError(
            "pretrained weights are a download in the reference "
            "(model_store.py); offline build has none")
    stem, growth, table = _SPECS[depth]
    return DenseNet(stem, growth, table, **kwargs)


def _factory(depth):
    def make(**kwargs):
        return _densenet(depth, **kwargs)
    make.__name__ = "densenet%d" % depth
    make.__doc__ = "DenseNet-%d." % depth
    return make


for _d in _SPECS:
    globals()["densenet%d" % _d] = _factory(_d)
del _d
