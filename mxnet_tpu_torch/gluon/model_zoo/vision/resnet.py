"""ResNet v1 (post-activation) and v2 (pre-activation) for the model zoo.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/resnet.py`` (He et al.
2015 / 2016; reference: gluon/model_zoo/vision/resnet.py): the same
classes and factories, built from one table, with the children created in
the reference's order, so parameter names and counts (and ``.params``
files) match. ``pretrained=True`` raises: weights would need a download.
"""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn
from ....base import MXNetError

__all__ = ["ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "resnet18_v1", "resnet34_v1",
           "resnet50_v1", "resnet101_v1", "resnet152_v1", "resnet18_v2",
           "resnet34_v2", "resnet50_v2", "resnet101_v2", "resnet152_v2",
           "get_resnet"]


def _conv(channels, kernel, stride=1, use_bias=False, in_channels=0):
    """Conv2D with 'same'-style padding for odd kernels."""
    return nn.Conv2D(channels, kernel_size=kernel, strides=stride,
                     padding=kernel // 2, use_bias=use_bias,
                     in_channels=in_channels)


def _postact_body(specs, in_channels):
    """v1 residual body: conv/BN pairs from ``specs`` with ReLU between
    (but not after) them. ``specs`` is a list of (channels, kernel, stride)."""
    body = nn.HybridSequential(prefix="")
    last = len(specs) - 1
    src = in_channels
    for i, (ch, k, s) in enumerate(specs):
        body.add(_conv(ch, k, s, in_channels=src if i == 0 else 0))
        body.add(nn.BatchNorm())
        if i != last:
            body.add(nn.Activation("relu"))
        src = ch
    return body


def _shortcut(channels, stride, in_channels, with_bn):
    """1x1 projection used when the unit changes shape."""
    if not with_bn:
        return nn.Conv2D(channels, 1, stride, use_bias=False,
                         in_channels=in_channels)
    proj = nn.HybridSequential(prefix="")
    proj.add(nn.Conv2D(channels, 1, stride, use_bias=False,
                       in_channels=in_channels))
    proj.add(nn.BatchNorm())
    return proj


class _UnitV1(HybridBlock):
    """Post-activation residual unit: relu(x_shortcut + body(x))."""

    _specs = None  # set by subclass: fn(channels, stride) -> conv spec list

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self.body = _postact_body(self._specs(channels, stride), in_channels)
        self.downsample = (_shortcut(channels, stride, in_channels, True)
                           if downsample else None)

    def hybrid_forward(self, F, x):
        skip = x if self.downsample is None else self.downsample(x)
        return F.Activation(skip + self.body(x), act_type="relu")


class BasicBlockV1(_UnitV1):
    """Two 3x3 convs (ResNet-18/34 style)."""

    @staticmethod
    def _specs(channels, stride):
        return [(channels, 3, stride), (channels, 3, 1)]


class BottleneckV1(_UnitV1):
    """1x1 reduce, 3x3, 1x1 expand (ResNet-50+ style). The 1x1 convs carry
    bias (reference layout); only the 3x3 is bias-free."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        HybridBlock.__init__(self, **kwargs)
        mid = channels // 4
        self.body = nn.HybridSequential(prefix="")
        for i, (ch, k, s) in enumerate(
                ((mid, 1, stride), (mid, 3, 1), (channels, 1, 1))):
            self.body.add(nn.Conv2D(ch, kernel_size=k, strides=s,
                                    padding=k // 2, use_bias=(k == 1)))
            self.body.add(nn.BatchNorm())
            if i != 2:
                self.body.add(nn.Activation("relu"))
        self.downsample = (_shortcut(channels, stride, in_channels, True)
                           if downsample else None)


class _UnitV2(HybridBlock):
    """Pre-activation residual unit: x + convs(relu(bn(x))), with the
    projection (when present) taken from the pre-activated tensor."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self._build(channels, stride, in_channels)
        self.downsample = (_shortcut(channels, stride, in_channels, False)
                           if downsample else None)

    def _build(self, channels, stride, in_channels):
        raise NotImplementedError

    def _pairs(self):
        raise NotImplementedError

    def hybrid_forward(self, F, x):
        skip = x
        for i, (bn, conv) in enumerate(self._pairs()):
            x = F.Activation(bn(x), act_type="relu")
            if i == 0 and self.downsample is not None:
                skip = self.downsample(x)
            x = conv(x)
        return x + skip


class BasicBlockV2(_UnitV2):
    """Pre-act twin 3x3 unit."""

    def _build(self, channels, stride, in_channels):
        self.bn1 = nn.BatchNorm()
        self.conv1 = _conv(channels, 3, stride, in_channels=in_channels)
        self.bn2 = nn.BatchNorm()
        self.conv2 = _conv(channels, 3, 1, in_channels=channels)

    def _pairs(self):
        return ((self.bn1, self.conv1), (self.bn2, self.conv2))


class BottleneckV2(_UnitV2):
    """Pre-act 1x1 / 3x3 / 1x1 unit."""

    def _build(self, channels, stride, in_channels):
        mid = channels // 4
        self.bn1 = nn.BatchNorm()
        self.conv1 = nn.Conv2D(mid, kernel_size=1, strides=1, use_bias=False)
        self.bn2 = nn.BatchNorm()
        self.conv2 = _conv(mid, 3, stride, in_channels=mid)
        self.bn3 = nn.BatchNorm()
        self.conv3 = nn.Conv2D(channels, kernel_size=1, strides=1,
                               use_bias=False)

    def _pairs(self):
        return ((self.bn1, self.conv1), (self.bn2, self.conv2),
                (self.bn3, self.conv3))


def _stage(block, count, channels, stride, index, in_channels):
    """``count`` stacked units; only the first may change stride/width."""
    seq = nn.HybridSequential(prefix="stage%d_" % index)
    with seq.name_scope():
        seq.add(block(channels, stride, channels != in_channels,
                      in_channels=in_channels, prefix=""))
        for _ in range(count - 1):
            seq.add(block(channels, 1, False, in_channels=channels, prefix=""))
    return seq


def _add_stem(seq, first_channels, thumbnail, with_bn_relu_pool=True):
    """ImageNet stem (7x7/2 + pool) or CIFAR thumbnail stem (3x3/1)."""
    if thumbnail:
        seq.add(_conv(first_channels, 3, 1))
    else:
        seq.add(nn.Conv2D(first_channels, 7, 2, 3, use_bias=False))
        if with_bn_relu_pool:
            seq.add(nn.BatchNorm())
            seq.add(nn.Activation("relu"))
            seq.add(nn.MaxPool2D(3, 2, 1))


class ResNetV1(HybridBlock):
    """Post-activation ResNet: stem -> 4 stages -> global pool -> classifier."""

    def __init__(self, block, layers, channels, classes=1000, thumbnail=False,
                 **kwargs):
        super().__init__(**kwargs)
        if len(channels) != len(layers) + 1:
            raise ValueError("need one more channel entry than stage count")
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            _add_stem(self.features, channels[0], thumbnail,
                      with_bn_relu_pool=not thumbnail)
            for i, count in enumerate(layers):
                self.features.add(_stage(block, count, channels[i + 1],
                                         1 if i == 0 else 2, i + 1,
                                         channels[i]))
            self.features.add(nn.GlobalAvgPool2D())
            self.output = nn.Dense(classes, in_units=channels[-1])

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


class ResNetV2(HybridBlock):
    """Pre-activation ResNet; input BN first, final BN+ReLU before pooling."""

    def __init__(self, block, layers, channels, classes=1000, thumbnail=False,
                 **kwargs):
        super().__init__(**kwargs)
        if len(channels) != len(layers) + 1:
            raise ValueError("need one more channel entry than stage count")
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.BatchNorm(scale=False, center=False))
            _add_stem(self.features, channels[0], thumbnail,
                      with_bn_relu_pool=not thumbnail)
            width = channels[0]
            for i, count in enumerate(layers):
                self.features.add(_stage(block, count, channels[i + 1],
                                         1 if i == 0 else 2, i + 1, width))
                width = channels[i + 1]
            self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.GlobalAvgPool2D())
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes, in_units=width)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


# depth -> (unit kind, per-stage unit counts, channel schedule)
resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}
resnet_net_versions = [ResNetV1, ResNetV2]
resnet_block_versions = [
    {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1},
    {"basic_block": BasicBlockV2, "bottle_neck": BottleneckV2},
]


def get_resnet(version, num_layers, pretrained=False, ctx=None, **kwargs):
    """Instantiate a ResNet by (version in {1, 2}, depth in resnet_spec)."""
    if num_layers not in resnet_spec:
        raise ValueError("Invalid number of layers: %d. Options are %s"
                         % (num_layers, sorted(resnet_spec)))
    if version not in (1, 2):
        raise ValueError("Invalid resnet version: %d. Options are 1 and 2."
                         % version)
    kind, counts, widths = resnet_spec[num_layers]
    net_cls = resnet_net_versions[version - 1]
    unit_cls = resnet_block_versions[version - 1][kind]
    net = net_cls(unit_cls, counts, widths, **kwargs)
    if pretrained:
        raise MXNetError("pretrained weights need a download, which is "
                         "not available offline; use net.load_params on "
                         "a local file")
    return net


def _factory(version, depth):
    def make(**kwargs):
        return get_resnet(version, depth, **kwargs)
    make.__name__ = "resnet%d_v%d" % (depth, version)
    make.__doc__ = "ResNet-%d v%d (see get_resnet)." % (depth, version)
    return make


for _v in (1, 2):
    for _d in resnet_spec:
        _fn = _factory(_v, _d)
        globals()[_fn.__name__] = _fn
del _v, _d, _fn
