"""Vision model zoo (reference: gluon/model_zoo/vision/): ResNet, VGG,
AlexNet, MobileNet, SqueezeNet, DenseNet and Inception v3.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/__init__.py``: the same
30 factories under the same names in ``get_model``'s registry.
``pretrained=True`` raises: weights would need a download.
"""
from .resnet import *  # noqa: F401,F403
from .vgg import *  # noqa: F401,F403
from .alexnet import *  # noqa: F401,F403
from .mobilenet import *  # noqa: F401,F403
from .squeezenet import *  # noqa: F401,F403
from .densenet import *  # noqa: F401,F403
from .inception import *  # noqa: F401,F403
from .resnet import (get_resnet, resnet18_v1, resnet34_v1, resnet50_v1,
                     resnet101_v1, resnet152_v1, resnet18_v2, resnet34_v2,
                     resnet50_v2, resnet101_v2, resnet152_v2)
from .vgg import (get_vgg, vgg11, vgg13, vgg16, vgg19, vgg11_bn, vgg13_bn,
                  vgg16_bn, vgg19_bn)
from .alexnet import alexnet
from .mobilenet import (get_mobilenet, mobilenet1_0, mobilenet0_75,
                        mobilenet0_5, mobilenet0_25)
from .squeezenet import squeezenet1_0, squeezenet1_1
from .densenet import densenet121, densenet161, densenet169, densenet201
from .inception import inception_v3

_models = {f.__name__: f for f in (
    resnet18_v1, resnet34_v1, resnet50_v1, resnet101_v1, resnet152_v1,
    resnet18_v2, resnet34_v2, resnet50_v2, resnet101_v2, resnet152_v2,
    vgg11, vgg13, vgg16, vgg19, vgg11_bn, vgg13_bn, vgg16_bn, vgg19_bn,
    alexnet, mobilenet1_0, mobilenet0_75, mobilenet0_5, mobilenet0_25,
    squeezenet1_0, squeezenet1_1, densenet121, densenet161, densenet169,
    densenet201, inception_v3)}


def get_model(name, **kwargs):
    """A model by name (reference: model_zoo/__init__.py get_model)."""
    name = name.lower()
    if name not in _models:
        raise ValueError(
            "Model %s is not supported. Available options are\n\t%s" % (
                name, "\n\t".join(sorted(_models.keys()))))
    return _models[name](**kwargs)
