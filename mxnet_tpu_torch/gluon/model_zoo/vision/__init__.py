"""Vision model zoo (reference: gluon/model_zoo/vision/): the ResNets.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/__init__.py`` for the
ten ResNets; alexnet, vgg, squeezenet, mobilenet, densenet and inception
are not yet ported (ROADMAP.md Queue A6).
"""
from .resnet import *  # noqa: F401,F403
from .resnet import (get_resnet, resnet18_v1, resnet34_v1, resnet50_v1,
                     resnet101_v1, resnet152_v1, resnet18_v2, resnet34_v2,
                     resnet50_v2, resnet101_v2, resnet152_v2)

_models = {f.__name__: f for f in (
    resnet18_v1, resnet34_v1, resnet50_v1, resnet101_v1, resnet152_v1,
    resnet18_v2, resnet34_v2, resnet50_v2, resnet101_v2, resnet152_v2)}


def get_model(name, **kwargs):
    """A model by name (reference: model_zoo/__init__.py get_model)."""
    name = name.lower()
    if name not in _models:
        raise ValueError(
            "Model %s is not supported. Available options are\n\t%s" % (
                name, "\n\t".join(sorted(_models.keys()))))
    return _models[name](**kwargs)
