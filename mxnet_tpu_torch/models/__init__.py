"""Symbol builders (counterpart of ``mxnet_tpu/models/``)."""
from .lenet import get_lenet
from .mlp import get_mlp
from .resnet import get_resnet
