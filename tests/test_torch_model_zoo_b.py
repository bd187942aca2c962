"""Port parity for Gluon's model zoo, part b: SqueezeNet 1.0 / 1.1 and
MobileNet (``zoo_parity`` of part a: logits, one step), and every new
factory's parameter names and count: at 1000 classes and full input the
headline members' counts are the JAX package's published ones
(``tests/test_gluon.py:350-360``), the others equal the JAX package's.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from test_torch_model_zoo_a import CPU, _stripped, zoo_parity


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name,size,train", [
    ("squeezenet1_0", 64, False), ("squeezenet1_1", 48, False),
    ("mobilenet0_25", 128, True)])
def test_family_matches_the_reference(name, size, train):
    zoo_parity(name, size, train, jax_hybrid=True)


# JAX package's published counts (tests/test_gluon.py:350-360)
PUBLISHED = {"alexnet": 61100840, "vgg16": 138357544,
             "squeezenet1_0": 1248424, "mobilenet1_0": 4253864,
             "densenet121": 8062504, "inception_v3": 23869000}
NEW = ["vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn", "vgg13_bn",
       "vgg16_bn", "vgg19_bn", "alexnet", "mobilenet1_0", "mobilenet0_75",
       "mobilenet0_5", "mobilenet0_25", "squeezenet1_0", "squeezenet1_1",
       "densenet121", "densenet161", "densenet169", "densenet201",
       "inception_v3"]


def _count(mx, name):
    net = mx.gluon.model_zoo.get_model(name, classes=1000, prefix="zoo_")
    size = 299 if name.startswith("inception") else 224
    net.infer_shape(mx.nd.zeros((1, 3, size, size),
                                **({"ctx": CPU} if mx is tmx else {})))
    return sum(int(np.prod(p.shape)) for p in net.collect_params().values())


@pytest.mark.parametrize("name", NEW)
def test_parameter_count_and_names_match_the_reference(name):
    count = _count(tmx, name)
    if name in PUBLISHED:
        assert count == PUBLISHED[name]
    else:
        assert count == _count(jmx, name)
    names = [list(_stripped(mx.gluon.model_zoo.get_model(name)))
             for mx in (jmx, tmx)]
    assert names[0] == names[1]


