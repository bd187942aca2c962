"""Neural network layers (reference: python/mxnet/gluon/nn/)."""
from .basic_layers import *
from .conv_layers import *
from .basic_layers import Sequential, HybridSequential, Dense, Activation, \
    Dropout, BatchNorm, LeakyReLU, Embedding, Flatten, Lambda, HybridLambda
