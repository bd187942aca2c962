"""Gluon datasets, samplers and the DataLoader (reference:
gluon/data/), with the vision datasets (``vision``) and
``RecordFileDataset``."""
from . import vision  # noqa: F401
from .dataloader import DataLoader  # noqa: F401
from .dataset import (ArrayDataset, Dataset,  # noqa: F401
                      RecordFileDataset, SimpleDataset)
from .sampler import (BatchSampler, RandomSampler,  # noqa: F401
                      SequentialSampler, Sampler)
