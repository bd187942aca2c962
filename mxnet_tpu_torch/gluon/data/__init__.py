"""Gluon datasets, samplers and the DataLoader (reference:
gluon/data/). ``vision`` (the MNIST / CIFAR readers) and
``RecordFileDataset`` wait for the RecordIO readers (ROADMAP.md Queue
A12)."""
from .dataloader import DataLoader  # noqa: F401
from .dataset import ArrayDataset, Dataset, SimpleDataset  # noqa: F401
from .sampler import (BatchSampler, RandomSampler,  # noqa: F401
                      SequentialSampler, Sampler)
