"""Module API (counterpart of ``mxnet_tpu/module/``): ``BaseModule`` and
``Module`` on one device. ``BucketingModule``, ``SequentialModule`` and
``PythonModule`` are not ported yet."""
from .base_module import BaseModule
from .module import Module
