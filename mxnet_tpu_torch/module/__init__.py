"""Module API (counterpart of ``mxnet_tpu/module/``): ``BaseModule``,
``Module`` on one device and ``BucketingModule``. ``SequentialModule`` and
``PythonModule`` are not ported yet."""
from .base_module import BaseModule
from .bucketing_module import BucketingModule
from .module import Module
