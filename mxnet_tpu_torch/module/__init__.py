"""Module API (counterpart of ``mxnet_tpu/module/``): ``BaseModule``,
``Module`` on one device, ``BucketingModule``, ``SequentialModule``,
``PythonModule`` / ``PythonLossModule`` and the executor group."""
from .base_module import BaseModule
from .bucketing_module import BucketingModule
from .executor_group import DataParallelExecutorGroup
from .module import Module
from .python_module import PythonLossModule, PythonModule
from .sequential_module import SequentialModule

__all__ = ["BaseModule", "BucketingModule", "DataParallelExecutorGroup",
           "Module", "PythonLossModule", "PythonModule",
           "SequentialModule"]
