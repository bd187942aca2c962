"""Executor-manager helpers.

Counterpart of ``mxnet_tpu/executor_manager.py`` (reference:
python/mxnet/executor_manager.py — the legacy FeedForward-era device
management; Module's DataParallelExecutorGroup superseded it, but
``_split_input_slice`` is the workload-weighted batch splitter both use,
reference executor_manager.py:31)."""
from .module.executor_group import (DataParallelExecutorGroup,  # noqa: F401
                                    _split_input_slice)

__all__ = ["DataParallelExecutorGroup", "DataParallelExecutorManager",
           "_split_input_slice"]


class DataParallelExecutorManager:
    """Legacy FeedForward-era manager (reference:
    executor_manager.py:195). Deprecated there in favor of Module; kept
    as a thin shim that delegates to Module for old scripts that
    construct it directly."""

    def __init__(self, symbol, ctx, train_data, arg_names=None,
                 param_names=None, aux_names=None, work_load_list=None,
                 logger=None, sym_gen=None):
        from .module import Module

        if sym_gen is not None:
            raise NotImplementedError(
                "sym_gen: use BucketingModule (the reference deprecated "
                "this manager for the same reason, executor_manager.py)")
        self._module = Module(
            symbol, data_names=[d[0] for d in train_data.provide_data],
            label_names=[l[0] for l in train_data.provide_label],
            context=ctx)
        self._module.bind(data_shapes=train_data.provide_data,
                          label_shapes=train_data.provide_label)

    def install_monitor(self, monitor):
        self._module.install_monitor(monitor)

    def set_params(self, arg_params, aux_params):
        self._module.set_params(arg_params, aux_params)

    def load_data_batch(self, data_batch):
        self._batch = data_batch

    def forward(self, is_train=False):
        self._module.forward(self._batch, is_train=is_train)

    def backward(self):
        self._module.backward()

    def update_metric(self, metric, labels):
        self._module.update_metric(metric, labels)

    @property
    def param_arrays(self):
        return self._module._exec_group.param_arrays

    @property
    def grad_arrays(self):
        return self._module._exec_group.grad_arrays
