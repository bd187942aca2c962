"""The executor behind ``Module``: one bound Executor on one device.

Counterpart of ``mxnet_tpu/module/executor_group.py`` for one device. The
reference splits each batch over the executors of several devices and
gathers their outputs; that waits for multi-device training
(``ROADMAP.md`` Queue A10), and ``Module`` raises for more than one
context. The name-major array lists keep the reference's per-device form
(``param_arrays[i]`` is the list of parameter ``i``'s arrays, here one),
so ``model.py``'s update helpers are the reference's.
``_split_input_slice`` is the reference's workload-weighted batch
splitter, kept for ``executor_manager``.
"""
from __future__ import annotations

import logging

from ..io import DataDesc


def _split_input_slice(batch_size, work_load_list):
    """Proportional batch split: each device's share is its workload
    fraction (rounded); the final device absorbs rounding error. Raises if
    any share rounds to zero."""
    total = sum(work_load_list)
    shares = [round(batch_size * w / total) for w in work_load_list]
    shares[-1] += batch_size - sum(shares)
    cuts = []
    cursor = 0
    for share in shares:
        lo = min(cursor, batch_size)
        hi = min(lo + share, batch_size)
        if hi <= lo:
            raise ValueError("Too many slices. Some splits are empty.")
        cuts.append(slice(int(lo), int(hi)))
        cursor = hi
    return cuts


def _normalize_grad_req(grad_req, arg_names, param_names, data_names,
                        fixed_param_names, inputs_need_grad):
    """Expand user grad_req into a per-argument dict."""

    def default_for(name, req):
        if name in param_names:
            return "null" if name in fixed_param_names else req
        if name in data_names:
            return req if inputs_need_grad else "null"
        return "null"

    if isinstance(grad_req, str):
        return {a: default_for(a, grad_req) for a in arg_names}
    if isinstance(grad_req, (list, tuple)):
        if len(grad_req) != len(arg_names):
            raise ValueError("grad_req list must cover every argument")
        return dict(zip(arg_names, grad_req))
    if isinstance(grad_req, dict):
        table = {a: default_for(a, "write") for a in arg_names}
        table.update(grad_req)
        return table
    raise ValueError("grad_req must be one of str, list, tuple, or dict.")


def _batch_size(descs):
    """The common size of the inputs' batch axes (from their layouts)."""
    size = None
    for d in descs:
        axis = DataDesc.get_batch_axis(getattr(d, "layout", "NCHW"))
        if axis == -1:
            continue
        if size is None:
            size = d.shape[axis]
        elif d.shape[axis] != size:
            raise AssertionError(
                "all data must have the same batch size: batch_size = %d, "
                "but %s has shape %s" % (size, d.name, d.shape))
    return size


class DataParallelExecutorGroup:
    """The bound executor behind Module, on ``contexts[0]``."""

    def __init__(self, symbol, contexts, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad,
                 shared_group=None, logger=logging, fixed_param_names=None, grad_req="write",
                 state_names=None):
        if len(contexts) != 1:
            raise ValueError("one device per executor group")
        self.symbol = symbol
        self.contexts = contexts
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.logger = logger

        self.param_names = param_names
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.fixed_param_names = fixed_param_names or []
        self.state_names = state_names or []

        self.grad_req = _normalize_grad_req(
            grad_req if for_training else "null",
            self.arg_names, self.param_names,
            [d[0] for d in data_shapes],
            self.fixed_param_names, inputs_need_grad)

        self.execs = []
        self._out_sel = None
        self.data_shapes = self.label_shapes = None
        self.bind_exec(data_shapes, label_shapes, shared_group)

    # ---------------------------------------------------------------- bind
    def bind_exec(self, data_shapes, label_shapes, shared_group=None):
        """(Re)create the executor for the given shapes."""
        self.batch_size = _batch_size(list(data_shapes)
                                      + list(label_shapes or []))
        shapes = {d.name: d.shape for d in data_shapes}
        shapes.update({d.name: d.shape for d in label_shapes or []})
        # bind-time pass pipeline inputs (graph_pass): an inference bind
        # freezes every parameter (predict/score serve fixed weights
        # between set_params calls; the executor re-folds on update); a
        # training bind freezes only the explicitly fixed ones
        frozen = [n for n in (self.fixed_param_names if self.for_training
                              else self.param_names)
                  if n in self.arg_names]
        ex = self.symbol.simple_bind(
            ctx=self.contexts[0], grad_req=self.grad_req,
            shared_exec=(None if shared_group is None
                         else shared_group.execs[0]),
            frozen_params=frozen, **shapes)
        if self._out_sel is not None:  # selection survives a re-bind
            ex.select_outputs(self._out_sel)
        self.execs = [ex]
        self.data_shapes = data_shapes
        self.label_shapes = label_shapes
        self.data_names = [d.name for d in data_shapes]
        self.label_names = [d.name for d in label_shapes or []]
        self._index_arrays()

    def reshape(self, data_shapes, label_shapes):
        if (data_shapes, label_shapes) == (self.data_shapes,
                                           self.label_shapes):
            return
        # the new executor shares the outgoing one's bind-time pass result
        self.bind_exec(data_shapes, label_shapes, shared_group=self)

    def _index_arrays(self):
        """The name-major lists over the executor's arrays."""
        ex = self.execs[0]

        def arrays(dict_name, names):
            return [[getattr(ex, dict_name).get(name)] for name in names]

        self.data_arrays = arrays("arg_dict", self.data_names)
        self.label_arrays = arrays("arg_dict", self.label_names)
        bound_params = [n for n in self.param_names if n in self.arg_names]
        self.param_arrays = arrays("arg_dict", bound_params)
        self.grad_arrays = (arrays("grad_dict", bound_params)
                            if self.for_training else None)
        self.input_grad_arrays = (arrays("grad_dict", self.data_names)
                                  if self.inputs_need_grad else None)
        self.aux_arrays = arrays("aux_dict", self.aux_names)

    # -------------------------------------------------------------- params
    def set_params(self, arg_params, aux_params, allow_extra=False):
        self.execs[0].copy_params_from(arg_params, aux_params,
                                       allow_extra_params=allow_extra)

    def get_params(self, arg_params, aux_params):
        """Copy the device parameters into the host dicts."""
        for name, arrs in list(zip(self.param_names, self.param_arrays)) \
                + list(zip(self.aux_names, self.aux_arrays)):
            arrs[0].copyto(arg_params[name] if name in arg_params
                           else aux_params[name])

    # ------------------------------------------------------------- compute
    def forward(self, data_batch, is_train=None):
        for src, dst in zip(data_batch.data, self.data_arrays):
            src.copyto(dst[0])
        if data_batch.label:
            for src, dst in zip(data_batch.label, self.label_arrays):
                src.copyto(dst[0])
        self.execs[0].forward(is_train=self.for_training if is_train is None
                              else is_train)

    def backward(self, out_grads=None):
        if not self.for_training:
            raise AssertionError(
                "re-bind with for_training=True to run backward")
        if out_grads is not None:
            out_grads = [g.as_in_context(self.contexts[0]) for g in out_grads]
        self.execs[0].backward(out_grads=out_grads)

    def get_output_shapes(self):
        """(name, shape) of each output: from the last forward, or (before
        the first) from shape inference."""
        outs = self.execs[0].outputs
        if outs:
            shapes = [o.shape for o in outs]
        else:
            feed = {d.name: d.shape for d in self.data_shapes}
            feed.update({d.name: d.shape for d in self.label_shapes or []})
            shapes = self.symbol.infer_shape(**feed)[1]
        return list(zip(self.symbol.list_outputs(), map(tuple, shapes)))

    def set_output_selection(self, sel):
        """Restrict inference forwards to the output indices in ``sel``
        (None restores all), so the executor's walk computes only the
        requested heads."""
        self._out_sel = list(sel) if sel is not None else None
        self.execs[0].select_outputs(self._out_sel)

    def get_outputs(self, merge_multi_context=True):
        outs = self.execs[0].outputs
        return list(outs) if merge_multi_context else [[o] for o in outs]

    def get_input_grads(self, merge_multi_context=True):
        assert self.inputs_need_grad
        if not merge_multi_context:
            return self.input_grad_arrays
        return [g[0] for g in self.input_grad_arrays]

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self.execs[0].outputs)
