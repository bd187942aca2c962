"""Custom operators: the user's escape hatch for ops written in Python.

Counterpart of ``mxnet_tpu/operator.py`` (reference: python/mxnet/operator.py
``CustomOp`` :418, ``CustomOpProp`` :464, ``register`` :598, backed by
src/operator/custom/custom.cc). The JAX package runs the Python body as a
host callback inside its compiled program; PyTorch runs eagerly, so here
the ``Custom`` op is a ``torch.autograd.Function``: its forward wraps the
input tensors as ``NDArray``s on their own device (no copy) and calls
``CustomOp.forward``; its backward calls ``CustomOp.backward`` with the
head gradients, the saved inputs and the outputs. A body that launches
``mx.rtc`` kernels therefore runs on the card with no host round trip;
one that calls ``asnumpy`` copies to the host as it asks.

``create_operator`` gets the inputs' device (a ``torch.device``, the
port's context) and is called once per forward; the backward of that
forward uses the same operator.
"""
from __future__ import annotations

import json

import torch

from .base import MXNetError, torch_dtype

__all__ = ["CustomOp", "CustomOpProp", "register", "get_custom_op_prop",
           "PythonOp", "NumpyOp", "NDArrayOp"]

_CUSTOM_REGISTRY = {}


class CustomOp:
    """Base class for custom imperative kernels (reference: operator.py:418)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError()

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError()

    def assign(self, dst, req, src):
        """Write ``src`` into ``dst`` honoring the request type
        (reference: operator.py CustomOp.assign). The outputs and input
        gradients the op is handed are fresh arrays, so writing into them
        in place is safe under autograd."""
        if req == "null":
            return
        if req in ("write", "inplace"):
            dst[:] = src
        elif req == "add":
            dst[:] = dst + src
        else:
            raise MXNetError("unknown req %r" % req)


class CustomOpProp:
    """Operator properties: names/shapes/types (reference: operator.py:464)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]] * len(self.list_outputs()), []

    def infer_type(self, in_type):
        return (in_type, [in_type[0]] * len(self.list_outputs()),
                [in_type[0]] * len(self.list_auxiliary_states()))

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def need_top_grad(self):
        return self.need_top_grad_

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps

    def create_operator(self, ctx, in_shapes, in_dtypes):
        return CustomOp()


def register(reg_name):
    """Register a CustomOpProp subclass under ``op_type`` (reference:
    operator.py:598 register)."""

    def do_register(prop_cls):
        if not issubclass(prop_cls, CustomOpProp):
            raise MXNetError("register expects a CustomOpProp subclass")
        _CUSTOM_REGISTRY[reg_name] = prop_cls
        return prop_cls

    return do_register


def get_custom_op_prop(op_type, config_json="{}"):
    """Instantiate the registered prop with its keyword config."""
    if op_type not in _CUSTOM_REGISTRY:
        raise MXNetError(
            "Custom op_type %r not registered (known: %s)"
            % (op_type, sorted(_CUSTOM_REGISTRY)))
    kwargs = json.loads(config_json) if config_json else {}
    return _CUSTOM_REGISTRY[op_type](**kwargs)


# --- the registered Custom op (used by nd.Custom / sym.Custom) --------------

class _CustomFunction(torch.autograd.Function):
    """One ``Custom`` call: ``CustomOp.forward`` and ``.backward`` on
    ``NDArray`` views of the tensors, each run with autograd paused. The
    outputs are handed over uninitialised with req "write", as MXNet does:
    the op writes the whole of each."""

    @staticmethod
    def forward(ctx, prop, is_train, *inputs):
        from . import autograd
        from .ndarray.ndarray import _dtype_of, _wrap

        in_shapes = [tuple(x.shape) for x in inputs]
        in_dtypes = [_dtype_of(x) for x in inputs]
        _, out_shapes, _ = prop.infer_shape([list(s) for s in in_shapes])
        _, out_dtypes, _ = prop.infer_type(in_dtypes)
        dev = inputs[0].device
        op = prop.create_operator(dev, in_shapes, in_dtypes)
        in_nd = [_wrap(x.detach()) for x in inputs]
        out_nd = [_wrap(torch.empty(tuple(s), dtype=torch_dtype(d),
                                    device=dev))
                  for s, d in zip(out_shapes, out_dtypes)]
        with autograd.pause(train_mode=is_train):
            op.forward(is_train, ["write"] * len(out_nd), in_nd, out_nd, [])
        outs = tuple(o._data for o in out_nd)
        ctx.op = op
        ctx.n_in = len(inputs)
        ctx.save_for_backward(*inputs, *outs)
        return outs

    @staticmethod
    def backward(ctx, *out_grads):
        from . import autograd
        from .ndarray.ndarray import _wrap

        saved = ctx.saved_tensors
        xs, ys = saved[:ctx.n_in], saved[ctx.n_in:]
        in_grad = [_wrap(torch.zeros_like(x)) for x in xs]
        with autograd.pause():
            ctx.op.backward(["write"] * len(in_grad),
                            [_wrap(g) for g in out_grads],
                            [_wrap(x.detach()) for x in xs],
                            [_wrap(y.detach()) for y in ys],
                            in_grad, [])
        grads = [g._data if need else None
                 for g, need in zip(in_grad, ctx.needs_input_grad[2:])]
        return (None, None) + tuple(grads)


def _register_custom_opdef():
    from .ops.param import Str
    from .ops.registry import register_op

    def _n_inputs(attrs):
        prop = get_custom_op_prop(attrs.op_type, attrs.config)
        return len(prop.list_arguments())

    def _n_outputs(attrs):
        prop = get_custom_op_prop(attrs.op_type, attrs.config)
        return len(prop.list_outputs())

    def _input_names(attrs):
        prop = get_custom_op_prop(attrs.op_type, attrs.config)
        return prop.list_arguments()

    def custom_fn(attrs, *inputs, is_train=False):
        prop = get_custom_op_prop(attrs.op_type, attrs.config)
        return _CustomFunction.apply(prop, bool(is_train), *inputs)

    def custom_infer_shape(attrs, in_shapes, aux_shapes):
        if any(s is None for s in in_shapes):
            return None
        prop = get_custom_op_prop(attrs.op_type, attrs.config)
        ins, outs, auxs = prop.infer_shape([list(s) for s in in_shapes])
        return ([tuple(s) for s in ins], [tuple(s) for s in outs],
                [tuple(s) for s in auxs])

    register_op(
        "Custom", custom_fn,
        params={"op_type": Str(), "config": Str(default="{}")},
        num_inputs=_n_inputs, input_names=_input_names,
        num_outputs=_n_outputs,
        infer_shape=custom_infer_shape,
        needs_is_train=True,
        doc="Python custom op as a torch.autograd.Function (reference: "
            "src/operator/custom/custom.cc; python/mxnet/operator.py:418)")


_register_custom_opdef()


def custom_call_kwargs(kwargs):
    """Split user kwargs into the Custom op's (op_type, config) attrs —
    the frontend packs arbitrary ctor kwargs as JSON (the reference passes
    them as string key/values through the C API)."""
    from .ndarray.ndarray import NDArray

    op_type = kwargs.pop("op_type")
    tensor_kwargs = {}
    config = {}
    for k, v in list(kwargs.items()):
        if isinstance(v, NDArray) or k in ("out", "name"):
            tensor_kwargs[k] = v
        else:
            config[k] = v
    return dict(op_type=op_type, config=json.dumps(config), **tensor_kwargs)


def _install_frontends():
    """Wrap the generated nd.Custom / sym.Custom so arbitrary prop-ctor
    kwargs are packed into the JSON ``config`` attr (the reference forwards
    them as C-API string key/values, operator.py:598)."""
    from . import ndarray as nd_pkg
    from . import symbol as sym_pkg

    raw_nd = nd_pkg.Custom
    raw_sym = sym_pkg.Custom

    def nd_custom(*args, **kwargs):
        return raw_nd(*args, **custom_call_kwargs(kwargs))

    def sym_custom(*args, **kwargs):
        op_type = kwargs.pop("op_type")
        passthrough = {}
        config = {}
        for k, v in list(kwargs.items()):
            if k in ("name", "attr") or hasattr(v, "list_arguments"):
                passthrough[k] = v
            else:
                config[k] = v
        return raw_sym(*args, op_type=op_type, config=json.dumps(config),
                       **passthrough)

    nd_custom.__doc__ = raw_nd.__doc__
    sym_custom.__doc__ = raw_sym.__doc__
    nd_pkg.Custom = nd_custom
    nd_pkg.op.Custom = nd_custom
    sym_pkg.Custom = sym_custom
    sym_pkg.op.Custom = sym_custom


# --- legacy PythonOp family (reference: operator.py:37-336) -----------------
# The pre-CustomOp API: an op object with forward/backward plus shape and
# name introspection, turned into a symbol by get_symbol(). An adapter
# onto the CustomOp machinery above.

class PythonOp:
    """Base of the deprecated python-op API (reference operator.py:37).
    Subclass NumpyOp or NDArrayOp instead of this directly."""

    def __init__(self, need_top_grad=True):
        self.info_ = None
        self.need_top_grad_ = need_top_grad

    def __call__(self, *args, **kwargs):
        return self.get_symbol(*args, **kwargs)

    def get_symbol(self, *args, **kwargs):
        raise NotImplementedError("Must override this")

    def forward(self, in_data, out_data):
        raise NotImplementedError("Must override this")

    def backward(self, out_grad, in_data, out_data, in_grad):
        raise NotImplementedError("Must override this")

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]]

    def list_outputs(self):
        return ["output"]

    def list_arguments(self):
        return ["data"]

    def need_top_grad(self):
        return self.need_top_grad_


def _legacy_prop(op, numpy_arrays):
    """Build a CustomOpProp bridging a PythonOp instance."""

    class _LegacyOp(CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            if numpy_arrays:
                ins = [d.asnumpy() for d in in_data]
                outs = [d.asnumpy() for d in out_data]
                op.forward(in_data=ins, out_data=outs)
                for dst, src, r in zip(out_data, outs, req):
                    self.assign(dst, r, _nd_array(src, dst))
            else:
                op.forward(in_data=in_data, out_data=out_data)

        def backward(self, req, out_grad, in_data, out_data, in_grad,
                     aux):
            if numpy_arrays:
                ogs = [d.asnumpy() for d in out_grad]
                ins = [d.asnumpy() for d in in_data]
                outs = [d.asnumpy() for d in out_data]
                igs = [d.asnumpy() for d in in_grad]
                op.backward(out_grad=ogs, in_data=ins, out_data=outs,
                            in_grad=igs)
                for dst, src, r in zip(in_grad, igs, req):
                    self.assign(dst, r, _nd_array(src, dst))
            else:
                op.backward(out_grad=out_grad, in_data=in_data,
                            out_data=out_data, in_grad=in_grad)

    class _LegacyProp(CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=op.need_top_grad())

        def list_arguments(self):
            return op.list_arguments()

        def list_outputs(self):
            return op.list_outputs()

        def infer_shape(self, in_shape):
            res = op.infer_shape(in_shape)
            return res[0], res[1], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            return _LegacyOp()

    return _LegacyProp


def _nd_array(a, like):
    """A numpy result as an NDArray on ``like``'s device."""
    from . import ndarray as nd

    return nd.array(a, ctx=like.context)


class NumpyOp(PythonOp):
    """Legacy custom op with numpy-array forward/backward (reference
    operator.py:144). Deprecated; prefer CustomOp/CustomOpProp."""

    _counter = [0]

    def get_symbol(self, *args, **kwargs):
        from . import symbol as sym

        self._counter[0] += 1
        reg_name = "_legacy_numpy_op_%d" % self._counter[0]
        register(reg_name)(_legacy_prop(self, numpy_arrays=True))
        return sym.Custom(*args, op_type=reg_name, **kwargs)


class NDArrayOp(PythonOp):
    """Legacy custom op operating on NDArrays in place (reference
    operator.py:246). Deprecated; prefer CustomOp/CustomOpProp."""

    _counter = [0]

    def get_symbol(self, *args, **kwargs):
        from . import symbol as sym

        self._counter[0] += 1
        reg_name = "_legacy_ndarray_op_%d" % self._counter[0]
        register(reg_name)(_legacy_prop(self, numpy_arrays=False))
        return sym.Custom(*args, op_type=reg_name, **kwargs)
