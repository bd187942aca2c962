"""Testing utilities (counterpart of ``mxnet_tpu/test_utils.py``; reference:
python/mxnet/test_utils.py).

The numeric-test harness: per-dtype tolerances, ``assert_almost_equal``,
finite-difference ``check_numeric_gradient``, ``check_symbolic_forward`` /
``check_symbolic_backward`` against numpy results, ``check_consistency``
(one symbol bound on several contexts, ``mx.cpu()`` beside ``mx.gpu(0)``
where there is a card) and ``check_speed``; the random data and sparse
array generators draw the same numpy numbers in the same order as the JAX
package's, from a module generator seeded 1234 (``_rng``) and numpy's
global one. Arrays go where the port's arrays go: the innermost ``with``
scope, else the card (:func:`default_context`). ``download`` and
``get_bz2_data`` only find files already on disk: nothing is fetched.
"""
from __future__ import annotations

import contextlib
import functools
import numbers
import os
import time

import numpy as np
import torch

from .base import MXNetError
from .context import Context, as_device
from . import ndarray as nd
from . import symbol as sym
from .ndarray import NDArray

_rng = np.random.RandomState(1234)

default_dtype = np.float32


def default_context():
    """The innermost ``with`` scope's context, else the card's."""
    return Context.from_device(as_device(None))


def set_default_context(ctx):
    from . import context as ctx_mod

    ctx_mod._thread_state.ctx_stack = [ctx]


def default_rtols():
    return {np.dtype(np.float16): 1e-2,
            np.dtype(np.float32): 1e-4,
            np.dtype(np.float64): 1e-5,
            np.dtype(np.bool_): 0,
            np.dtype(np.int32): 0,
            np.dtype(np.int64): 0,
            np.dtype(np.uint8): 0}


def default_atols():
    return {np.dtype(np.float16): 1e-1,
            np.dtype(np.float32): 1e-3,
            np.dtype(np.float64): 1e-20,
            np.dtype(np.bool_): 0,
            np.dtype(np.int32): 0,
            np.dtype(np.int64): 0,
            np.dtype(np.uint8): 0}


def get_tolerance(arr, rtol, tols):
    if rtol is not None:
        return rtol
    return tols.get(np.dtype(arr.dtype), 1e-4)


def get_rtol(rtol=None):
    return 1e-5 if rtol is None else rtol


def get_atol(atol=None):
    return 1e-20 if atol is None else atol


def random_arrays(*shapes):
    """Random float64 arrays, one per shape."""
    arrays = [np.array(_rng.randn(), dtype=np.float64) if len(s) == 0
              else _rng.randn(*s).astype(np.float64) for s in shapes]
    return arrays[0] if len(arrays) == 1 else arrays


def random_sample(population, k):
    """``k`` items of ``population`` without replacement."""
    population_copy = population[:]
    np.random.shuffle(population_copy)
    return population_copy[0:k]


def rand_shape_2d(dim0=10, dim1=10):
    return _rng.randint(1, dim0 + 1), _rng.randint(1, dim1 + 1)


def rand_shape_3d(dim0=10, dim1=10, dim2=10):
    return (_rng.randint(1, dim0 + 1), _rng.randint(1, dim1 + 1),
            _rng.randint(1, dim2 + 1))


def rand_shape_nd(num_dim, dim=10):
    return tuple(_rng.randint(1, dim + 1, size=num_dim))


def rand_ndarray(shape, stype="default", density=None, dtype=None):
    """A dense uniform(-1, 1) array whatever ``stype`` (the JAX
    package's draw; its sparse stypes map to dense too)."""
    return nd.array(_rng.uniform(-1, 1, shape), ctx=default_context(),
                    dtype=dtype or default_dtype)


def rand_sparse_ndarray(shape, stype, density=None, dtype=None,
                        distribution="uniform"):
    """(a random sparse array, its dense numpy values)."""
    from .ndarray import sparse as sp

    if distribution not in (None, "uniform"):
        raise ValueError("distribution %r not supported (only uniform)"
                         % (distribution,))
    density = np.random.rand() if density is None else density
    dtype = default_dtype if dtype is None else dtype
    dense = np.random.rand(*shape).astype(dtype)
    mask = np.random.rand(*shape) < density
    dense = dense * mask
    if stype not in ("row_sparse", "csr"):
        raise ValueError("unknown storage type %r" % (stype,))
    return sp.array(dense, stype=stype, ctx=default_context()), dense


def create_sparse_array(shape, stype, data_init=None, rsp_indices=None,
                        dtype=None, modifier_func=None, density=0.5,
                        shuffle_csr_indices=False):
    """A sparse array filled with ``data_init``, else random values at
    ``density``; a row_sparse one keeps only ``rsp_indices``' rows."""
    from .ndarray import sparse as sp

    dense = np.zeros(shape, dtype=dtype or default_dtype)
    if data_init is not None:
        dense[:] = data_init
    else:
        dense[:] = (np.random.rand(*shape) < density) * \
            np.random.rand(*shape)
    if rsp_indices is not None and stype == "row_sparse":
        mask = np.zeros(shape[0], bool)
        mask[np.asarray(rsp_indices, int)] = True
        dense[~mask] = 0
    if modifier_func is not None:
        dense = np.vectorize(modifier_func)(dense).astype(dense.dtype)
    return sp.array(dense, stype=stype, ctx=default_context())


def create_sparse_array_zd(shape, stype, density, data_init=None,
                           rsp_indices=None, dtype=None,
                           modifier_func=None,
                           shuffle_csr_indices=False):
    """:func:`create_sparse_array` where ``density`` may be zero."""
    return create_sparse_array(shape, stype, data_init=data_init,
                               rsp_indices=rsp_indices, dtype=dtype,
                               modifier_func=modifier_func,
                               density=density)


def shuffle_csr_column_indices(csr):
    """The identity: csr columns stay in canonical (sorted) order, as in
    the JAX package."""
    return csr


def np_reduce(dat, axis, keepdims, numpy_reduce_func):
    if isinstance(axis, int):
        axis = [axis]
    else:
        axis = list(axis) if axis is not None else range(len(dat.shape))
    ret = dat
    for i in reversed(sorted(axis)):
        ret = numpy_reduce_func(ret, axis=i)
    if keepdims:
        keepdims_shape = list(dat.shape)
        for i in axis:
            keepdims_shape[i] = 1
        ret = ret.reshape(tuple(keepdims_shape))
    return ret


def find_max_violation(a, b, rtol=None, atol=None):
    rtol = rtol or 1e-5
    atol = atol or 1e-20
    diff = np.abs(a - b)
    tol = atol + rtol * np.abs(b)
    violation = diff / (tol + 1e-20)
    loc = np.argmax(violation)
    idx = np.unravel_index(loc, violation.shape)
    return idx, np.max(violation)


def same(a, b):
    return np.array_equal(a, b)


def assert_almost_equal(a, b, rtol=None, atol=None, names=("a", "b"),
                        equal_nan=False):
    if isinstance(a, NDArray):
        a = a.asnumpy()
    if isinstance(b, NDArray):
        b = b.asnumpy()
    a = np.asarray(a)
    b = np.asarray(b)
    rtol = get_tolerance(a, rtol, default_rtols())
    atol = get_tolerance(a, atol, default_atols())
    if np.allclose(a, b, rtol=rtol, atol=atol, equal_nan=equal_nan):
        return
    index, rel = find_max_violation(a, b, rtol, atol)
    raise AssertionError(
        "Error %f exceeds tolerance rtol=%f, atol=%f.  Location of maximum "
        "error:%s, %s=%f, %s=%f"
        % (rel, rtol, atol, str(index), names[0], a[index], names[1],
           b[index]))


def almost_equal(a, b, rtol=None, atol=None, equal_nan=False):
    try:
        assert_almost_equal(a, b, rtol, atol, equal_nan=equal_nan)
        return True
    except AssertionError:
        return False


def _nan_zeroed(a, b):
    a, b = np.copy(np.asarray(a)), np.copy(np.asarray(b))
    nan_mask = np.logical_or(np.isnan(a), np.isnan(b))
    a[nan_mask] = 0
    b[nan_mask] = 0
    return a, b


def almost_equal_ignore_nan(a, b, rtol=None, atol=None):
    """Closeness where neither side is NaN."""
    return almost_equal(*_nan_zeroed(a, b), rtol, atol)


def assert_almost_equal_ignore_nan(a, b, rtol=None, atol=None,
                                   names=("a", "b")):
    assert_almost_equal(*_nan_zeroed(a, b), rtol, atol, names)


def assert_exception(f, exception_type, *args, **kwargs):
    try:
        f(*args, **kwargs)
        assert False
    except exception_type:
        return


def same_array(array1, array2):
    """Whether two NDArrays share one buffer: a write through one shows
    in the other (the reference's probe, undone after)."""
    if array1.shape != array2.shape:
        return False
    a, b = array1._data.detach(), array2._data.detach()
    with torch.no_grad():
        a += 1
        shared = torch.equal(a, b)
        a -= 1
    return shared


def assign_each(the_input, function):
    return np.vectorize(function)(np.asarray(the_input)) \
        if function is not None else np.asarray(the_input)


def assign_each2(input1, input2, function):
    return np.vectorize(function)(np.asarray(input1), np.asarray(input2)) \
        if function is not None else np.asarray(input1)


# --- symbolic checks ---------------------------------------------------------

def simple_forward(sym_inst, ctx=None, is_train=False, **inputs):
    ctx = ctx or default_context()
    inputs = {k: nd.array(v, ctx=ctx) for k, v in inputs.items()}
    exe = sym_inst.bind(ctx, args=inputs)
    exe.forward(is_train=is_train)
    outputs = [x.asnumpy() for x in exe.outputs]
    return outputs[0] if len(outputs) == 1 else outputs


def _parse_location(sym_inst, location, ctx, dtype=default_dtype):
    assert isinstance(location, (dict, list, tuple))
    if isinstance(location, dict):
        if set(location.keys()) != set(sym_inst.list_arguments()):
            raise ValueError(
                "Symbol arguments and keys of the given location do not "
                "match.symbol args:%s, location.keys():%s"
                % (str(set(sym_inst.list_arguments())),
                   str(set(location.keys()))))
    else:
        location = dict(zip(sym_inst.list_arguments(), location))
    return {k: v.as_in_context(ctx) if isinstance(v, NDArray)
            else nd.array(np.asarray(v), ctx=ctx, dtype=dtype)
            for k, v in location.items()}


def _parse_aux_states(sym_inst, aux_states, ctx, dtype=default_dtype):
    if aux_states is None:
        return None
    if isinstance(aux_states, dict):
        if set(aux_states.keys()) != set(sym_inst.list_auxiliary_states()):
            raise ValueError("Symbol aux_states names and given aux_states "
                             "do not match.")
    elif isinstance(aux_states, (list, tuple)):
        aux_states = dict(zip(sym_inst.list_auxiliary_states(), aux_states))
    return {k: nd.array(np.asarray(v), ctx=ctx, dtype=dtype)
            for k, v in aux_states.items()}


def _set_arg(executor, name, value, dtype):
    arr = executor.arg_dict[name]
    arr._set_data(nd.array(value, ctx=arr.context, dtype=dtype)._data)


def numeric_grad(executor, location, aux_states=None, eps=1e-4,
                 use_forward_train=True, dtype=default_dtype):
    """Central finite differences of the outputs' sum."""
    approx_grads = {k: np.zeros(v.shape, dtype=dtype)
                    for k, v in location.items()}
    for k, v in location.items():
        _set_arg(executor, k, v, dtype)
    location = {k: np.array(v, order="C") for k, v in location.items()}
    for k, v in location.items():
        if v.dtype.kind != "f":
            continue
        old_value = v.copy()
        for i in range(int(np.prod(v.shape)) if v.shape else 1):
            v.ravel()[i] = old_value.ravel()[i] + eps / 2.0
            _set_arg(executor, k, v, dtype)
            executor.forward(is_train=use_forward_train)
            f_peps = sum(np.sum(out.asnumpy()) for out in executor.outputs)
            v.ravel()[i] = old_value.ravel()[i] - eps / 2.0
            _set_arg(executor, k, v, dtype)
            executor.forward(is_train=use_forward_train)
            f_neps = sum(np.sum(out.asnumpy()) for out in executor.outputs)
            approx_grads[k].ravel()[i] = (f_peps - f_neps) / eps
            v.ravel()[i] = old_value.ravel()[i]
        _set_arg(executor, k, old_value, dtype)
    return approx_grads


def _grad_nodes_req(sym_inst, grad_nodes):
    if grad_nodes is None:
        grad_nodes = sym_inst.list_arguments()
        return grad_nodes, {k: "write" for k in grad_nodes}
    if isinstance(grad_nodes, (list, tuple)):
        grad_nodes = list(grad_nodes)
        return grad_nodes, {k: "write" for k in grad_nodes}
    if isinstance(grad_nodes, dict):
        return list(grad_nodes.keys()), grad_nodes.copy()
    raise ValueError


def _check_grad(req, name, want, got, written, rtol, atol, names,
                equal_nan=False):
    """``got`` against ``want`` under ``req``: "add" adds onto the
    buffer's first contents ``written``, "null" leaves them."""
    if req == "write":
        assert_almost_equal(want, got, rtol, atol, names,
                            equal_nan=equal_nan)
    elif req == "add":
        assert_almost_equal(want + written, got, rtol, atol, names,
                            equal_nan=equal_nan)
    elif req == "null":
        assert_almost_equal(written, got, rtol, atol, names,
                            equal_nan=equal_nan)
    else:
        raise ValueError("unknown grad_req %r for %s" % (req, name))


def check_numeric_gradient(sym_inst, location, aux_states=None,
                           numeric_eps=1e-3, rtol=1e-2, atol=None,
                           grad_nodes=None, use_forward_train=True, ctx=None,
                           grad_stype_dict=None, dtype=default_dtype):
    """Finite differences against the symbolic backward, through a random
    projection of the outputs."""
    assert dtype in (np.float16, np.float32, np.float64)
    if ctx is None:
        ctx = default_context()
    location = _parse_location(sym_inst, location, ctx, dtype=dtype)
    location_npy = {k: v.asnumpy() for k, v in location.items()}
    aux_states = _parse_aux_states(sym_inst, aux_states, ctx, dtype=dtype)
    aux_npy = None if aux_states is None else \
        {k: v.asnumpy() for k, v in aux_states.items()}
    grad_nodes, grad_req = _grad_nodes_req(sym_inst, grad_nodes)

    input_shape = {k: v.shape for k, v in location.items()}
    _, out_shape, _ = sym_inst.infer_shape(**input_shape)
    proj = sym.Variable("__random_proj")
    out = sym.MakeLoss(sym.sum(sym_inst * proj))
    location = dict(location, __random_proj=nd.array(
        _rng.rand(*out_shape[0]) + 0.1, ctx=ctx, dtype=dtype))
    args_grad_npy = {k: _rng.normal(0, 0.01, size=location[k].shape)
                     for k in grad_nodes}
    args_grad = {k: nd.array(v, ctx=ctx, dtype=dtype)
                 for k, v in args_grad_npy.items()}
    grad_req_all = {k: "null" for k in out.list_arguments()}
    grad_req_all.update(grad_req)
    grad_req_all["__random_proj"] = "null"
    executor = out.bind(ctx, args=location, args_grad=args_grad,
                        grad_req=grad_req_all, aux_states=aux_states)
    executor.forward(is_train=True)
    executor.backward()
    symbolic_grads = {k: executor.grad_dict[k].asnumpy() for k in grad_nodes}
    numeric_gradients = numeric_grad(
        executor, location_npy, aux_npy, eps=numeric_eps,
        use_forward_train=use_forward_train, dtype=dtype)
    for name in grad_nodes:
        _check_grad(grad_req[name], name, numeric_gradients[name],
                    symbolic_grads[name], args_grad_npy[name], rtol, atol,
                    ("NUMERICAL_%s" % name, "BACKWARD_%s" % name))


def check_symbolic_forward(sym_inst, location, expected, rtol=1E-4,
                           atol=None, aux_states=None, ctx=None,
                           dtype=default_dtype, equal_nan=False):
    """The forward outputs against ``expected`` numpy arrays."""
    assert dtype in (np.float16, np.float32, np.float64)
    if ctx is None:
        ctx = default_context()
    location = _parse_location(sym_inst, location, ctx, dtype=dtype)
    aux_states = _parse_aux_states(sym_inst, aux_states, ctx, dtype=dtype)
    if isinstance(expected, dict):
        expected = [expected[k] for k in sym_inst.list_outputs()]
    executor = sym_inst.bind(ctx, args=location, args_grad=None,
                             grad_req="null", aux_states=aux_states)
    executor.forward(is_train=False)
    outputs = [x.asnumpy() for x in executor.outputs]
    for output_name, expect, output in zip(sym_inst.list_outputs(), expected,
                                           outputs):
        assert_almost_equal(expect, output, rtol, atol,
                            ("EXPECTED_%s" % output_name,
                             "FORWARD_%s" % output_name),
                            equal_nan=equal_nan)
    return executor.outputs


def check_symbolic_backward(sym_inst, location, out_grads, expected,
                            rtol=1e-5, atol=None, aux_states=None,
                            grad_req="write", ctx=None, grad_stypes=None,
                            equal_nan=False, dtype=default_dtype):
    """The gradients of a backward from ``out_grads`` against
    ``expected`` numpy arrays, under each argument's ``grad_req``."""
    assert dtype in (np.float16, np.float32, np.float64)
    if ctx is None:
        ctx = default_context()
    location = _parse_location(sym_inst, location, ctx, dtype=dtype)
    aux_states = _parse_aux_states(sym_inst, aux_states, ctx, dtype=dtype)
    if isinstance(expected, (list, tuple)):
        expected = dict(zip(sym_inst.list_arguments(), expected))
    args_grad_npy = {k: _rng.normal(size=location[k].shape)
                     for k in expected}
    args_grad_data = {k: nd.array(v, ctx=ctx, dtype=dtype)
                      for k, v in args_grad_npy.items()}
    if isinstance(grad_req, str):
        grad_req = {k: grad_req for k in sym_inst.list_arguments()}
    elif isinstance(grad_req, (list, tuple)):
        grad_req = dict(zip(sym_inst.list_arguments(), grad_req))
    executor = sym_inst.bind(ctx, args=location, args_grad=args_grad_data,
                             grad_req=grad_req, aux_states=aux_states)
    executor.forward(is_train=True)
    if isinstance(out_grads, (tuple, list)):
        out_grads = [nd.array(np.asarray(v), ctx=ctx, dtype=dtype)
                     for v in out_grads]
    elif isinstance(out_grads, dict):
        out_grads = [nd.array(np.asarray(out_grads[k]), ctx=ctx, dtype=dtype)
                     for k in sym_inst.list_outputs()]
    else:
        assert out_grads is None
    executor.backward(out_grads)
    grads = {k: v.asnumpy() for k, v in executor.grad_dict.items()
             if v is not None}
    for name in expected:
        _check_grad(grad_req[name], name, expected[name], grads[name],
                    args_grad_npy[name], rtol, atol,
                    ("EXPECTED_%s" % name, "BACKWARD_%s" % name),
                    equal_nan=equal_nan)
    return args_grad_data


def check_consistency(sym_inst, ctx_list, scale=1.0, grad_req="write",
                      arg_params=None, aux_params=None, tol=None,
                      raise_on_err=True, ground_truth=None, equal_nan=False):
    """Bind one symbol (or one per entry) on each ``{"ctx": ...,
    "type_dict": ..., <input shapes>}`` of ``ctx_list`` with the same
    random arguments, run forward and backward, and hold every outputs
    and gradients to those of the most precise dtype. Returns each
    executor's outputs."""
    if tol is None:
        tol = {np.dtype(np.float16): 1e-1,
               np.dtype(np.float32): 1e-3,
               np.dtype(np.float64): 1e-5,
               np.dtype(np.uint8): 0,
               np.dtype(np.int32): 0}
    elif isinstance(tol, numbers.Number):
        tol = {np.dtype(t): tol for t in (np.float16, np.float32, np.float64,
                                          np.uint8, np.int32)}
    assert len(ctx_list) > 1
    sym_list = [sym_inst] * len(ctx_list) if isinstance(sym_inst, sym.Symbol) \
        else sym_inst

    arg_np = None
    exe_list = []
    for s, ctx in zip(sym_list, ctx_list):
        shapes = dict(ctx)
        the_ctx = shapes.pop("ctx")
        shapes.pop("type_dict", None)
        exe = s.simple_bind(the_ctx, grad_req=grad_req, **shapes)
        if arg_np is None:
            arg_np = {name: np.random.normal(0.0, scale, size=arr.shape)
                      for name, arr in exe.arg_dict.items()}
            if arg_params:
                arg_np.update({k: v.asnumpy() if isinstance(v, NDArray)
                               else v for k, v in arg_params.items()})
        for name, arr in exe.arg_dict.items():
            arr._set_data(nd.array(arg_np[name], ctx=arr.context,
                                   dtype=arr.dtype)._data)
        exe_list.append(exe)

    dtypes = [np.dtype(e.outputs[0].dtype if e.outputs else np.float32)
              for e in exe_list]
    for exe in exe_list:
        exe.forward(is_train=(grad_req != "null"))
        if grad_req != "null":
            exe.backward()

    gt_idx = int(np.argmax([np.finfo(d).precision if d.kind == "f" else 0
                            for d in dtypes]))
    gt = exe_list[gt_idx]
    for i, exe in enumerate(exe_list):
        if i == gt_idx:
            continue
        rtol = tol.get(dtypes[i], 1e-3)
        for o_gt, o in zip(gt.outputs, exe.outputs):
            assert_almost_equal(o.asnumpy(), o_gt.asnumpy(), rtol=rtol,
                                atol=rtol, equal_nan=equal_nan)
        if grad_req != "null":
            for name in gt.grad_dict:
                if gt.grad_dict[name] is None or \
                        exe.grad_dict.get(name) is None:
                    continue
                assert_almost_equal(exe.grad_dict[name].asnumpy(),
                                    gt.grad_dict[name].asnumpy(), rtol=rtol,
                                    atol=rtol, equal_nan=equal_nan)
    return [e.outputs for e in exe_list]


def check_speed(sym_inst, location=None, ctx=None, N=20, grad_req=None,
                typ="whole", **input_shapes):
    """Seconds per forward (typ "forward") or forward and backward
    ("whole") of a symbol, each run ending in a host read of its
    results. ``location`` gives every argument, else ``input_shapes``
    the inputs' shapes and the rest is drawn."""
    ctx = ctx or default_context()
    if grad_req is None:
        grad_req = "write"
    if location is not None:
        input_shapes = {k: np.asarray(v).shape for k, v in location.items()}
    ex = sym_inst.simple_bind(ctx, grad_req=grad_req, **input_shapes)
    if location is None:
        location = {name: np.random.normal(size=arr.shape, scale=1.0)
                    for name, arr in ex.arg_dict.items()}
    for k, v in location.items():
        ex.arg_dict[k][:] = v

    def run():
        ex.forward(is_train=(typ == "whole"))
        if typ == "whole":
            ex.backward(out_grads=[
                nd.array(np.ones(o.shape, dtype=o.asnumpy().dtype), ctx=ctx)
                for o in ex.outputs])
            for g in ex.grad_dict.values():
                if g is not None:
                    g.asnumpy()
        for o in ex.outputs:
            o.asnumpy()

    run()
    tic = time.time()
    for _ in range(N):
        run()
    return (time.time() - tic) / N


# --- environment helpers -----------------------------------------------------

def list_gpus():
    """Indices of the visible CUDA cards."""
    return list(range(torch.cuda.device_count()))


def retry(n):
    """Decorator: run a flaky test up to ``n`` times while it fails an
    assertion."""
    assert n > 0

    def decorate(f):
        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            for i in range(n):
                try:
                    return f(*args, **kwargs)
                except AssertionError:
                    if i == n - 1:
                        raise
        return wrapper
    return decorate


@contextlib.contextmanager
def _stderr_discarded():
    with open(os.devnull, "w") as devnull:
        old = os.dup(2)
        os.dup2(devnull.fileno(), 2)
        try:
            yield
        finally:
            os.dup2(old, 2)
            os.close(old)


def discard_stderr():
    """Context manager that silences the process's stderr (fd 2)."""
    return _stderr_discarded()


def set_env_var(key, val, default_val=""):
    """Set an environment variable; returns its previous value."""
    prev = os.environ.get(key, default_val)
    os.environ[key] = val
    return prev


def download(url, fname=None, dirname=None, overwrite=False):
    """The path of an already downloaded file; nothing is fetched, so a
    missing file raises."""
    fname = fname or url.split("/")[-1]
    if dirname:
        fname = os.path.join(dirname, fname)
    if os.path.exists(fname) and not overwrite:
        return fname
    raise IOError("download unavailable in this environment: %s" % url)


def get_bz2_data(data_dir, data_name, url, data_origin_name):
    """The path of an already extracted dataset file; nothing is
    fetched."""
    path = os.path.join(data_dir, data_name)
    if not os.path.exists(path):
        raise MXNetError(
            "get_bz2_data: %s not found and this environment has no "
            "network egress; place the extracted file there manually"
            % path)
    return path


def get_mnist():
    """Synthetic MNIST-shaped dataset (reference: test_utils.py:get_mnist
    downloads the real one; offline here, so deterministic synthetic digits
    with a learnable class structure are generated instead). The same
    numpy draws in the same order as the JAX package's, so the arrays are
    bit-identical."""
    rng = np.random.RandomState(42)
    n_train, n_test = 6000, 1000
    templates = rng.uniform(0, 1, (10, 1, 28, 28)).astype(np.float32)

    def make(n):
        labels = rng.randint(0, 10, n)
        imgs = templates[labels] + rng.normal(0, 0.3, (n, 1, 28, 28)) \
            .astype(np.float32)
        return np.clip(imgs, 0, 1).astype(np.float32), \
            labels.astype(np.float32)

    train_data, train_label = make(n_train)
    test_data, test_label = make(n_test)
    return {"train_data": train_data, "train_label": train_label,
            "test_data": test_data, "test_label": test_label}
