"""The ``_FusedRegion`` operator — execution side of the fuse pass.

Counterpart of ``mxnet_tpu/ops/fused.py``. One node stands in for a carved
matmul/conv + epilogue chain: its attrs carry the base op name, the base
op's own string attrs (re-parsed through the base opdef) and the epilogue
as a JSON step list (act / scalar / cast / vec / res). Extra epilogue
operands ride as node inputs after the base op's own.

Lowering, decided per call from shapes and dtypes (the JAX package's rule):

* **Fused kernel** (parallel/fused.py) when ``MXNET_FUSION_KERNEL`` is on
  and the region has a matmul form: FullyConnected, 2-d ``dot`` and 1x1
  stride-1 channels-last Convolution onto ``fused_matmul``, 3-d
  ``batch_dot`` onto ``fused_batch_matmul``, in float dtypes, with an
  epilogue the kernel encodes. On a CUDA tensor that is the hand-written
  kernel; on a CPU tensor the wrapper computes its plain version.
* **Reference composition** otherwise (general convolutions, NCHW, vector
  steps on a non-last axis or after a batch_dot, transposed dot flags):
  the same registry ops the unfused graph would run, in the same order,
  inside this one node.

Gradients: the region's forward is a ``torch.autograd.Function``
(:class:`_FusedRegionFn`) whose backward re-runs the reference
composition under autograd and differentiates it, the counterpart of
the JAX package's ``jax.custom_vjp`` (kernel forward, reference-recompute
backward). The kernel writes its output through ctypes, so without the
Function a training walk would lose every fused region's gradient.
"""
from __future__ import annotations

import functools
import json

import torch

from ..base import MXNetError, dtype_name
from ..config import get_flag
from .param import Int, Str
from .registry import get_op, register_op

__all__ = ["EPILOGUE_ACTS", "fused_region_parts"]

# activation kinds the fuse pass may carve; parallel/fused.py _ACTS is the
# kernel-side twin (the tests assert they agree)
EPILOGUE_ACTS = ("relu", "sigmoid", "tanh", "softrelu", "softsign")

_FLOATS = ("float32", "bfloat16", "float16")


@functools.lru_cache(maxsize=4096)
def fused_region_parts(attrs):
    """(base opdef, parsed base attrs, epilogue step list, n_base) of a
    ``_FusedRegion`` node's parsed attrs. Memoized per attrs (they are
    hashable): PyTorch runs the graph eagerly, so every forward consults
    this, where the JAX package parses once per trace. Callers must not
    mutate the returned step list."""
    base = get_op(attrs.base_op)
    battrs = base.parse_attrs(json.loads(attrs.base_attrs))
    steps = json.loads(attrs.epilogue)
    return base, battrs, steps, int(attrs.n_base)


def _extra_steps(steps):
    return [s for s in steps if s["kind"] in ("vec", "res")]


def _apply_reference(base, battrs, steps, base_inputs, extras):
    """The unfused subgraph, replayed through the same registry ops in the
    same order."""
    out = base.apply(battrs, base_inputs)[0][0]
    ei = 0
    for step in steps:
        kind = step["kind"]
        if kind == "act":
            op = get_op(step["op"])
            kw = {"act_type": step["act"]} if step["op"] == "Activation" \
                else {}
            out = op.apply(op.parse_attrs(kw), [out])[0][0]
        elif kind == "scalar":
            op = get_op(step["op"])
            out = op.apply(op.parse_attrs({"scalar": step["scalar"]}),
                           [out])[0][0]
        elif kind == "cast":
            op = get_op("Cast")
            out = op.apply(op.parse_attrs({"dtype": step["dtype"]}),
                           [out])[0][0]
        elif kind in ("vec", "res"):
            op = get_op(step["op"])
            other = extras[ei]
            ei += 1
            ins = [out, other] if step.get("slot", 0) == 0 else [other, out]
            out = op.apply(op.parse_attrs({}), ins)[0][0]
        else:
            raise MXNetError("fused region: unknown epilogue step %r"
                             % (step,))
    return out


@functools.lru_cache(maxsize=4096)
def _kernel_epilogue_of(attrs):
    return _kernel_epilogue(fused_region_parts(attrs)[2])


def _kernel_epilogue(steps):
    """The kernel's epilogue tuples for the graph steps, or None when a
    step has no kernel form."""
    from ..parallel import fused as F

    out = []
    for step in steps:
        kind = step["kind"]
        if kind == "act":
            if not F.supported_act(step["act"]):
                return None
            out.append(("act", step["act"]))
        elif kind == "scalar":
            out.append(("scalar", step["op"], float(step["scalar"])))
        elif kind == "cast":
            if step["dtype"] not in _FLOATS:
                return None
            out.append(("cast", step["dtype"]))
        elif kind == "res":
            if step["op"] not in ("elemwise_add", "elemwise_mul"):
                return None
            out.append(("res", step["op"]))
        elif kind == "vec":
            bshape = step.get("bshape")
            if bshape == "full" and step["op"] == "broadcast_add":
                out.append(("res", "elemwise_add"))
            elif bshape == "full" and step["op"] == "broadcast_mul":
                out.append(("res", "elemwise_mul"))
            elif bshape == "lastdim" and step["op"] == "broadcast_add":
                out.append(("vadd",))
            elif bshape == "lastdim" and step["op"] == "broadcast_mul":
                out.append(("vmul",))
            else:
                # a channel vector on a non-last axis (NCHW conv) has no
                # kernel form
                return None
        else:
            return None
    return tuple(out)


def _kernel_matmul_form(base, battrs, base_inputs, extras):
    """(x2d, w, wt, kernel extras, epilogue prefix) for the dense 2-d
    kernel, or None when this base has no matmul form. The base op's own
    bias becomes a leading ("bias",) step."""
    name = base.name
    prefix = []
    if name == "FullyConnected":
        data, weight = base_inputs[0], base_inputs[1]
        x = data.reshape(data.shape[0], -1) if battrs.flatten else \
            data.reshape(-1, data.shape[-1])
        if not battrs.no_bias:
            prefix.append(("bias",))
            extras = [base_inputs[2]] + list(extras)
        return x, weight, True, list(extras), prefix
    if name == "dot":
        if battrs.get("transpose_a") or battrs.get("transpose_b"):
            return None
        x, w = base_inputs[0], base_inputs[1]
        if x.dim() != 2 or w.dim() != 2:
            return None
        return x, w, False, list(extras), prefix
    if name == "Convolution":
        layout = battrs.layout or ""
        if (tuple(battrs.kernel) != (1, 1) or not layout.endswith("C")
                or tuple(battrs.stride or (1, 1)) != (1, 1)
                or tuple(battrs.pad or (0, 0)) != (0, 0)
                or int(battrs.num_group or 1) != 1
                or bool(battrs.get("dilate")
                        and tuple(battrs.dilate) != (1, 1))):
            return None
        data, weight = base_inputs[0], base_inputs[1]
        if data.dim() != 4:
            return None
        N, H, W, C = data.shape
        x = data.reshape(N * H * W, C)
        w = weight.reshape(C, int(battrs.num_filter))  # HWIO, 1x1
        if not battrs.no_bias:
            prefix.append(("bias",))
            extras = [base_inputs[2]] + list(extras)
        return x, w, False, list(extras), prefix
    return None


def _try_kernel(base, battrs, kern_steps, base_inputs, extras, out_shape,
                out_dtype):
    """The fused-kernel lowering, or None (the caller composes the
    reference)."""
    from ..parallel import fused as F

    if any(dtype_name(t.dtype) not in _FLOATS
           for t in list(base_inputs) + list(extras)):
        return None
    if kern_steps is None:
        return None
    if base.name == "batch_dot":
        return _try_batch_kernel(F, battrs, kern_steps, base_inputs, extras,
                                 out_shape, out_dtype)
    form = _kernel_matmul_form(base, battrs, base_inputs, extras)
    if form is None:
        return None
    x, w, wt, kextras, prefix = form
    M = x.shape[0]
    N = w.shape[0] if wt else w.shape[1]
    shaped = []
    for step, arr in zip(list(prefix) + [s for s in kern_steps if s[0] in (
            "bias", "vmul", "vadd", "res")], kextras):
        want = M * N if step[0] == "res" else N
        if arr.numel() != want:
            return None
        shaped.append((arr.reshape(M, N) if step[0] == "res"
                       else arr.reshape(-1)).contiguous())
    out = F.fused_matmul(x.contiguous(), w.contiguous(), extras=shaped,
                         epilogue=tuple(prefix) + kern_steps, wt=wt,
                         out_dtype=out_dtype)
    return out.reshape(out_shape)


def _try_batch_kernel(F, battrs, kern_steps, base_inputs, extras, out_shape,
                      out_dtype):
    """The batch_dot lowering onto fused_batch_matmul, or None. As in the
    JAX package, transposed-operand flags and vector steps stay on the
    reference composition. A ``transpose(k, (0, 2, 1))`` operand arrives
    as a view and is handed over as it is: the kernel reads it in place."""
    if battrs.get("transpose_a") or battrs.get("transpose_b"):
        return None
    if any(s[0] in ("bias", "vmul", "vadd") for s in kern_steps):
        return None
    x, w = base_inputs[0], base_inputs[1]
    if x.dim() != 3 or w.dim() != 3:
        return None
    B, M, K = x.shape
    N = w.shape[2]
    if x.stride(2) != 1 or x.stride(1) != K:
        x = x.contiguous()
    if not ((w.stride(2) == 1 and w.stride(1) == N)
            or (w.stride(1) == 1 and w.stride(2) == K)):
        w = w.contiguous()
    res = []
    for e in extras:
        if e.numel() != B * M * N:
            return None
        res.append(e.reshape(B, M, N).contiguous())
    out = F.fused_batch_matmul(x, w, extras=res, epilogue=kern_steps,
                               out_dtype=out_dtype)
    return out.reshape(out_shape)


def _region_forward(attrs, inputs):
    """The region's value: the kernel lowering where it applies, else the
    reference composition."""
    base, battrs, steps, n_base = fused_region_parts(attrs)
    base_inputs = list(inputs[:n_base])
    extras = list(inputs[n_base:])
    if get_flag("MXNET_FUSION_KERNEL"):
        shapes = _fused_infer_shape(attrs, [tuple(t.shape) for t in inputs],
                                    [])
        dtypes = _fused_infer_dtype(attrs, [dtype_name(t.dtype)
                                            for t in inputs], [])
        if shapes is not None and shapes[1][0] is not None:
            out = _try_kernel(base, battrs, _kernel_epilogue_of(attrs),
                              base_inputs, extras, shapes[1][0],
                              dtypes[1][0])
            if out is not None:
                return out
    return _apply_reference(base, battrs, steps, base_inputs, extras)


class _FusedRegionFn(torch.autograd.Function):
    """Kernel (or plain) forward, reference-recompute backward: the
    backward re-runs the unfused composition on the saved region inputs
    under autograd and returns its input gradients, so every epilogue
    combination is differentiable without a hand-written backward."""

    @staticmethod
    def forward(ctx, attrs, *inputs):
        ctx.attrs = attrs
        ctx.save_for_backward(*inputs)
        return _region_forward(attrs, inputs)

    @staticmethod
    def backward(ctx, grad):
        base, battrs, steps, n_base = fused_region_parts(ctx.attrs)
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(need) for t, need in
                   zip(saved, needs)]
            out = _apply_reference(base, battrs, steps, ins[:n_base],
                                   ins[n_base:])
            wrt = [t for t in ins if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wrt, grad,
                                             allow_unused=True))
        result = [None]
        for t, need in zip(ins, needs):
            g = next(grads) if need else None
            if need and g is None:
                g = torch.zeros_like(t)
            result.append(g)
        return tuple(result)


def _fused_region(attrs, *inputs):
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _FusedRegionFn.apply(attrs, *inputs)
    return _region_forward(attrs, inputs)


def _fused_num_inputs(attrs):
    return int(attrs.n_base) + len(_extra_steps(json.loads(attrs.epilogue)))


def _fused_input_names(attrs):
    base = get_op(attrs.base_op)
    battrs = base.parse_attrs(json.loads(attrs.base_attrs))
    steps = json.loads(attrs.epilogue)
    return base.get_input_names(battrs) + [
        "fused_extra%d" % i for i in range(len(_extra_steps(steps)))]


def _fused_infer_shape(attrs, in_shapes, aux_shapes):
    base, battrs, steps, n_base = fused_region_parts(attrs)
    res = base.run_infer_shape(battrs, in_shapes[:n_base], [])
    if res is None:
        return None
    base_in, outs = list(res[0]), list(res[1])
    out = outs[0]
    extras = []
    for i, step in enumerate(_extra_steps(steps)):
        given = in_shapes[n_base + i] if n_base + i < len(in_shapes) \
            else None
        same_shape = step["kind"] == "res" or step.get("bshape") == "full"
        if given is None:
            extras.append(tuple(out) if out is not None and same_shape
                          else None)
        elif same_shape and out is not None and len(given) == len(out):
            # unknown (0) extra dims backfill from the region output
            extras.append(tuple(o if g == 0 else g
                                for g, o in zip(given, out)))
        else:
            extras.append(tuple(given))
    return (base_in + extras, [out], aux_shapes)


def _fused_infer_backward(attrs, out_shapes, in_shapes):
    """Epilogue steps preserve shape, so the region output is the base
    output: delegate to the base op's backward rule and backfill
    same-shape extras."""
    base, battrs, steps, n_base = fused_region_parts(attrs)
    out = list(in_shapes)
    if base.infer_backward is not None:
        back = base.infer_backward(battrs, list(out_shapes),
                                   list(in_shapes[:n_base]))
        if back is not None:
            out[:n_base] = list(back)[:n_base]
    o = out_shapes[0] if out_shapes else None
    for i, step in enumerate(_extra_steps(steps)):
        j = n_base + i
        if j < len(out) and out[j] is None and o is not None and (
                step["kind"] == "res" or step.get("bshape") == "full"):
            out[j] = tuple(o)
    if out == list(in_shapes):
        return None
    return out


def _fused_infer_dtype(attrs, in_dtypes, aux_dtypes):
    base, battrs, steps, n_base = fused_region_parts(attrs)
    res = base.run_infer_dtype(battrs, in_dtypes[:n_base], [])
    d = res[1][0] if res is not None else (in_dtypes[0] or "float32")
    for step in steps:
        if step["kind"] == "cast":
            d = step["dtype"]
    return (list(in_dtypes), [d], list(aux_dtypes))


register_op(
    "_FusedRegion", _fused_region,
    params={"base_op": Str(), "base_attrs": Str(default="{}"),
            "epilogue": Str(default="[]"), "n_base": Int(default=2)},
    num_inputs=_fused_num_inputs,
    input_names=_fused_input_names,
    infer_shape=_fused_infer_shape,
    infer_backward=_fused_infer_backward,
    infer_dtype=_fused_infer_dtype,
    doc="Fusion-region node (graph_pass/fuse.py): base matmul/conv + "
        "epilogue chain, lowered to the fused matmul kernel "
        "(parallel/fused.py) or to its reference composition.")
