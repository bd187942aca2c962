"""The flagship forward as one callable: the counterpart of the repo root's
``__graft_entry__.entry()``.

:func:`entry` returns ``(fn, example_args)`` for ResNet-50's inference
forward at batch 8, with the JAX entry's seed-0 parameters (numpy
``RandomState(0)``: each argument but ``data`` from ``normal(0, 0.05)`` in
argument order, the moving variances 1 and means 0, then the data from
``uniform(0, 1)``), bound on the card unless the caller passes another
context. It serves the NHWC build: the bind's fuse pass lowers its 1x1
convolutions onto the ``fused_matmul`` kernel (32 regions), while the NCHW
build, the JAX entry's default, launches no fused region (``ROADMAP.md``
North star). The JAX file's ``dryrun_multichip`` (a sharded step over
several devices) waits for distribution (Queue A10).
"""
from __future__ import annotations

import numpy as np

__all__ = ["entry"]


def entry(ctx=None, batch=8, layout="NHWC"):
    """Return ``(fn, (data, args, aux))``: ``fn(data, args, aux)`` runs
    ResNet-50's inference forward and returns the class probabilities
    (an NDArray on ``ctx``); the example arguments are NDArrays there."""
    from . import ndarray as nd
    from .context import Context, as_device
    from .models import get_resnet

    dev = as_device(ctx)
    ctx = Context.from_device(dev)
    symbol = get_resnet(num_classes=1000, num_layers=50, layout=layout)
    row = (224, 224, 3) if layout == "NHWC" else (3, 224, 224)
    arg_shapes, _, aux_shapes = symbol.infer_shape(data=(batch,) + row)
    rng = np.random.RandomState(0)
    args = {name: nd.array(rng.normal(0, 0.05, shape).astype(np.float32),
                           ctx=ctx)
            for name, shape in zip(symbol.list_arguments(), arg_shapes)
            if name != "data"}
    aux = {name: nd.array(np.full(shape, 1.0 if name.endswith("var")
                                  else 0.0, dtype=np.float32), ctx=ctx)
           for name, shape in zip(symbol.list_auxiliary_states(),
                                  aux_shapes)}
    data = nd.array(rng.uniform(0, 1, (batch,) + row).astype(np.float32),
                    ctx=ctx)
    exe = symbol.bind(ctx, args=dict(args, data=data), grad_req="null",
                      aux_states=aux)

    def fn(data, args, aux):
        exe.copy_params_from(args, aux)
        exe.forward(is_train=False, data=data)
        return exe.outputs[0]

    return fn, (data, args, aux)
