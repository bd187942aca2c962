#!/usr/bin/env python3
"""How far the amp graph pass moves ResNet-50's logits, in both packages.

    JAX_PLATFORMS=cpu python tools/port_amp_conditioning.py

On the CPU, ResNet-50 NHWC with ``chip_smoke.py``'s seed-0 He-initialised
weights (phase 3's, ``fc1_bias`` centring the logits) and the same weights
with BatchNorm's moving statistics brought to the data (``calibrated_bn``:
training-mode forwards of 4 images), two images, the served graph's fc1
logits under ``MXNET_GRAPH_PASSES=default`` and ``default,amp``: the
largest logit change amp makes in ``mxnet_tpu_torch`` and in ``mxnet_tpu``,
the gap between the two packages' fp32 and amp logits, and the port's amp
graph with the fused regions' kernel form against ``MXNET_FUSION_KERNEL=0``
(the regions' unfused composition). A random deep network amplifies bf16
rounding; these figures say how much of a gap ``chip_smoke.py`` phase 17
(a) may see between amp and fp32 on the card without a fault in the port.
"""
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as c  # noqa: E402
import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu.graph_pass  # noqa: E402,F401
import mxnet_tpu_torch as tmx  # noqa: E402

CALIBRATE = 12   # training-mode forwards of the 4 calibration images


def port_logits(sym, args, aux, x, spec, kernel=True):
    tmx.graph_pass.set_passes(spec)
    tmx.config.set_flag("MXNET_FUSION_KERNEL", None if kernel else 0)
    try:
        mod = tmx.mod.Module(sym, context=tmx.cpu(), label_names=None)
        mod.bind(data_shapes=[("data", x.shape)], for_training=False)
        mod.set_params({k: tmx.nd.array(v, ctx=tmx.cpu())
                        for k, v in args.items()},
                       {k: tmx.nd.array(v, ctx=tmx.cpu())
                        for k, v in aux.items()}, allow_missing=True)
        mod.forward(tmx.io.DataBatch([tmx.nd.array(x, ctx=tmx.cpu())], []),
                    is_train=False)
        return mod.get_outputs()[1].asnumpy()
    finally:
        tmx.graph_pass.set_passes(None)
        tmx.config.set_flag("MXNET_FUSION_KERNEL", None)


def jax_logits(sym, args, aux, x, spec):
    jmx.graph_pass.set_passes(spec)
    try:
        mod = jmx.mod.Module(sym, context=jmx.cpu(), label_names=None)
        mod.bind(data_shapes=[("data", x.shape)], for_training=False)
        mod.set_params({k: jmx.nd.array(v) for k, v in args.items()},
                       {k: jmx.nd.array(v) for k, v in aux.items()},
                       allow_missing=True)
        mod.forward(jmx.io.DataBatch([jmx.nd.array(x)], []), is_train=False)
        return mod.get_outputs()[1].asnumpy()
    finally:
        jmx.graph_pass.set_passes(None)


def gaps(name, tsym, jsym, args, aux, x):
    t32 = port_logits(tsym, args, aux, x, "default")
    tamp = port_logits(tsym, args, aux, x, "default,amp")
    tunfused = port_logits(tsym, args, aux, x, "default,amp", kernel=False)
    j32 = jax_logits(jsym, args, aux, x, "default")
    jamp = jax_logits(jsym, args, aux, x, "default,amp")
    gap = lambda a, b: float(np.abs(a - b).max())  # noqa: E731
    print("%s: max |logit| %.4g; amp moves the logits by %.4g (port) and "
          "%.4g (JAX); port vs JAX fp32 %.3g, amp %.4g; the port's amp "
          "kernel form vs the unfused composition %.4g"
          % (name, float(np.abs(t32).max()), gap(tamp, t32),
             gap(jamp, j32), gap(t32, j32), gap(tamp, jamp),
             gap(tamp, tunfused)), flush=True)


def main():
    with tmx.NameManager():
        tsym = tmx.models.get_resnet(num_layers=50, layout="NHWC")
    with jmx.name.NameManager():
        jsym = jmx.models.get_resnet(num_layers=50, layout="NHWC")
    tserved = tmx.sym.Group([tsym, tsym.get_internals()["fc1_output"]])
    jserved = jmx.sym.Group([jsym, jsym.get_internals()["fc1_output"]])
    args, aux = c.resnet50_params(tsym, seed=0)
    rng = np.random.default_rng(17)
    x = rng.standard_normal((2,) + c.ROW, dtype=np.float32)
    c.center_fc_bias(tmx, tsym, args, aux, np.random.default_rng(1),
                     device="cpu")
    gaps("phase 3's weights", tserved, jserved, args, aux, x)
    c.AMP_CALIBRATE = CALIBRATE
    aux = c.calibrated_bn(tmx, tsym, args, aux, rng.standard_normal(
        (4,) + c.ROW, dtype=np.float32), ctx=tmx.cpu())
    c.center_fc_bias(tmx, tsym, args, aux, np.random.default_rng(1),
                     device="cpu")
    gaps("BatchNorm calibrated", tserved, jserved, args, aux, x)


if __name__ == "__main__":
    main()
