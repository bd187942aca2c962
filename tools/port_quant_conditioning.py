#!/usr/bin/env python3
"""How far int8 quantization moves ResNet-50's answers, in both packages.

    JAX_PLATFORMS=cpu python tools/port_quant_conditioning.py [--quick]

On the CPU, with the weights of ``chip_smoke.py`` phase 18:

* (a) ``bench_all.py --quantize``'s predict protocol at full size
  (ResNet-50 NCHW at 224, Xavier from numpy's seed 0 with fc1_weight x 8,
  calibrated over 3 random batches, 256 evaluation rows, batch 16): the
  top-1 agreement of the int8 arm (``default,quantize``) with the fp32
  arm (``default``) in ``mxnet_tpu_torch`` and in ``mxnet_tpu`` on the
  same weights and table, how many classes the fp32 arm predicts, the
  median gap between its two largest logits, and how often the two
  packages' int8 arms agree;
* (b) phase 3's NHWC ResNet-50 (He-initialised from seed 0, fc1_bias
  centring the logits), calibrated under the default pipeline: how far
  int8 moves the fc1 logits of 8 images (over max |logit|) and their
  top-1 agreement with fp32, in both packages.

A random deep network's top-1 is decided by small margins, and int8
rounding moves it; these figures say what ``chip_smoke.py`` phase 18 may
see on the card without a fault in the port. ``--quick`` runs (a) at the
bench's QUICK geometry (ResNet 8 at 16 px, batch 4, 64 rows) instead.
About 6 minutes on 8 cores, most of it the JAX package's int8 arm.
"""
import json
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as c  # noqa: E402
import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu.graph_pass  # noqa: E402,F401
import mxnet_tpu_torch as tmx  # noqa: E402


def _module(mx, sym, shape, spec, args, aux, table=None):
    mx.graph_pass.set_passes(spec)
    mx.graph_pass.set_calibration_table(table)
    try:
        mod = mx.mod.Module(sym, context=mx.cpu())
        mod.bind(data_shapes=[("data", shape)], for_training=False)
        mod.init_params(mx.init.Uniform(0.1))
        mod.set_params({k: mx.nd.array(v, ctx=mx.cpu())
                        for k, v in args.items()},
                       {k: mx.nd.array(v, ctx=mx.cpu())
                        for k, v in aux.items()})
        return mod
    finally:
        mx.graph_pass.set_passes(None)
        mx.graph_pass.set_calibration_table(None)


def _predict(mx, mod, x, bs, head=0):
    """``mod``'s output ``head`` over ``x`` in batches of ``bs``, fetched
    once."""
    out = mod.predict(mx.io.NDArrayIter(x, None, batch_size=bs))
    return (out[head] if isinstance(out, list) else out).asnumpy()


def _arms(mx, sym, shape, args, aux, path, x, bs, head=0):
    """(fp32 outputs, int8 outputs) of ``sym`` in package ``mx`` on the
    same weights, the int8 arm under the table at ``path``."""
    table = mx.graph_pass.CalibrationTable.load(path)
    ref = _predict(mx, _module(mx, sym, shape, "default", args, aux), x,
                   bs, head)
    got = _predict(mx, _module(mx, sym, shape, "default,quantize", args,
                               aux, table), x, bs, head)
    return ref, got


def predict_protocol(geometry, tmp):
    """(a): the port's Xavier weights, then both packages (the table
    passes between them as JSON under ``tmp``)."""
    layers, size, bs, rows, classes = geometry
    rng = np.random.RandomState(0)
    x = rng.rand(bs, 3, size, size).astype(np.float32)
    eval_x = rng.rand(rows, 3, size, size).astype(np.float32)
    calib = [rng.rand(bs, 3, size, size).astype(np.float32)
             for _ in range(c.Q_CALIB)]
    syms = {}
    for name, mx in (("torch", tmx), ("jax", jmx)):
        syms[name] = mx.models.get_resnet(num_classes=classes,
                                          num_layers=layers,
                                          image_shape=(3, size, size))
    mod = tmx.mod.Module(syms["torch"], context=tmx.cpu())
    mod.bind(data_shapes=[("data", x.shape)], for_training=False)
    np.random.seed(0)
    mod.init_params(tmx.init.Xavier())
    a, au = mod.get_params()
    args = {k: v.asnumpy() for k, v in a.items()}
    aux = {k: v.asnumpy() for k, v in au.items()}
    args["fc1_weight"] = args["fc1_weight"] * 8.0
    fp32 = _module(tmx, syms["torch"], x.shape, "default", args, aux)
    table = tmx.graph_pass.calibrate(fp32, calib)
    path = table.save(os.path.join(tmp, "predict_table.json"))
    arms = {"torch": _arms(tmx, syms["torch"], x.shape, args, aux, path,
                           eval_x, bs),
            "jax": _arms(jmx, syms["jax"], x.shape, args, aux, path,
                         eval_x, bs)}
    res = {name: _agreement(ref, got) for name, (ref, got) in arms.items()}
    res["int8_top1_port_vs_jax"] = float(
        (arms["torch"][1].argmax(1) == arms["jax"][1].argmax(1)).mean())
    return res


def _agreement(ref, got):
    logits = np.sort(np.log(ref), axis=1)
    return dict(top1_agreement=float((ref.argmax(1)
                                      == got.argmax(1)).mean()),
                fp32_classes=int(len(set(ref.argmax(1)))),
                median_top2_logit_gap=float(np.median(logits[:, -1]
                                                      - logits[:, -2])))


def served_gaps(tmp, n=8):
    """(b): int8 against fp32 on phase 3's served graph."""
    syms = {}
    with tmx.NameManager():
        syms["torch"] = tmx.models.get_resnet(num_layers=50, layout="NHWC")
    with jmx.name.NameManager():
        syms["jax"] = jmx.models.get_resnet(num_layers=50, layout="NHWC")
    args, aux = c.resnet50_params(syms["torch"], seed=0)
    c.center_fc_bias(tmx, syms["torch"], args, aux,
                     np.random.default_rng(1), device="cpu")
    rng = np.random.default_rng(18)
    x = rng.standard_normal((n,) + c.ROW, dtype=np.float32)
    calib = [rng.standard_normal((8,) + c.ROW, dtype=np.float32)
             for _ in range(c.Q_CALIB)]
    served = {k: mx.sym.Group([s, s.get_internals()["fc1_output"]])
              for (k, s), mx in zip(syms.items(), (tmx, jmx))}
    shape = (n,) + c.ROW
    fp32 = _module(tmx, served["torch"], shape, "default", args, aux)
    table = tmx.graph_pass.calibrate(fp32, calib)
    path = table.save(os.path.join(tmp, "served_table.json"))
    arms = {"torch": _arms(tmx, served["torch"], shape, args, aux, path,
                           x, n, head=1),
            "jax": _arms(jmx, served["jax"], shape, args, aux, path, x, n,
                         head=1)}
    return {name: dict(
        logit_gap=float(np.abs(got - ref).max() / np.abs(ref).max()),
        top1_agreement=float((ref.argmax(1) == got.argmax(1)).mean()))
        for name, (ref, got) in arms.items()}


def main():
    quick = "--quick" in sys.argv
    geometry = (8, 16, 4, 64, 10) if quick else (50, 224, 16, 256, 1000)
    with tempfile.TemporaryDirectory() as tmp:
        out = {"predict": predict_protocol(geometry, tmp),
               "geometry": dict(zip(("layers", "size", "batch", "rows",
                                     "classes"), geometry))}
        if not quick:
            out["served"] = served_gaps(tmp)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
