#!/usr/bin/env python3
"""Does the divergence at the model-zoo bench's protocol come from the port?

    JAX_PLATFORMS=cpu python tools/port_c3_divergence.py [--steps N] [--batch B]

On the CPU, in ``mxnet_tpu`` and in ``mxnet_tpu_torch`` from the same numpy
parameters (the JAX net initialised, its weights carried into the port's
net by ``gluon_params_from_jax``) and the same batch, a few training steps
of each case, with the loss of each step:

* AlexNet and VGG16 (1000 classes, 224 px) at ``bench_gluon_resnet``'s
  protocol (bench_all.py:153-211): the default ``initialize()`` (uniform
  in [-0.07, 0.07] from ``np.random.seed(0)``), SGD 0.05, one fixed random
  batch (``np.random.rand`` pixels, random labels), stepped on the recorded
  tape (the JAX net hybridized);
* the CTC head of ``chip_smoke.py`` phase 16 (b): ``gluon.rnn.LSTM`` 2 x
  256 (TNC) -> ``Dense(11)`` -> ``CTCLoss`` with label lengths, T 80,
  batch 32, 40 features, Xavier, Adam 0.01.

A case is a port fault only if the JAX package's losses stay finite where
the port's do not. Prints one JSON object; a few minutes on 8 cores at
the defaults (--steps 6 --batch 4), most of it VGG16.
"""
import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu_torch as tmx  # noqa: E402

CTC_T, CTC_BATCH, CTC_FEATURES, CTC_HIDDEN, CTC_CLASSES = 80, 32, 40, 256, 11


def losses_of(mx, net, trainer, loss_fn, inputs, steps, ctx):
    data = [mx.nd.array(a, **ctx) for a in inputs]
    out = []
    for _ in range(steps):
        with mx.autograd.record():
            loss = loss_fn(net(data[0]), *data[1:])
        loss.backward()
        trainer.step(inputs[0].shape[0])
        out.append(float(loss.asnumpy().mean()))  # graftlint: disable=G001 — each step's loss is the study's output
    return out


def zoo_case(name, steps, batch):
    np.random.seed(0)
    jmx.random.seed(0)
    rng = np.random.RandomState(0)
    x = rng.rand(batch, 3, 224, 224).astype(np.float32)
    y = rng.randint(0, 1000, batch).astype(np.float32)
    jnet = jmx.gluon.model_zoo.vision.get_model(name)
    jnet.initialize()
    jnet(jmx.nd.array(x[:1]))
    tnet = tmx.gluon.model_zoo.vision.get_model(name)
    tnet.initialize(ctx=tmx.cpu())
    tmx.gluon_params_from_jax(jnet, tnet)
    jnet.hybridize()
    out = {}
    for mx, net, ctx in ((jmx, jnet, {}), (tmx, tnet, {"ctx": tmx.cpu()})):
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.05}, kvstore="local")
        out["jax" if mx is jmx else "port"] = losses_of(  # graftlint: disable=G001 — one study per package
            mx, net, trainer, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
            [x, y], steps, ctx)
    return out


def ctc_net(mx):
    gluon = mx.gluon
    net = gluon.nn.Sequential(prefix="ctc_")
    with net.name_scope():
        net.add(gluon.rnn.LSTM(CTC_HIDDEN, num_layers=2, layout="TNC",
                               input_size=CTC_FEATURES))
        net.add(gluon.nn.Dense(CTC_CLASSES, flatten=False,
                               in_units=CTC_HIDDEN))
    return net


def ctc_case(steps):
    np.random.seed(0)
    jmx.random.seed(0)
    rng = np.random.RandomState(0)
    lens = rng.randint(4, 9, CTC_BATCH)
    lab = np.zeros((CTC_BATCH, 8), np.float32)
    for i, k in enumerate(lens):
        lab[i, :k] = rng.randint(1, CTC_CLASSES, k)
    feats = rng.randn(CTC_T, CTC_BATCH, CTC_FEATURES).astype(np.float32)
    jnet = ctc_net(jmx)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(feats))
    tnet = ctc_net(tmx)
    tnet.initialize(tmx.init.Xavier(), ctx=tmx.cpu())
    tmx.gluon_params_from_jax(jnet, tnet)
    out = {}
    for mx, net, ctx in ((jmx, jnet, {}), (tmx, tnet, {"ctx": tmx.cpu()})):
        trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": 0.01}, kvstore="local")
        loss_fn = mx.gluon.loss.CTCLoss(layout="TNC", label_layout="NT")
        data = mx.nd.array(feats, **ctx)
        label = mx.nd.array(lab, **ctx)
        n = mx.nd.array(lens.astype(np.float32), **ctx)
        losses = []
        for _ in range(steps):
            with mx.autograd.record():
                loss = loss_fn(net(data), label, None, n)
            loss.backward()
            trainer.step(CTC_BATCH)
            losses.append(float(loss.asnumpy().mean()))  # graftlint: disable=G001 — each step's loss is the study's output
        out["jax" if mx is jmx else "port"] = losses
    return out


def verdict(case):
    jf = bool(np.all(np.isfinite(case["jax"])))
    pf = bool(np.all(np.isfinite(case["port"])))
    case.update(jax_finite=jf, port_finite=pf, port_fault=jf and not pf,
                max_rel_gap=float(np.max(
                    np.abs(np.subtract(case["port"], case["jax"]))
                    / np.maximum(np.abs(case["jax"]), 1e-30)))
                if jf and pf else None)
    return case


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=6)
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--cases", default="alexnet,vgg16,ctc")
    opts = parser.parse_args()
    results = {"steps": opts.steps, "batch": opts.batch}
    for name in opts.cases.split(","):
        if name == "ctc":
            case = ctc_case(max(opts.steps, 10))  # graftlint: disable=G001 — one study per case
        else:
            case = zoo_case(name, opts.steps, opts.batch)  # graftlint: disable=G001 — one study per case
        results[name] = verdict(case)
        print(name, json.dumps(results[name]), file=sys.stderr, flush=True)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
