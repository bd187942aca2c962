#!/usr/bin/env python3
"""What does the streaming reader cost a record-fed ResNet-50 step?

    python3 tools/port_record_fit_study.py [--epochs N]

On the card (H100), through the port: ``chip_smoke.py`` phase 19 (b)'s
drive, ResNet-50 NHWC fp32 (composed onto an NCHW ``transpose``, phase 9's
init and SGD 0.1 / 0.9 / 1e-4, batch 32) fit for ``--epochs`` over 512
random 224 px JPEG records, each step fenced in its batch-end callback,
in four arms from the same parameters:

* ``control``: the records decoded once onto the card, fed by an
  ``NDArrayIter`` (the fit loop without a reader);
* ``process8`` / ``process2``: ``ImageRecordIter(streaming=True,
  rand_mirror=True)`` with ImageNet mean / std, 8 or 2 forkserver decode
  processes;
* ``thread8``: the same with 8 decode threads in the training process.

Per arm: the median fenced ms/step, img/s, the host stall (time in
``next()`` over the fit's wall) and the reader's stage figures. Fewer
processes cost the step less where the workers' CPU time is what slows
it; the thread arm adds the decode to the training process's GIL. Prints
one JSON object last; about 2 minutes on the card.
"""
import argparse
import json
import os
import shutil
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as c  # noqa: E402


def arm(mx, sym, it, arg0, aux0, epochs):
    c.IO_RN_EPOCHS = epochs
    timed = c.io_timed_iter(it)
    try:
        _mod, losses, step_ms, wall, launches = c.io_fit_timed(
            mx, sym, timed, arg0, aux0)
        stats = it.get_stats() if hasattr(it, "get_stats") else None
    finally:
        timed.close()
    ms = float(np.median(step_ms))
    return {"ms_per_step": ms, "img_per_s": c.RN_BATCH / ms * 1e3,
            "host_stall": timed.wait_s / wall, "steps": len(losses),
            "launches": launches, "finite": bool(np.all(np.isfinite(losses))),
            "stages": stats["stages"] if stats else None}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--epochs", type=int, default=1)
    opts = parser.parse_args()

    import torch
    import mxnet_tpu_torch as mx

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = c.nvidia_smi()
    tmp = tempfile.mkdtemp(prefix="record_fit_study_")
    try:
        rec, idx = c.io_build_rec(mx, os.path.join(tmp, "data"), c.IO_N,
                                  c.IO_SIZE)
        sym = c.io_resnet_sym(mx)
        init = mx.mod.Module(sym, context=mx.gpu())
        init.bind(data_shapes=[("data", (c.RN_BATCH, 3, c.IO_SIZE,
                                          c.IO_SIZE))],
                  label_shapes=[("softmax_label", (c.RN_BATCH,))])
        np.random.seed(0)
        init.init_params(mx.init.Xavier(rnd_type="gaussian",
                                        factor_type="in", magnitude=2))
        arg0, aux0 = ({k: v.asnumpy() for k, v in d.items()}
                      for d in init.get_params())
        del init
        reader = c.io_record_iter(mx, rec, idx)
        xs, ys = [], []
        for b in reader:
            xs.append(b.data[0]._data.clone())
            ys.append(b.label[0]._data.clone())
        reader.close()
        control = mx.io.NDArrayIter(mx.nd.array(torch.cat(xs)),
                                    mx.nd.array(torch.cat(ys)),
                                    batch_size=c.RN_BATCH)
        del xs, ys
        out = {"card": card, "epochs": opts.epochs}
        # warm: cuDNN's algorithm choice and the allocator, outside the arms
        arm(mx, sym, control, arg0, aux0, 1)
        control.reset()
        out["control"] = arm(mx, sym, control, arg0, aux0, opts.epochs)
        base = dict(streaming=True, rand_mirror=True, path_imgidx=idx)
        for ch, m, s in zip("rgb", c.IMAGENET_MEAN, c.IMAGENET_STD):
            base["mean_" + ch], base["std_" + ch] = m, s
        for name, kw in (("process8", dict(decode_backend="process",
                                           preprocess_threads=8)),
                         ("process2", dict(decode_backend="process",
                                           preprocess_threads=2)),
                         ("thread8", dict(decode_backend="thread",
                                          preprocess_threads=8))):
            it = mx.io.ImageRecordIter(rec, (3, c.IO_SIZE, c.IO_SIZE),
                                       c.RN_BATCH, **dict(base, **kw))
            out[name] = arm(mx, sym, it, arg0, aux0, opts.epochs)
            print(name, json.dumps(out[name]), file=sys.stderr, flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
