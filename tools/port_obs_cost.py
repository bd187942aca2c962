#!/usr/bin/env python3
"""Where the observability layer's per-step host time goes, on the card.

    python3 tools/port_obs_cost.py

Prints, one JSON line each, and writes all of it to
``chiprun_out/obs_cost.json``: (1) the per-call host cost of the perf
layer's driver events (record, elapsed time) beside ``torch.cuda.Event``'s
(record, query, synchronize, elapsed_time on completed events); (2)
``chip_smoke.py`` phase 20 (a)'s per-step perf work and its pieces; (3)
phase 20 (b)'s transformer microbench (:func:`health_costs`): ms/step with
the health policy off, with the warn guard and with its launch alone, 12
alternating blocks per arm, with the guard timed piece by piece, the
card's time for a step and a guard, and a cProfile of the warn arm; (4)
phase 20 (a) and (b)'s gated measurements three times each
(:func:`smoke_gates`); (5) the kernels one guard launches, by
``torch.profiler``; then (3), 6 blocks per arm, and (4), twice, after
that profiler session. Needs one card.
"""
import cProfile
import io
import json
import os
import pstats
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def per_call_us(fn, n=5000, reps=3):
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        best = min(best, (time.perf_counter() - t0) / n)
    return best * 1e6


def event_costs():
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    b.record()
    b.synchronize()
    from mxnet_tpu_torch.observability import perf

    stream = torch.cuda.current_stream()
    raw = perf.current_stream(0)
    scratch = perf.new_event()
    record_us = per_call_us(lambda: perf.record(scratch, raw))
    s_ev, e_ev = perf.event_pair()
    perf.record(s_ev, raw)
    perf.record(e_ev, raw)
    perf.synchronize(e_ev)
    return {"driver_record_us": record_us,
            "driver_elapsed_us": per_call_us(
                lambda: perf._span_ms(s_ev, e_ev)),
            "driver_query_us": per_call_us(lambda: perf.query(e_ev)),
            "raw_stream_us": per_call_us(lambda: perf.current_stream(0)),
            "record_us": per_call_us(a.record),
            "record_on_stream_us": per_call_us(lambda: a.record(stream)),
            "query_us": per_call_us(b.query),
            "synchronize_us": per_call_us(b.synchronize),
            "elapsed_time_us": per_call_us(lambda: a.elapsed_time(b)),
            "new_event_us": per_call_us(
                lambda: torch.cuda.Event(enable_timing=True))}


def perf_costs(mx):
    import chip_smoke as c
    from mxnet_tpu_torch.observability import perf

    mod = c.obs_mlp_module(mx, c.OBS_MLP_BS)
    rng = __import__("numpy").random.RandomState(0)
    batch = mx.io.DataBatch(
        data=[mx.nd.array(rng.rand(c.OBS_MLP_BS, 64).astype("float32"),
                          ctx=mx.gpu())],
        label=[mx.nd.array(rng.randint(0, 16, c.OBS_MLP_BS)
                           .astype("float32"), ctx=mx.gpu())])
    perf.step_begin()
    mod.forward_backward(batch)
    mod.update()
    perf.step_end()
    ex = mod._exec_group.execs[0]
    cost = ex.perf_program_cost(True)

    def full():
        perf.step_begin()
        stream = perf.current_stream(0)
        start, end = perf.event_pair()
        perf.record(start, stream)
        perf.record(end, stream)
        perf.note_program_events(ex.perf_program_cost(True), start, end,
                                 1e-6)
        perf.note_data_wait(1e-9)
        perf.note_kv(1e-9)
        perf.step_end()

    def scope_only():
        perf.step_begin()
        perf.note_data_wait(1e-9)
        perf.note_kv(1e-9)
        perf.step_end()

    def note_only():
        perf.note_program_run(cost, 1e-3, 1e-6)

    out = {"full_us": per_call_us(full),
           "scope_and_waterfall_us": per_call_us(scope_only),
           "note_program_run_us": per_call_us(note_only),
           "cost_lookup_us": per_call_us(lambda: ex.perf_program_cost(True))}
    perf.reset()
    return out


def _median(xs):
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


def health_costs(mx, rounds=12):
    """Phase 20 (b)'s microbench: ms/step with the health policy off, with
    the warn guard, and with a guard's launch alone, ``rounds``
    alternating blocks of 30 steps per arm (the arms' order rotating),
    medians and bests; the guard's host time piece by piece; the card's
    time for a step and for a guard, queued behind a sleep so no host gap
    enters it (and the host's time per call meanwhile: a call that waits
    for the card shows the sleep); Python's garbage collections per
    arm."""
    import gc

    import torch

    import chip_smoke as c
    from mxnet_tpu_torch.observability import flight_recorder, health

    tp, tok, tgt = c.obs_transformer(mx)
    step = tp.step_fn(lr=c.OBS_HEALTH_LR)
    params = tp.init(0)
    names = sorted(params)

    def named():
        return [(n, params[n]) for n in names]

    health.set_policy("warn")
    params, loss = step(params, tok, tgt)
    health.guard_step("bench.transformer", losses=[("loss", loss)],
                      params=named(), lr=c.OBS_HEALTH_LR, step=0)
    health.flush(allow_dump=False)

    pieces = {}

    def add(key, dt):
        pieces[key] = pieces.get(key, 0.0) + dt

    def guard(i, loss):
        health.guard_step("bench.transformer", losses=[("loss", loss)],
                          params=named(), lr=c.OBS_HEALTH_LR, step=i)

    def launch(i, loss):
        health._launch([("loss", loss)], (), named())

    def timed(i, loss):
        t0 = time.perf_counter()
        plan, datas = health._prepare([("loss", loss)], (), named())
        t1 = time.perf_counter()
        slot = plan.launch(datas)
        t2 = time.perf_counter()
        with health._lock:
            prev, health._pending = health._pending, (
                plan, slot, c.OBS_HEALTH_LR, i, "bench.transformer", None)
        if prev is not None:
            t3 = time.perf_counter()
            stats = prev[0].read(prev[1])
            t4 = time.perf_counter()
            v = health._evaluate(prev[0], stats, *prev[2:5])
            t5 = time.perf_counter()
            health._commit(v, None)
            t6 = time.perf_counter()
            add("read", t4 - t3)
            add("evaluate", t5 - t4)
            add("commit", t6 - t5)
        add("prepare", t1 - t0)
        add("launch", t2 - t1)

    arms = [("off", None), ("warn", guard), ("launch", launch),
            ("warn_timed", timed)]
    blocks = {name: [] for name, _f in arms}
    gcs = {name: [0, 0.0] for name, _f in arms}
    gc_t = [None, None]

    def on_gc(phase, info):
        if phase == "start":
            gc_t[0] = time.perf_counter()
        elif gc_t[1] is not None and gc_t[0] is not None:
            gcs[gc_t[1]][0] += 1
            gcs[gc_t[1]][1] += time.perf_counter() - gc_t[0]

    gc.callbacks.append(on_gc)
    try:
        for r in range(rounds):
            k = r % len(arms)
            for name, extra in arms[k:] + arms[:k]:
                health.flush(allow_dump=False)  # graftlint: disable=G001 — the last arm's stash, outside the timed block
                gc_t[1] = name
                t0 = time.perf_counter()
                for i in range(c.OBS_HEALTH_STEPS):
                    params, loss = step(params, tok, tgt)
                    if extra is not None:
                        extra(i, loss)
                float(loss)
                blocks[name].append((time.perf_counter() - t0)
                                    / c.OBS_HEALTH_STEPS * 1e3)
                gc_t[1] = None
        health.flush(allow_dump=False)

        # the card's own time: work queued behind a sleep, so the host
        # has enqueued all of it before the card reaches it
        def device_ms(fn, n):
            torch.cuda.synchronize()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(int(3e8))
            a.record()
            t0 = time.perf_counter()
            for i in range(n):
                fn(i)
            host = (time.perf_counter() - t0) / n * 1e3
            b.record()
            b.synchronize()
            return a.elapsed_time(b) / n, host

        def one_step(i):
            nonlocal params, loss
            params, loss = step(params, tok, tgt)

        dev = {"step": device_ms(one_step, 10),
               "guard_launch": device_ms(lambda i: launch(i, loss), 50)}
        prof = cProfile.Profile()
        prof.enable()
        for i in range(c.OBS_HEALTH_STEPS):
            params, loss = step(params, tok, tgt)
            guard(i, loss)  # graftlint: disable=G001 — the guard's per-step cost is what this profiles
        float(loss)
        prof.disable()
    finally:
        gc.callbacks.remove(on_gc)
        health.flush(allow_dump=False)
        health.set_policy(None)
        flight_recorder.reset()
    text = io.StringIO()
    pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(20)
    n_timed = len(blocks["warn_timed"]) * c.OBS_HEALTH_STEPS
    off = _median(blocks["off"])
    out = {name: {"median": _median(v), "best": min(v),
                  "median_pct_over_off": 100.0 * (_median(v) - off) / off,
                  "gc": gcs[name]}
           for name, v in blocks.items()}
    out["blocks"] = blocks
    out["pieces_us"] = {k: v / n_timed * 1e6 for k, v in pieces.items()}
    out["device_ms_and_host_ms"] = dev
    return out, text.getvalue()


def smoke_gates(mx, repeats, variants=((10, 36), (30, 12))):
    """``chip_smoke.py`` phase 20 (a)'s gated measurement and (b)'s under
    each (steps a block, pairs) of ``variants``, ``repeats`` times each in
    this process: how far the gates' readings spread on one card in one
    call (a failed gate is recorded, not raised)."""
    import chip_smoke as c

    card = c.nvidia_smi()
    runs = {"a": []}
    runs.update({"b_%dx%d" % v: [] for v in variants})
    saved = c.OBS_HEALTH_STEPS, c.OBS_HEALTH_BLOCKS
    try:
        for _ in range(repeats):
            jobs = [("a", c.obs_perf_overhead, None)] + [
                ("b_%dx%d" % v, c.obs_health_overhead, v) for v in variants]
            for key, fn, v in jobs:
                if v is not None:
                    c.OBS_HEALTH_STEPS, c.OBS_HEALTH_BLOCKS = v
                out = {}
                try:
                    fn(mx, card, out)
                    failed = None
                except AssertionError as e:
                    failed = str(e)
                got = out.get(key[0], {})
                runs[key].append({k: got.get(k) for k in (
                    "overhead_pct", "medians_pct", "per_step_cost_us",
                    "step_ms", "off_ms_per_step", "warn_ms_per_step",
                    "pair_pcts")} | {"failed": failed})
    finally:
        c.OBS_HEALTH_STEPS, c.OBS_HEALTH_BLOCKS = saved
    return runs


def guard_kernels(mx):
    """Kernels and copies one warn guard puts on the card, by
    torch.profiler (a fresh session in this process)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as c
    from mxnet_tpu_torch.observability import health

    tp, _tok, _tgt = c.obs_transformer(mx)
    params = tp.init(0)
    named = [(n, params[n]) for n in sorted(params)]
    loss = torch.ones(1, device="cuda")
    health.check(losses=[("loss", loss)], params=named)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        health._launch([("loss", loss)], (), named)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    names = [e.name for e in prof.events() if e.device_type == cuda]
    copies = sum(1 for n in names if "memcpy" in n.lower()
                 or "memset" in n.lower())
    return {"kernels": len(names) - copies, "copies": copies,
            "tensors": len(named) + 1, "names": sorted(set(names))}


def main():
    import torch

    if not torch.cuda.is_available():
        print("port_obs_cost: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as c
    import mxnet_tpu_torch as mx

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {"card": c.nvidia_smi(), "events": event_costs(),
           "perf": perf_costs(mx)}
    res["health"], text = health_costs(mx)
    c.log(text)
    res["smoke_gates"] = smoke_gates(mx, 3)
    res["guard_kernels"] = guard_kernels(mx)
    # the same after a torch.profiler session with CUDA activity, as the
    # whole smoke script runs phase 20 (b)
    res["health_after_profiler"], _text = health_costs(mx, rounds=6)
    res["smoke_gates_after_profiler"] = smoke_gates(mx, 2)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "obs_cost.json"), "w") as f:
        json.dump(res, f, indent=1)
    for k in ("events", "perf", "guard_kernels", "smoke_gates",
              "smoke_gates_after_profiler"):
        c.log(json.dumps({k: res[k]}))
    for k in ("health", "health_after_profiler"):
        c.log(json.dumps({k: {a: v for a, v in res[k].items()
                              if a != "blocks"}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
