"""Port parity for the streaming input pipeline (``runtime/pipeline.py``,
``runtime/source.py``): ``StreamingIter`` against the synchronous
``ImageIter`` path and against the JAX package's ``StreamingIter``, bit for
bit, with the trailing short batch under both ``last_batch_handle``
values, on the thread and the process (forkserver) decode backends;
``shard_partition`` and ``RecordFileSource`` states, resumed across
packages; ``close()`` idempotent with no thread, process or shared-memory
segment left; two pipelines at once; the ``io.*`` metrics.

Every wait in this file has its own timeout (:func:`within`), so a
deadlocked pipeline fails its test instead of hanging the run.
"""
import gc
import json
import os
import threading
import time
import weakref

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.runtime import (RecordFileSource, StreamingIter,
                                     shard_partition)
from mxnet_tpu_torch.runtime import pipeline as tpipe

LIMIT_S = 60.0


def within(fn, *args, limit=LIMIT_S):
    """fn(*args) on a daemon thread, joined with a timeout: a hang fails
    the test (the thread is left behind) instead of blocking the run."""
    box = {}

    def run():
        try:
            box["value"] = fn(*args)
        except BaseException as err:   # re-raised on the test's thread
            box["error"] = err

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(limit)
    if t.is_alive():
        raise AssertionError("%s did not finish within %.0f s"
                             % (getattr(fn, "__name__", fn), limit))
    if "error" in box:
        raise box["error"]
    return box.get("value")


def make_rec(tmp_path, n=23, size=14, name="data"):
    rng = np.random.RandomState(0)
    rec, idx = str(tmp_path / (name + ".rec")), str(tmp_path / (name + ".idx"))
    w = tmx.recordio.MXIndexedRecordIO(idx, rec, "w")
    for i in range(n):
        img = rng.randint(0, 255, (size, size + 2, 3)).astype(np.uint8)
        w.write_idx(i, tmx.recordio.pack_img(
            tmx.recordio.IRHeader(0, float(i), i, 0), img, quality=90))
    w.close()
    return rec, idx


def collect(it, epochs=2):
    out = []
    for e in range(epochs):
        if e:
            it.reset()
        for b in it:
            out.append((b.data[0].asnumpy(), b.label[0].asnumpy(),
                        int(b.pad or 0)))
    return out


def assert_same(got, want):
    assert len(got) == len(want)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        assert gp == wp
        assert gd.dtype == wd.dtype and gl.dtype == wl.dtype
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)


def streaming(rec, idx, **kw):
    args = dict(path_imgrec=rec, path_imgidx=idx, data_shape=(3, 12, 12),
                batch_size=5, decode_workers=2, device=tmx.cpu())
    args.update(kw)
    return within(lambda: StreamingIter(**args))


def drain(it, epochs=2):
    try:
        return within(collect, it, epochs)
    finally:
        within(it.close)


@pytest.mark.parametrize("backend", ["thread", "process"])
@pytest.mark.parametrize("handle", ["pad", "discard"])
def test_streaming_matches_sync_and_the_jax_pipeline(tmp_path, backend,
                                                     handle):
    rec, idx = make_rec(tmp_path)
    kw = dict(shuffle=True, seed=3, last_batch_handle=handle)
    it = streaming(rec, idx, decode_backend=backend, **kw)
    assert it.decode_backend == backend
    got = drain(it)
    sync = tmx.image.ImageIter(batch_size=5, data_shape=(3, 12, 12),
                               path_imgrec=rec, path_imgidx=idx,
                               device=tmx.cpu(), **kw)
    assert_same(got, collect(sync))
    ref = jmx.runtime.StreamingIter(
        path_imgrec=rec, path_imgidx=idx, data_shape=(3, 12, 12),
        batch_size=5, decode_workers=2, decode_backend="thread", **kw)
    want = within(collect, ref)
    within(ref.close)
    assert_same(got, want)
    assert got[-1][2] == (2 if handle == "pad" else 0)
    assert len(got) == (10 if handle == "pad" else 8)


def test_streaming_with_normalizing_augmenters(tmp_path):
    rec, idx = make_rec(tmp_path, n=12)
    kw = dict(resize=13, mean=np.array([120.0, 110.0, 100.0]),
              std=np.array([50.0, 51.0, 52.0]), label_width=2)
    got = drain(streaming(rec, idx, decode_backend="process", **kw))
    ref = jmx.runtime.StreamingIter(
        path_imgrec=rec, path_imgidx=idx, data_shape=(3, 12, 12),
        batch_size=5, decode_workers=2, decode_backend="thread", **kw)
    assert_same(got, within(collect, ref))
    within(ref.close)


def test_shard_partition_and_sources_agree_with_the_jax_package(tmp_path):
    for n, parts in ((23, 3), (7, 7), (5, 2), (100, 9), (3, 5)):
        cuts = [shard_partition(n, parts, p) for p in range(parts)]
        assert cuts == [jmx.runtime.shard_partition(n, parts, p)
                        for p in range(parts)]
        keys = [k for lo, hi in cuts for k in range(lo, hi)]
        assert keys == list(range(n))
    with pytest.raises(tmx.MXNetError):
        shard_partition(5, 0, 0)
    with pytest.raises(tmx.MXNetError):
        shard_partition(5, 2, 2)
    rec, idx = make_rec(tmp_path)
    for part in range(3):
        t = RecordFileSource(rec, idx, num_parts=3, part_index=part,
                             shuffle=True, seed=8)
        j = jmx.runtime.RecordFileSource(rec, idx, num_parts=3,
                                         part_index=part, shuffle=True,
                                         seed=8)
        for _ in range(3):
            assert t.epoch_order() == j.epoch_order()
            assert t.get_state() == j.get_state()
            t.reset()
            j.reset()
        t.close()
        j.close()
    with pytest.raises(tmx.MXNetError, match=".idx"):
        RecordFileSource(str(tmp_path / "none.rec"))


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_source_state_resumes_across_packages(tmp_path, writer):
    rec, idx = make_rec(tmp_path)
    pkg = tmx if writer == "torch" else jmx
    src = pkg.runtime.RecordFileSource(rec, idx, shuffle=True, seed=4)
    src.reset()
    for _ in range(5):
        src.read()
    state = json.loads(json.dumps(src.get_state()))
    rest = []
    while True:
        try:
            rest.append(src.read()[0])
        except StopIteration:
            break
    src.reset()
    rest += [src.read()[0] for _ in range(len(src))]
    for target in (tmx, jmx):
        dst = target.runtime.RecordFileSource(rec, idx, shuffle=True, seed=99)
        dst.set_state(state)
        got = []
        while True:
            try:
                got.append(dst.read()[0])
            except StopIteration:
                break
        dst.reset()
        got += [dst.read()[0] for _ in range(len(dst))]
        assert got == rest
        dst.close()
    other = RecordFileSource(rec, idx, num_parts=2, part_index=0)
    with pytest.raises(tmx.MXNetError, match="does not match"):
        other.set_state(state)


def test_streaming_state_resumes_mid_epoch_and_across_packages(tmp_path):
    rec, idx = make_rec(tmp_path)
    kw = dict(shuffle=True, seed=6, decode_backend="thread")
    whole = drain(streaming(rec, idx, **kw), epochs=2)
    it = streaming(rec, idx, **kw)
    within(it.next)
    within(it.next)
    state = json.loads(json.dumps(it.get_state()))
    within(it.close)
    for pkg in ("torch", "jax"):
        if pkg == "torch":
            dst = streaming(rec, idx, **dict(kw, seed=1))
        else:
            dst = jmx.runtime.StreamingIter(
                path_imgrec=rec, path_imgidx=idx, data_shape=(3, 12, 12),
                batch_size=5, decode_workers=2, shuffle=True, seed=1,
                decode_backend="thread")
        within(dst.set_state, state)
        rest = within(collect, dst, 1)
        dst.reset()
        rest += within(collect, dst, 1)
        within(dst.close)
        assert_same(rest, whole[2:])
    it = streaming(rec, idx, **kw)
    it.skip_batches(3)
    assert_same(within(collect, it, 1), whole[3:5])
    within(it.close)


def test_decode_backend_resolution(monkeypatch):
    assert tpipe.resolve_decode_backend("thread") == "thread"
    assert tpipe.resolve_decode_backend(None) == "process"
    monkeypatch.setenv("MXNET_IO_DECODE_BACKEND", "thread")
    assert tpipe.resolve_decode_backend(None) == "thread"
    assert tpipe.resolve_decode_backend("process") == "process"
    with pytest.raises(tmx.MXNetError):
        tpipe.resolve_decode_backend("fork")
    import multiprocessing as mp

    monkeypatch.setattr(mp, "get_all_start_methods", lambda: ["spawn"])
    with pytest.raises(tmx.MXNetError, match="forkserver"):
        tpipe.resolve_decode_backend("process")
    monkeypatch.delenv("MXNET_IO_DECODE_BACKEND")
    assert tpipe.resolve_decode_backend(None) == "thread"


def test_process_backend_raises_on_an_unpicklable_chain(tmp_path):
    rec, idx = make_rec(tmp_path, n=6)
    chain = [tmx.image.CenterCropAug((12, 12)),
             lambda im: im.astype(np.float32)]
    with pytest.raises(tmx.MXNetError, match="pickle"):
        streaming(rec, idx, decode_backend="process", aug_list=chain)
    it = streaming(rec, idx, decode_backend="thread", aug_list=chain)
    assert len(drain(it, 1)) == 2


def test_worker_counts_consult_the_tuning_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("MXNET_TUNE_CACHE", str(tmp_path / "tune.json"))
    tmx.autotune.reload()
    try:
        key = tpipe.io_pipeline_key(5, (3, 12, 12))
        assert key == jmx.runtime.io_pipeline_key(5, (3, 12, 12))
        assert tpipe.resolve_decode_workers(3, 5, (3, 12, 12)) == 3
        monkeypatch.setenv("MXNET_IO_DECODE_WORKERS", "5")
        assert tpipe.resolve_decode_workers(None, 5, (3, 12, 12)) == 5
        assert tpipe.resolve_prefetch_depth(None, 5, (3, 12, 12)) == 2
        tmx.autotune.record("io.decode_workers", key, {"workers": 6})
        tmx.autotune.record("io.prefetch_depth", key, {"depth": 4})
        assert tpipe.resolve_decode_workers(None, 5, (3, 12, 12)) == 6
        assert tpipe.resolve_prefetch_depth(None, 5, (3, 12, 12)) == 4
    finally:
        monkeypatch.delenv("MXNET_TUNE_CACHE")
        tmx.autotune.reload()


def alive(pid):
    try:
        with open("/proc/%d/stat" % pid) as f:
            return f.read().split(")")[-1].split()[0] != "Z"
    except OSError:
        return False


def pipeline_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("mxnet-io") or "QueueManager" in t.name
            or "ExecutorManager" in t.name]


@pytest.mark.parametrize("backend", ["thread", "process"])
def test_close_is_idempotent_and_leaves_nothing(tmp_path, backend):
    rec, idx = make_rec(tmp_path, n=12)
    before = set(threading.enumerate())
    it = streaming(rec, idx, decode_backend=backend, decode_workers=3)
    pids = [p.pid for p in getattr(it._pool, "_processes", {}).values()]
    assert len(pids) == (3 if backend == "process" else 0)
    segments = []
    within(lambda: [segments.extend(s.name for s in it._shm._all)
                    if it._shm else None for _ in it])
    within(it.close)
    within(it.close)
    with pytest.raises(tmx.MXNetError):
        it.reset()
    with pytest.raises(tmx.MXNetError):
        it.next()
    with pytest.raises(tmx.MXNetError):
        it.skip_batches(1)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and (
            any(alive(p) for p in pids)
            or [t for t in threading.enumerate()
                if t not in before and t.is_alive()]):
        time.sleep(0.05)
    assert not [p for p in pids if alive(p)]
    assert not [t for t in threading.enumerate()
                if t not in before and t.is_alive()]
    assert not [s for s in segments if os.path.exists("/dev/shm/" + s)]


def test_abandoned_streaming_iter_is_collectable(tmp_path):
    rec, idx = make_rec(tmp_path, n=40)
    before = set(threading.enumerate())
    it = streaming(rec, idx, decode_backend="thread", batch_size=4,
                   prefetch_depth=1)
    within(it.next)
    time.sleep(0.3)                 # the feeder parks on a full queue
    ref = weakref.ref(it)
    del it
    for _ in range(100):
        gc.collect()
        if ref() is None:
            break
        time.sleep(0.05)
    assert ref() is None
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and [
            t for t in threading.enumerate()
            if t not in before and t.is_alive()]:
        time.sleep(0.05)
    assert not [t for t in threading.enumerate()
                if t not in before and t.is_alive()]


def test_two_concurrent_streaming_iters(tmp_path):
    # the train + val pattern: the second pipeline's workers start while
    # the first's feeder, executor and worker processes are live
    rec, idx = make_rec(tmp_path, n=32)
    a = streaming(rec, idx, batch_size=8, decode_backend="process")
    within(a.next)
    b = streaming(rec, idx, batch_size=8, decode_backend="process")
    try:
        assert within(lambda: 1 + sum(1 for _ in a)) == 4
        assert within(lambda: sum(1 for _ in b)) == 4
        a.reset()
        b.reset()
        assert within(lambda: sum(1 for _ in a) + sum(1 for _ in b)) == 8
    finally:
        within(a.close)
        within(b.close)


def test_io_metrics_and_stats(tmp_path):
    from mxnet_tpu_torch.observability import metrics

    rec, idx = make_rec(tmp_path, n=12)
    was = metrics.enabled()
    metrics.set_enabled(True)
    try:
        b0 = metrics.get_value("io.batches", 0)
        it = streaming(rec, idx, decode_backend="thread")
        within(collect, it, 1)
        stats = it.get_stats()
        within(it.close)
        assert metrics.get_value("io.batches", 0) - b0 == 3
        text = metrics.dump_metrics()
        for name in ("io_decode_ms", "io_stage_ms", "io_queue_depth",
                     "io_consumer_wait_ms", "io_assemble_ms", "io_rows"):
            assert name in text, name
    finally:
        metrics.set_enabled(was)
    assert stats["batches"] == 3 and stats["rows"] == 12
    assert stats["decode_backend"] == "thread"
    assert set(stats["stages"]) == {"read", "decode", "assemble",
                                    "backpressure", "stage", "consumer"}
    assert stats["verdict"] in ("input-bound", "compute-bound")


def test_unguarded_main_script_gets_a_clear_error(tmp_path):
    """Each decode process imports the main script again (forkserver, as
    under spawn): a script that builds the pipeline at import, outside an
    ``if __name__ == "__main__":`` guard, gets an MXNetError naming the
    guard instead of a broken pool."""
    import subprocess
    import sys

    rec, idx = make_rec(tmp_path, n=4)
    script = tmp_path / "unguarded.py"
    script.write_text(
        "import sys\n"
        "sys.path.insert(0, %r)\n"
        "import mxnet_tpu_torch as mx\n"
        "try:\n"
        "    mx.io.StreamingIter(path_imgrec=%r, path_imgidx=%r,\n"
        "                        data_shape=(3, 12, 12), batch_size=2,\n"
        "                        decode_workers=2, device=mx.cpu())\n"
        "except mx.MXNetError as err:\n"
        "    print('MXNetError:', err)\n"
        % (os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
           rec, idx))
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=180, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-2000:]
    assert "MXNetError: the decode processes did not start" in out.stdout
    assert '__name__ == "__main__"' in out.stdout
