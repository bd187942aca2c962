"""Port parity for ``gluon.data`` (datasets, samplers, the DataLoader) and
the Gluon MNIST example on the port.

The loaders of both packages are driven on the same arrays under the same
``np.random`` seed: the batches are equal to the bit, in order, for every
``last_batch`` policy, shuffled or not, with thread and process workers.
``examples/gluon/mnist_gluon.py`` runs on the port with only its import
line changed (``mxnet_tpu`` -> ``mxnet_tpu_torch``), inside
``with mx.cpu():``, imperative and hybridized, and passes its own smoke bar
(train accuracy > 0.8). A process worker that dies makes the loader
raise within seconds (a subprocess under a timeout holds the case).
"""
import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _batches(mx, loader_kw, seed=0, n=23):
    rng = np.random.RandomState(1)
    x = rng.rand(n, 3).astype(np.float32)
    y = np.arange(n).astype(np.float32)
    ds = mx.gluon.data.ArrayDataset(x, y)
    np.random.seed(seed)
    out = []
    for epoch in range(2):
        for data, label in mx.gluon.data.DataLoader(ds, **loader_kw):
            out.append((data.asnumpy(), label.asnumpy()))
    return out


@pytest.mark.parametrize("kw", [
    dict(batch_size=5), dict(batch_size=5, last_batch="discard"),
    dict(batch_size=5, last_batch="rollover"),
    dict(batch_size=4, shuffle=True),
    dict(batch_size=6, shuffle=True, last_batch="discard"),
    dict(batch_size=5, num_workers=2),
    dict(batch_size=5, shuffle=True, num_workers=3)],
    ids=lambda kw: "-".join("%s=%s" % i for i in sorted(kw.items())))
def test_dataloader_batches_match_the_jax_package(kw):
    want = _batches(jmx, kw)
    with tmx.cpu():
        got = _batches(tmx, kw)
    assert len(got) == len(want)
    for (gd, gl), (wd, wl) in zip(got, want):
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)
        assert gd.dtype == wd.dtype and gl.dtype == wl.dtype


def test_datasets_and_transforms():
    x = np.random.RandomState(0).rand(10, 3).astype(np.float32)
    with tmx.cpu():
        nd_labels = tmx.nd.array(np.arange(10))
        ds = tmx.gluon.data.ArrayDataset(x, nd_labels)
        assert len(ds) == 10
        np.testing.assert_array_equal(ds[3][0], x[3])
        assert ds[3][1] == 3
        single = tmx.gluon.data.ArrayDataset(x)
        np.testing.assert_array_equal(single[2], x[2])
        simple = tmx.gluon.data.SimpleDataset(list(range(5)))
        assert simple.transform(lambda v: v * 2)[2] == 4
        eager = simple.transform(lambda v: v + 1, lazy=False)
        assert isinstance(eager, tmx.gluon.data.SimpleDataset)
        assert [eager[i] for i in range(5)] == [1, 2, 3, 4, 5]
        first = ds.transform_first(lambda v: v * 10)
        np.testing.assert_allclose(first[1][0], x[1] * 10)
        assert first[1][1] == 1
    with pytest.raises(AssertionError):
        tmx.gluon.data.ArrayDataset(x, np.arange(3))


def test_samplers_match_the_jax_package():
    for kind in ("keep", "discard", "rollover"):
        runs = []
        for mx in (jmx, tmx):
            np.random.seed(4)
            d = mx.gluon.data
            bs = d.BatchSampler(d.RandomSampler(11), 4, kind)
            runs.append((list(bs) + list(bs), len(bs)))
        assert [list(map(int, b)) for b in runs[0][0]] == \
            [list(map(int, b)) for b in runs[1][0]]
        assert runs[0][1] == runs[1][1]
    assert list(tmx.gluon.data.SequentialSampler(4)) == [0, 1, 2, 3]
    with pytest.raises(ValueError):
        tmx.gluon.data.BatchSampler(tmx.gluon.data.SequentialSampler(3), 2,
                                    "bogus")
    with pytest.raises(ValueError):
        tmx.gluon.data.DataLoader([1, 2], batch_size=1, shuffle=True,
                                  sampler=tmx.gluon.data.SequentialSampler(2))


def test_dataloader_process_workers_and_custom_batchify():
    data = [(np.full((2, 2), i, np.float32), np.float32(i % 3))
            for i in range(17)]
    with tmx.cpu():
        loader = tmx.gluon.data.DataLoader(data, batch_size=4, num_workers=2,
                                           thread_pool=False)
        seen = []
        for x, y in loader:
            assert x.context == tmx.cpu()
            np.testing.assert_allclose(y.asnumpy(), x.asnumpy()[:, 0, 0] % 3)
            seen.extend(x.asnumpy()[:, 0, 0].tolist())
        assert seen == list(range(17))

        ragged = [np.full((i + 1,), i, np.float32) for i in range(6)]

        def pad(samples):
            width = max(len(s) for s in samples)
            out = np.zeros((len(samples), width), np.float32)
            for i, s in enumerate(samples):
                out[i, :len(s)] = s
            return tmx.nd.array(out)

        batches = list(tmx.gluon.data.DataLoader(
            ragged, batch_size=3, num_workers=2, thread_pool=False,
            batchify_fn=pad))
    assert [b.shape for b in batches] == [(3, 3), (3, 6)]


_LOADER_SCRIPT = """
import multiprocessing as mp
import os
import sys
import time
from concurrent.futures.process import BrokenProcessPool

sys.path.insert(0, %(repo)r)
import mxnet_tpu_torch as mx


class Dying:
    \"\"\"Sample 5 kills the worker that loads it.\"\"\"

    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 5:
            os._exit(3)
        return float(i)


def pids(loader):
    return sorted(p.pid for p in loader._pool._processes.values())


if __name__ == "__main__":
    with mx.cpu():
        # workers stay up across epochs; close() / the with block ends them
        with mx.gluon.data.DataLoader(list(range(6)), batch_size=2,
                                      num_workers=2,
                                      thread_pool=False) as loader:
            first = [b.asnumpy().tolist() for b in loader]
            up = pids(loader)
            second = [b.asnumpy().tolist() for b in loader]
            assert first == second == [[0, 1], [2, 3], [4, 5]], first
            assert pids(loader) == up and len(up) == 2
            it = iter(loader)
            next(it)
            it.close()              # an abandoned epoch shuts them down
            assert loader._pool is None and not mp.active_children()
            assert [b.asnumpy().tolist() for b in loader] == first
        assert loader._pool is None and not mp.active_children()
        print("LIFECYCLE_OK")
        loader = mx.gluon.data.DataLoader(Dying(), batch_size=2,
                                          num_workers=2, thread_pool=False)
        t0 = time.perf_counter()
        try:
            for _ in loader:
                pass
        except BrokenProcessPool:
            print("RAISED %%.3f" %% (time.perf_counter() - t0))
        assert loader._pool is None and not mp.active_children()
"""


def test_dataloader_worker_death_raises_instead_of_hanging(tmp_path):
    """A worker process that dies (``os._exit`` in ``__getitem__``) makes
    the loader raise ``BrokenProcessPool`` within seconds and shut its
    pool down; workers stay up across epochs and are shut down by
    ``close()`` (here the ``with`` block) or an abandoned epoch. The
    script runs in its own process under a 120 s timeout, so a hang fails
    the test instead of holding the run."""
    script = tmp_path / "loader_death.py"
    script.write_text(_LOADER_SCRIPT % {"repo": _REPO})
    out = subprocess.run([sys.executable, str(script)], cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert "LIFECYCLE_OK" in lines
    raised = [float(x.split()[1]) for x in lines if x.startswith("RAISED")]
    assert len(raised) == 1 and raised[0] < 30, out.stdout


def _example_source():
    with open(os.path.join(_REPO, "examples", "gluon", "mnist_gluon.py")) as f:
        src = f.read()
    assert src.count("import mxnet_tpu as mx") == 1
    src = src.replace("import mxnet_tpu as mx", "import mxnet_tpu_torch as mx")
    return src.replace("from mxnet_tpu import autograd, gluon",
                       "from mxnet_tpu_torch import autograd, gluon") \
        .replace("from mxnet_tpu.gluon import nn",
                 "from mxnet_tpu_torch.gluon import nn")


@pytest.mark.parametrize("hybridize", [False, True],
                         ids=["imperative", "hybridized"])
def test_mnist_gluon_example_runs_on_the_port(hybridize, monkeypatch):
    code = compile(_example_source(), "mnist_gluon.py", "exec")
    scope = {"__name__": "mnist_gluon", "__file__": os.path.join(
        _REPO, "examples", "gluon", "mnist_gluon.py")}
    exec(code, scope)
    assert scope["mx"] is tmx
    monkeypatch.setattr(sys, "argv", ["mnist_gluon.py", "--smoke"]
                        + (["--hybridize"] if hybridize else []))
    out = io.StringIO()
    with tmx.cpu(), contextlib.redirect_stdout(out):
        scope["main"]()      # asserts train accuracy > 0.8 itself
    acc = float(out.getvalue().strip().splitlines()[-1].split()[-1])
    assert acc > 0.8
