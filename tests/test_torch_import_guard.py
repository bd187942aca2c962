"""The port stands alone: importing mxnet_tpu_torch loads neither jax nor
the JAX package (nor the CUDA driver or NVRTC), and no source of the port
(or chip_smoke.py) names them."""
import os
import re
import subprocess
import sys

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

_PROBE = """
import sys
import mxnet_tpu_torch as mx
import mxnet_tpu_torch.serving, mxnet_tpu_torch.graph_pass
import mxnet_tpu_torch.serving.generation, mxnet_tpu_torch.serving.control
import mxnet_tpu_torch.parallel.transformer
import mxnet_tpu_torch.parallel.flash_attention
import mxnet_tpu_torch.module, mxnet_tpu_torch.ndarray
import mxnet_tpu_torch.optimizer
import mxnet_tpu_torch.rtc, mxnet_tpu_torch.nvrtc, mxnet_tpu_torch.operator
import mxnet_tpu_torch.autograd, mxnet_tpu_torch.test_utils
import mxnet_tpu_torch.models.lenet, mxnet_tpu_torch.models.mlp
import mxnet_tpu_torch.random, mxnet_tpu_torch.ndarray.random
import mxnet_tpu_torch.cuda_graph
import mxnet_tpu_torch.ops.indexing, mxnet_tpu_torch.ops.random_ops
import mxnet_tpu_torch.gluon, mxnet_tpu_torch.gluon.nn
import mxnet_tpu_torch.gluon.loss, mxnet_tpu_torch.gluon.trainer
import mxnet_tpu_torch.gluon.model_zoo.vision, mxnet_tpu_torch.gluon.data
import mxnet_tpu_torch.gluon.utils, mxnet_tpu_torch.gluon.parameter
import mxnet_tpu_torch.ops.rnn, mxnet_tpu_torch.rnn
import mxnet_tpu_torch.module.bucketing_module
import mxnet_tpu_torch.gluon.rnn, mxnet_tpu_torch.gluon.contrib.rnn
import mxnet_tpu_torch.observability.metrics
import mxnet_tpu_torch.observability.request_trace
import mxnet_tpu_torch.observability.flight_recorder
import mxnet_tpu_torch.observability.stats_schema
import mxnet_tpu_torch.observability.perf
import mxnet_tpu_torch.profiler
import mxnet_tpu_torch.observability.tracing
import mxnet_tpu_torch.observability.instruments
import mxnet_tpu_torch.observability.health
import mxnet_tpu_torch.observability.exposition
import mxnet_tpu_torch.observability.fleet
import mxnet_tpu_torch.resilience.faults, mxnet_tpu_torch.runtime.staging
import mxnet_tpu_torch.autotune.cache, mxnet_tpu_torch.autotune.registry
import mxnet_tpu_torch.autotune.cost_model, mxnet_tpu_torch.serving.buckets
import mxnet_tpu_torch.autotune.search, mxnet_tpu_torch.autotune.learned
import mxnet_tpu_torch.autotune.tuners, mxnet_tpu_torch.parallel.fused
import mxnet_tpu_torch.executor, mxnet_tpu_torch.runtime.pipeline
import mxnet_tpu_torch.serving.engine, mxnet_tpu_torch.parallel.mesh
import mxnet_tpu_torch.resilience.retry, mxnet_tpu_torch.resilience.checkpoint
import mxnet_tpu_torch.resilience.preemption, mxnet_tpu_torch.graft_entry
import mxnet_tpu_torch.module.python_module
import mxnet_tpu_torch.module.sequential_module
import mxnet_tpu_torch.executor_manager, mxnet_tpu_torch.visualization
import mxnet_tpu_torch.contrib.autograd, mxnet_tpu_torch.contrib.tensorboard
import mxnet_tpu_torch.attribute, mxnet_tpu_torch.name
import mxnet_tpu_torch.registry, mxnet_tpu_torch.fluent
import mxnet_tpu_torch.engine, mxnet_tpu_torch.storage, mxnet_tpu_torch.log
import mxnet_tpu_torch.libinfo, mxnet_tpu_torch.symbol_doc
bad = sorted(m for m in sys.modules
             if m in ("jax", "mxnet_tpu") or m.startswith("jax.")
             or m.startswith("mxnet_tpu."))
# nor the CUDA driver or NVRTC: mx.rtc loads them at its first use
with open("/proc/self/maps") as f:
    bad += sorted({line.split()[-1].rsplit("/", 1)[-1] for line in f
                   if "libcuda.so" in line or "libnvrtc" in line})
print(",".join(bad))
"""


def test_import_loads_no_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=_REPO,
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", out.stdout


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+mxnet_tpu\b(?!_torch)"
    r"|from\s+mxnet_tpu\b(?!_torch))|\bmxnet_tpu\.(?!\w*_torch)\w",
    re.MULTILINE)


def _sources():
    pkg = os.path.join(_REPO, "mxnet_tpu_torch")
    for root, _dirs, files in os.walk(pkg):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                yield os.path.join(root, f)
    yield os.path.join(_REPO, "chip_smoke.py")


def test_sources_name_no_jax():
    offenders = []
    for path in _sources():
        with open(path) as f:
            text = f.read()
        # prose may name the reference package by path (mxnet_tpu/...),
        # code may not import it
        for m in _FORBIDDEN.finditer(text):
            offenders.append("%s: %r" % (os.path.relpath(path, _REPO),
                                         m.group(0)))
    assert not offenders, offenders
