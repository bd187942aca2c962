"""Port parity: the public names of ``mx``, ``mx.sym``, ``mx.nd`` and
``mx.base`` against mxnet_tpu's. Every name of the JAX package's modules
exists in the port, or is on the explicit list of what is still unported
(ROADMAP.md Queue A) below. The lists may only shrink: a name that the
port gains must leave its list, or the test fails.

The names are listed by a fresh process per package: in a test process,
other tests' imports add submodules to a package's namespace.
"""
import functools
import json
import os
import subprocess
import sys

import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

# modules and classes of ``mx`` not ported yet
MX_UNPORTED = frozenset({
    "Monitor", "NotImplementedForSymbol", "attribute", "autotune",
    "contrib", "engine", "executor_manager", "fluent", "image", "img",
    "kvstore_server", "libinfo", "log", "mon", "monitor", "name",
    "observability", "profiler", "recordio", "registry", "resilience",
    "runtime", "storage", "visualization", "viz"
})

# ops of the registry not ported yet (both ``mx.sym`` and ``mx.nd``)
OPS_UNPORTED = frozenset({
    "BatchNorm_v1", "BilinearSampler", "Convolution_v1", "Correlation",
    "Correlation1D", "Crop", "GridGenerator",
    "IdentityAttachKLSparseReg", "InstanceNorm", "L2Normalization", "LRN",
    "LSoftmax", "LinearRegressionOutput", "LogisticRegressionOutput",
    "MAERegressionOutput", "MultiLogistic", "Pooling_v1",
    "ROIPooling", "SCN", "SPN", "SVMOutput", "SequenceLast", "SequenceMask",
    "SequenceReverse", "SpatialTransformer", "UpSampling", "WeightedL1",
    "arange", "cast_storage", "contrib", "contrib_ctc_loss", "ctc_loss",
    "linalg_gelqf", "linalg_gemm", "linalg_gemm2", "linalg_potrf",
    "linalg_potri", "linalg_sumlogdiag", "linalg_syevd", "linalg_syrk",
    "linalg_trmm", "linalg_trsm", "nAvg"
})

# beyond the ops: ``mx.sym`` only, ``mx.nd`` only
SYM_UNPORTED = frozenset({

})
ND_UNPORTED = frozenset({
    "BaseSparseNDArray", "CSRNDArray", "RowSparseNDArray", "moveaxis",
    "sparse", "sparse_retain", "square_sum"
})

UNPORTED = {"": MX_UNPORTED, "sym": OPS_UNPORTED | SYM_UNPORTED,
            "nd": OPS_UNPORTED | ND_UNPORTED, "base": frozenset()}

# the names this slice added, each of which the JAX package has
ADDED = {"": ("Context", "current_context", "num_gpus", "tpu", "cpu_pinned",
              "Symbol", "Executor", "opt", "Prefix", "cpu", "gpu"),
         "sym": ("zeros", "ones"), "nd": (), "base": ("Prefix",)}


_LIST = """
import importlib, json, sys
mx = importlib.import_module(sys.argv[1])
print(json.dumps({name: sorted(n for n in dir(getattr(mx, name) if name
                                               else mx)
                               if not n.startswith("_"))
                  for name in ("", "sym", "nd", "base")}))
"""


@functools.lru_cache(maxsize=None)
def _public(package):
    """{module name: its public names}, as a fresh import sees them."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _LIST, package], cwd=root,
                         capture_output=True, text=True, check=True,
                         timeout=300).stdout
    return {k: set(v) for k, v in json.loads(out.splitlines()[-1]).items()}


def _module(mx, name):
    return getattr(mx, name) if name else mx


@pytest.mark.parametrize("name", ["", "sym", "nd", "base"])
def test_public_names_match_the_reference_but_the_unported(name):
    ref, port = _module(jmx, name), _module(tmx, name)
    missing = _public("mxnet_tpu")[name] - _public("mxnet_tpu_torch")[name]
    assert missing == UNPORTED[name], (
        "gained (take off the list): %s; lost: %s"
        % (sorted(UNPORTED[name] - missing),
           sorted(missing - UNPORTED[name])))
    for n in ADDED[name]:
        assert hasattr(ref, n) and hasattr(port, n), n


def test_exported_names_are_the_modules_own():
    assert tmx.Symbol is tmx.sym.Symbol
    assert tmx.Executor is tmx.executor.Executor
    assert tmx.opt is tmx.optimizer
    assert tmx.Prefix is tmx.base.Prefix
    assert tmx.Context is tmx.context.Context
    assert isinstance(tmx.sym.zeros((2,)), tmx.Symbol)


def test_prefix_names_symbols_as_the_reference():
    names = []
    for mx in (jmx, tmx):
        with mx.Prefix("enc_"):
            fc = mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=4)
        names.append(fc.list_arguments())
    assert names[0] == names[1]
    assert names[1][1].startswith("enc_")
