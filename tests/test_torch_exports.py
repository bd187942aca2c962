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

# modules and classes of ``mx`` not ported yet: the parameter-server
# process comes with distribution (A10)
MX_UNPORTED = frozenset({"kvstore_server"})

# ``mx.io``: every iterator is ported
IO_UNPORTED = frozenset()

# ops of the registry not ported yet (both ``mx.sym`` and ``mx.nd``)
OPS_UNPORTED = frozenset()

# ``mx.nd.contrib`` / ``mx.sym.contrib`` ops not ported yet
CONTRIB_UNPORTED = frozenset()

# every name of the JAX package's op registry that the port's lacks,
# private names included (the public-name tests skip ``_``-names), each
# with the ROADMAP.md Queue A item it waits for
REGISTRY_UNPORTED = {
    "_CrossDeviceCopy": "A13 (group2ctx)",
}

# beyond the ops: ``mx.sym`` only, ``mx.nd`` only
SYM_UNPORTED = frozenset()
ND_UNPORTED = frozenset()

UNPORTED = {"": MX_UNPORTED, "sym": OPS_UNPORTED | SYM_UNPORTED,
            "nd": OPS_UNPORTED | ND_UNPORTED, "base": frozenset(),
            "metric": frozenset(), "mod": frozenset(), "model": frozenset(),
            "io": IO_UNPORTED}

# names the slices added, each of which the JAX package has
ADDED = {"": ("Context", "current_context", "num_gpus", "tpu", "cpu_pinned",
              "Symbol", "Executor", "opt", "Prefix", "cpu", "gpu",
              "NotImplementedForSymbol", "viz", "contrib", "storage"),
         "sym": ("zeros", "ones"), "nd": (), "base": ("Prefix",),
         "metric": ("F1", "CustomMetric", "np", "PearsonCorrelation"),
         "mod": ("SequentialModule", "PythonLossModule",
                 "DataParallelExecutorGroup"),
         "model": ("FeedForward", "convert_conv_weight_layout"),
         "io": ("NDArrayIter",)}


_LIST = """
import functools, importlib, json, sys
mx = importlib.import_module(sys.argv[1])
print(json.dumps({name: sorted(n for n in dir(functools.reduce(
                     getattr, name.split(".") if name else [], mx))
                               if not n.startswith("_"))
                  for name in ("", "sym", "nd", "base", "sym.contrib",
                               "nd.contrib", "metric", "mod", "model",
                               "io")}))
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


_REGISTRY = """
import importlib, json, sys
mx = importlib.import_module(sys.argv[1])
print(json.dumps(mx.ops.registry.list_ops()))
"""


def test_registry_lacks_only_the_explicit_remainder():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    names = {}
    for package in ("mxnet_tpu", "mxnet_tpu_torch"):
        out = subprocess.run([sys.executable, "-c", _REGISTRY, package],
                             cwd=root, capture_output=True, text=True,
                             check=True, timeout=300).stdout
        names[package] = set(json.loads(out.splitlines()[-1]))
    missing = names["mxnet_tpu"] - names["mxnet_tpu_torch"]
    assert missing == set(REGISTRY_UNPORTED), (
        "gained (take off the list): %s; lost: %s"
        % (sorted(set(REGISTRY_UNPORTED) - missing),
           sorted(missing - set(REGISTRY_UNPORTED))))
    assert not names["mxnet_tpu_torch"] - names["mxnet_tpu"]


@pytest.mark.parametrize("name", ["sym.contrib", "nd.contrib"])
def test_contrib_names_match_the_reference_but_the_unported(name):
    missing = _public("mxnet_tpu")[name] - _public("mxnet_tpu_torch")[name]
    assert missing == CONTRIB_UNPORTED, (
        "gained (take off the list): %s; lost: %s"
        % (sorted(CONTRIB_UNPORTED - missing),
           sorted(missing - CONTRIB_UNPORTED)))
    assert not _public("mxnet_tpu_torch")[name] - _public("mxnet_tpu")[name]


@pytest.mark.parametrize("name", ["", "sym", "nd", "base", "metric", "mod",
                                  "model", "io"])
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


def test_control_plane_names_are_real_exports():
    """The serving control plane's names are the JAX package's, each the
    port's own class (no placeholder), as are the observability modules
    the autoscaler stands on."""
    from mxnet_tpu import observability as jobs
    from mxnet_tpu.serving import control as jcontrol
    from mxnet_tpu_torch import observability as tobs
    from mxnet_tpu_torch.serving import control as tcontrol

    assert sorted(tcontrol.__all__) == sorted(jcontrol.__all__)
    homes = {"PrefixCache": "prefix_cache", "AutoscalePolicy": "autoscale",
             "Autoscaler": "autoscale", "ScaleDecision": "autoscale",
             "SLOClass": "slo", "ClassQueue": "slo"}
    for name, home in homes.items():
        obj = getattr(tcontrol, name)
        assert obj.__module__ == "mxnet_tpu_torch.serving.control." + home
        assert getattr(jcontrol, name).__module__ == \
            "mxnet_tpu.serving.control." + home
    assert tmx.serving.generation.PrefixCache is tcontrol.PrefixCache
    for mod in ("promparse", "timeseries", "slo_monitor"):
        assert mod in tobs.__all__ and mod in jobs.__all__
        assert sorted(getattr(tobs, mod).__all__) == \
            sorted(getattr(jobs, mod).__all__)
