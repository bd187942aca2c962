"""The serving control plane (counterpart of ``mxnet_tpu/serving/control/``):
SLO-class weighted admission with aging for the generation engine. The
radix-tree prefix cache and the replica autoscaler are not ported yet:
building either raises. The autoscaler's actuator,
``InferenceServer.resize_replicas``, is; its policy needs the time-series
plane and the SLO monitor (``observability/timeseries.py`` and
``slo_monitor.py``), which come with it (ROADMAP A9)."""
from ...base import MXNetError
from .slo import BUILTIN_CLASSES, ClassQueue, SLOClass, resolve_class

__all__ = ["PrefixCache", "SLOClass", "ClassQueue", "resolve_class",
           "BUILTIN_CLASSES", "AutoscalePolicy", "Autoscaler",
           "ScaleDecision"]


class _NotPorted:
    """A name of the JAX package's control plane whose module is not
    ported: constructing it raises, naming the ROADMAP entry."""

    _what = ""

    def __init__(self, *args, **kwargs):
        raise MXNetError("%s is not yet ported (ROADMAP A9)" % self._what)


class PrefixCache(_NotPorted):
    _what = "the generation prefix cache (serving/control/prefix_cache.py)"


class AutoscalePolicy(_NotPorted):
    _what = ("replica autoscaling (serving/control/autoscale.py, with "
             "observability/timeseries.py and slo_monitor.py)")


class Autoscaler(_NotPorted):
    _what = ("replica autoscaling (serving/control/autoscale.py, with "
             "observability/timeseries.py and slo_monitor.py)")


class ScaleDecision(_NotPorted):
    _what = ("replica autoscaling (serving/control/autoscale.py, with "
             "observability/timeseries.py and slo_monitor.py)")
