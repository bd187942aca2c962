"""The serving control plane (counterpart of ``mxnet_tpu/serving/control/``):
a radix-tree prefix cache sharing KV pages copy-on-write across requests
with a common prompt prefix, SLO-class (deadline + priority tier) weighted
admission with aging for the generation engine, and the closed loop of
replica autoscaling: :class:`AutoscalePolicy` / :class:`Autoscaler` turn
the time-series view (queue-depth windows, replica gauges, SLO burn-rate
alerts) into ``InferenceServer.resize_replicas`` calls."""
from .autoscale import Autoscaler, AutoscalePolicy, ScaleDecision
from .prefix_cache import PrefixCache
from .slo import BUILTIN_CLASSES, ClassQueue, SLOClass, resolve_class

__all__ = ["PrefixCache", "SLOClass", "ClassQueue", "resolve_class",
           "BUILTIN_CLASSES", "AutoscalePolicy", "Autoscaler",
           "ScaleDecision"]
