"""``sym.contrib``: the ``_contrib_X`` registry ops as ``contrib.X``
(counterpart of ``mxnet_tpu/symbol/contrib.py``; filled from the registry
at import by ``register.populate_namespaces``)."""
