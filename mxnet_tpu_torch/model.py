"""Module helpers: the kvstore glue of ``Module``.

Counterpart of ``mxnet_tpu/model.py``: ``BatchEndParam``,
``_create_kvstore`` (decides update_on_kvstore), ``_initialize_kvstore``,
``_update_params(_on_kvstore)`` and the checkpoint pair
(``save_checkpoint`` / ``load_checkpoint``: ``prefix-symbol.json`` and
``prefix-%04d.params`` with ``arg:`` / ``aux:`` keys, the files MXNet and
the JAX package write), ``convert_conv_weight_layout`` and the legacy
``FeedForward`` estimator, which trains through ``Module``.
``FeedForward(ctx=None)`` binds where ``Module(context=None)`` does: the
innermost ``with`` scope, else the card.
"""
from __future__ import annotations

import logging
from collections import namedtuple

from . import kvstore as kvs
from . import ndarray as nd
from . import symbol as sym

__all__ = ["BatchEndParam", "FeedForward", "save_checkpoint", "load_checkpoint",
           "convert_conv_weight_layout"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def _create_kvstore(kvstore, num_device, arg_params):
    """(kvstore or None, update_on_kvstore): one device with a local type
    needs no store, and the update runs locally."""
    update_on_kvstore = True
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, kvs.KVStore):
        kv = kvstore
    elif isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore and kvstore != "mesh":
            # no need for multi-device reduce; update locally
            kv = None
        else:
            kv = kvs.create(kvstore)
            if kvstore == "local":
                # reference heuristic: big arrays → update on kvstore
                max_size = max(np_prod(p.shape) for p in arg_params.values())
                if max_size > 1024 * 1024 * 16:
                    update_on_kvstore = False
    else:
        raise TypeError("kvstore must be KVStore, str or None")
    if kv is None:
        update_on_kvstore = False
    return (kv, update_on_kvstore)


def np_prod(shape):
    r = 1
    for s in shape:
        r *= s
    return r


def _initialize_kvstore(kvstore, param_arrays, arg_params, param_names,
                        update_on_kvstore):
    """Seed the store with the host parameters, placed on the device of
    the parameter's first device array, so that the store's reduce and
    update run there; with update_on_kvstore, pull them back into the
    device arrays."""
    for idx, param_on_devs in enumerate(param_arrays):
        name = param_names[idx]
        kvstore.init(name, arg_params[name].copyto(param_on_devs[0].context))
        if update_on_kvstore:
            kvstore.pull(name, param_on_devs, priority=-idx)


def _update_params_on_kvstore(param_arrays, grad_arrays, kvstore, param_names):
    """Push each gradient (the store updates its weight) and pull the
    weight back into every device array."""
    for index, pair in enumerate(zip(param_arrays, grad_arrays)):
        arg_list, grad_list = pair
        if grad_list[0] is None:
            continue
        name = param_names[index]
        kvstore.push(name, grad_list, priority=-index)
        kvstore.pull(name, arg_list, priority=-index)


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None, param_names=None):
    """The per-device update: reduce through the store when there is one,
    then run the updater on each device's (grad, weight)."""
    for index, pair in enumerate(zip(param_arrays, grad_arrays)):
        arg_list, grad_list = pair
        if grad_list[0] is None:
            continue
        if kvstore:
            name = param_names[index]
            kvstore.push(name, grad_list, priority=-index)
            kvstore.pull(name, grad_list, priority=-index)
        for k, p in enumerate(zip(arg_list, grad_list)):
            w, g = p
            updater(index * num_device + k, g, w)


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Write ``prefix-symbol.json`` (when ``symbol`` is given) and
    ``prefix-%04d.params``."""
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    param_name = "%s-%04d.params" % (prefix, epoch)
    nd.save(param_name, save_dict)
    logging.info("Saved checkpoint to \"%s\"", param_name)


def load_checkpoint(prefix, epoch):
    """(symbol, arg_params, aux_params) from what :func:`save_checkpoint`
    wrote; the parameters load into host memory."""
    symbol = sym.load("%s-symbol.json" % prefix)
    save_dict = nd.load("%s-%04d.params" % (prefix, epoch))
    arg_params = {}
    aux_params = {}
    for k, v in save_dict.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        if tp == "aux":
            aux_params[name] = v
    return (symbol, arg_params, aux_params)


def convert_conv_weight_layout(weight, direction="ref_to_tpu"):
    """Exchange channels-last Convolution weights with reference NHWC graphs.

    The reference's ``layout='NHWC'`` Convolution keeps weights as
    (num_filter, kernel..., C/group) while this framework stores channels-last
    weights spatial-major as HWIO (kernel..., C/group, num_filter), as the
    JAX package does. ``direction`` is ``'ref_to_tpu'`` or ``'tpu_to_ref'``
    (the JAX package's names for the two layouts).
    """
    import numpy as np

    a = weight.asnumpy() if hasattr(weight, "asnumpy") else np.asarray(weight)
    if a.ndim < 3:
        raise ValueError("conv weight must be at least 3-d, got %s" % (a.shape,))
    if direction == "ref_to_tpu":      # (O, spatial..., I) → (spatial..., I, O)
        perm = tuple(range(1, a.ndim)) + (0,)
    elif direction == "tpu_to_ref":    # (spatial..., I, O) → (O, spatial..., I)
        perm = (a.ndim - 1,) + tuple(range(a.ndim - 1))
    else:
        raise ValueError("direction must be 'ref_to_tpu' or 'tpu_to_ref'")
    out = np.ascontiguousarray(a.transpose(perm))
    return nd.array(out, ctx=weight.context) if hasattr(weight, "asnumpy") \
        else out


class FeedForward:
    """Legacy estimator API: fit/predict/score/save/load over one symbol.

    Counterpart of ``mxnet_tpu/model.py``'s ``FeedForward`` (the reference
    ``python/mxnet/model.py`` training surface that predates Module): a
    thin adapter that owns parameters and delegates the training loop to
    :class:`~mxnet_tpu_torch.module.Module`. ``ctx=None`` resolves at
    construction to the innermost ``with`` scope, else the card (the JAX
    package takes ``current_context()``, which is the CPU outside a scope
    here).
    """

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, allow_extra_params=False,
                 begin_epoch=0, **kwargs):
        from .context import as_device
        from .initializer import Uniform

        self.symbol = symbol
        if ctx is None:
            ctx = [as_device(None)]
        elif not isinstance(ctx, (list, tuple)):
            ctx = [ctx]
        self.ctx = list(ctx)
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.optimizer = optimizer
        self.initializer = initializer or Uniform(0.01)
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.begin_epoch = begin_epoch
        self.kwargs = dict(kwargs)
        self._module = None

    # ----------------------------------------------------------- plumbing
    def _as_iter(self, X, y=None, shuffle=False):
        """Accept numpy pairs or DataIters like the reference _init_iter."""
        import numpy as np

        from .io import DataIter, NDArrayIter

        if isinstance(X, DataIter):
            return X
        X = np.asarray(X)
        if y is not None:
            y = np.asarray(y)
        return NDArrayIter(X, y, batch_size=min(self.numpy_batch_size,
                                                len(X)),
                           shuffle=shuffle, label_name="softmax_label")

    def _label_args(self):
        """Symbol arguments that are labels, by the reference's naming
        convention (model.py _is_data_arg: ...endswith 'label')."""
        return [a for a in self.symbol.list_arguments()
                if a.endswith("label")]

    def _make_module(self, train_iter):
        from .module import Module

        label_names = ([d[0] for d in (train_iter.provide_label or [])]
                       or self._label_args())
        self._module = Module(self.symbol,
                              data_names=[d[0] for d in
                                          train_iter.provide_data],
                              label_names=label_names or None,
                              context=self.ctx)
        return self._module

    # ------------------------------------------------------------ training
    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            logger=None, work_load_list=None, monitor=None,
            eval_end_callback=None, eval_batch_end_callback=None,
            resume=None):
        """Train for ``num_epoch`` epochs over X/y (arrays or a DataIter).
        ``resume`` names a resumable-checkpoint directory (preemption-safe
        training, see ``Module.fit``)."""
        if self.num_epoch is None:
            raise ValueError("num_epoch must be set to call fit")
        from .observability import flight_recorder, health

        if health.active():
            # the delegated Module.fit loop runs the per-step checks;
            # arming here too covers a crash in FeedForward's own set-up
            # (iterator coercion, module construction)
            flight_recorder.install()
        train = self._as_iter(X, y, shuffle=True)
        if eval_data is not None and not hasattr(eval_data, "provide_data"):
            eval_data = self._as_iter(eval_data[0], eval_data[1])
        mod = self._make_module(train)

        optimizer_params = dict(self.kwargs)
        if isinstance(self.optimizer, str):
            optimizer_params.setdefault("learning_rate", 0.01)
        mod.fit(train, eval_data=eval_data, eval_metric=eval_metric,
                epoch_end_callback=epoch_end_callback,
                batch_end_callback=batch_end_callback, kvstore=kvstore,
                optimizer=self.optimizer,
                optimizer_params=tuple(optimizer_params.items()),
                initializer=self.initializer,
                arg_params=self.arg_params, aux_params=self.aux_params,
                allow_missing=self.arg_params is not None,
                begin_epoch=self.begin_epoch, num_epoch=self.num_epoch,
                eval_end_callback=eval_end_callback,
                eval_batch_end_callback=eval_batch_end_callback,
                monitor=monitor, resume=resume)
        self.arg_params, self.aux_params = mod.get_params()
        return self

    # ----------------------------------------------------------- inference
    def _bound_for_predict(self, data_iter):
        from .module import Module

        mod = Module(self.symbol,
                     data_names=[d[0] for d in data_iter.provide_data],
                     label_names=self._label_args() or None,
                     context=self.ctx)
        mod.bind(data_shapes=data_iter.provide_data, for_training=False)
        mod.set_params(self.arg_params or {}, self.aux_params or {},
                       allow_missing=False,
                       allow_extra=self.allow_extra_params)
        return mod

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        """Class probabilities for X; optionally also return (data, label)."""
        import numpy as np

        from .io import pad_batch_to_bound

        data_iter = self._as_iter(X)
        if reset:
            data_iter.reset()
        mod = self._bound_for_predict(data_iter)
        # per-batch outputs stay on the device inside a window and are
        # copied out in bounded chunks: a copy per batch would wait for
        # the card each batch, keeping all of them would hold the whole
        # prediction set in device memory
        window = 32
        outputs, datas, labels = [], [], []
        host_out, host_data, host_label = [], [], []

        def drain(buf, sink):
            sink.extend(a.asnumpy() for a in buf)
            del buf[:]

        for i, batch in enumerate(data_iter):
            if num_batch is not None and i == num_batch:
                break
            # a trailing short batch is padded up to the bound shape and
            # sliced back, instead of re-binding
            fwd, _extra = pad_batch_to_bound(batch, data_iter.provide_data)
            mod.forward(fwd, is_train=False)
            keep = batch.data[0].shape[0] - (batch.pad or 0)
            outputs.append(mod.get_outputs()[0][:keep])
            if return_data:
                datas.append(batch.data[0][:keep])
                if batch.label:
                    labels.append(batch.label[0][:keep])
            if len(outputs) >= window:
                drain(outputs, host_out)
                drain(datas, host_data)
                drain(labels, host_label)
        drain(outputs, host_out)
        drain(datas, host_data)
        drain(labels, host_label)

        preds = np.concatenate(host_out)
        if not return_data:
            return preds
        return (preds, np.concatenate(host_data),
                np.concatenate(host_label) if host_label else None)

    def score(self, X, eval_metric="acc", num_batch=None,
              batch_end_callback=None, reset=True):
        """Metric value over X (requires labels in the iterator)."""
        from . import metric as metric_mod
        from .io import pad_batch_to_bound

        data_iter = self._as_iter(X)
        if reset:
            data_iter.reset()
        metric = metric_mod.create(eval_metric)
        mod = self._bound_for_predict(data_iter)
        metric.reset()
        for i, batch in enumerate(data_iter):
            if num_batch is not None and i == num_batch:
                break
            fwd, extra = pad_batch_to_bound(batch, data_iter.provide_data)
            mod.forward(fwd, is_train=False)
            outs = mod.get_outputs()
            if extra:
                n = batch.data[0].shape[0]
                outs = [o[:n] for o in outs]
            metric.update(batch.label, outs)
            if batch_end_callback is not None:
                cbs = (batch_end_callback
                       if isinstance(batch_end_callback, list)
                       else [batch_end_callback])
                for cb in cbs:
                    cb(BatchEndParam(epoch=0, nbatch=i, eval_metric=metric,
                                     locals=locals()))
        return metric.get()[1]

    # ---------------------------------------------------------- checkpoints
    def save(self, prefix, epoch=None):
        """Write prefix-symbol.json + prefix-NNNN.params."""
        if epoch is None:
            epoch = self.num_epoch
        if epoch is None:
            raise ValueError("save needs an epoch (or num_epoch)")
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params or {},
                        self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        """Rebuild a FeedForward from a checkpoint."""
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch,
                           **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None, epoch_size=None,
               optimizer="sgd", initializer=None, eval_data=None,
               eval_metric="acc", epoch_end_callback=None,
               batch_end_callback=None, kvstore="local", logger=None,
               work_load_list=None, eval_end_callback=None,
               eval_batch_end_callback=None, **kwargs):
        """Construct + fit in one call (reference: model.py:930)."""
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch,
                            epoch_size=epoch_size, optimizer=optimizer,
                            initializer=initializer, **kwargs)
        model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric,
                  epoch_end_callback=epoch_end_callback,
                  batch_end_callback=batch_end_callback, kvstore=kvstore,
                  logger=logger, work_load_list=work_load_list,
                  eval_end_callback=eval_end_callback,
                  eval_batch_end_callback=eval_batch_end_callback)
        return model
