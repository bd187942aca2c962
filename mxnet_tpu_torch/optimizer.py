"""Optimizers: the registry, SGD (and its alias ccSGD), DCASGD, SGLD, NAG,
Adam, AdaGrad, RMSProp, AdaDelta, Ftrl, Adamax, Nadam, Test and the
``Updater``.

Counterpart of ``mxnet_tpu/optimizer.py``: the registry / ``create``
surface, per-index lr/wd multipliers, the optimizers Gluon's Trainer
fuses, and the ``Updater`` with its pickled-state contract. Each optimizer
computes its step as a function of tensors (:meth:`Optimizer.step_tensors`:
the update ops of ``ops/optimizer_ops.py`` where there is one, else the
JAX package's arithmetic), and :meth:`Optimizer.update` writes the result
into the weight and state arrays in place. ``lr``, ``rescale_grad`` and
``clip_gradient`` may be 0-dim tensors, which a captured training step
reads from the device. DCASGD, SGLD, Adamax, Nadam and Test update
eagerly only, as in the JAX package (Gluon's ``compile_step`` refuses them):
SGLD draws host-counted noise, Nadam multiplies one host ``m_schedule``
shared by every parameter on each parameter's update, so its result
depends on the update order, which is the JAX package's.
"""
from __future__ import annotations

import logging
import math
import pickle

import numpy as np
import torch

from . import ndarray as nd
from .ndarray import NDArray
from .ops.optimizer_ops import _lr_mul, _prep_grad
from .ops.registry import OpAttrs, get_op


def _store_hyperparams(obj, local_vars, *names):
    """Assign ctor hyperparameters onto the instance in one place."""
    for name in names:
        setattr(obj, name, local_vars[name])


__all__ = ["Optimizer", "SGD", "DCASGD", "SGLD", "NAG", "Adam", "AdaGrad",
           "RMSProp", "AdaDelta", "Ftrl", "Adamax", "Nadam", "Test",
           "create", "register", "Updater", "get_updater"]


def flat_state(state):
    """An optimizer state (None, an NDArray or a tuple of NDArrays and
    Nones) as the list of its arrays."""
    if state is None:
        return []
    if isinstance(state, NDArray):
        return [state]
    return [s for s in state if s is not None]


def _apply_op(name, weight, grad, states, **kw):
    """The registry's update op on tensors: (new weight, new states).
    Tensor-valued scalars go into the attrs as they are."""
    opdef = get_op(name)
    host = {k: (0.0 if isinstance(v, torch.Tensor) else v)
            for k, v in kw.items() if v is not None}
    attrs = opdef.parse_attrs(host)
    attrs = OpAttrs(dict(attrs._d, **{k: v for k, v in kw.items()
                                      if isinstance(v, torch.Tensor)}))
    (new_w,), new_states = opdef.apply(attrs, (weight, grad), states)
    return new_w, list(new_states)


def _grad_attrs(rescale_grad, clip_gradient):
    return OpAttrs({"rescale_grad": rescale_grad,
                    "clip_gradient": clip_gradient})


class Optimizer:
    """Base class: hyperparameter bookkeeping + the update() contract."""

    opt_registry = {}

    @staticmethod
    def register(klass):
        key = klass.__name__.lower()
        if key in Optimizer.opt_registry:
            logging.warning("WARNING: New optimizer %s is overriding "
                            "existing optimizer %s", klass.__name__, key)
        Optimizer.opt_registry[key] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        try:
            klass = Optimizer.opt_registry[name.lower()]
        except KeyError:
            raise ValueError("Cannot find optimizer %s" % name)
        # construct outside the except scope: a KeyError raised INSIDE
        # an optimizer ctor must propagate, not masquerade as a lookup miss
        return klass(**kwargs)

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.clip_gradient = clip_gradient
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.sym = sym
        if param_idx2name is None:
            param_idx2name = {}
        if not isinstance(param_idx2name, dict):
            raise AssertionError(
                "param_idx2name should be a dict of param indexes to names.")
        self.idx2name = dict(param_idx2name)
        self.set_lr_mult({})
        self.set_wd_mult({})

    # ------------------------------------------------------------ contract
    def create_state(self, index, weight):
        """Per-parameter auxiliary state (None when stateless)."""
        return None

    def step_tensors(self, index, weight, grad, states, lr, rescale_grad,
                     clip_gradient):
        """One step as a function of tensors: (new weight, new states) for
        the weight, its gradient and the list of its state tensors
        (:func:`flat_state` order)."""
        raise NotImplementedError()

    def step_lr(self, index):
        """The learning rate of this step of ``index`` (after its update
        count advanced): Adam folds its bias correction in."""
        return self._get_lr(index)

    def update_rsp(self, index, weight, grad, state, lr):
        """One step from a row-sparse gradient. Optimizers with a lazy
        path (SGD, Adam, Ftrl) touch only the gradient's rows; the others
        take the densified gradient, as the reference's storage fallback
        does."""
        from .ndarray.sparse import cast_storage

        self._update_dense(index, weight, cast_storage(grad, "default"),
                           state, lr)

    def update(self, index, weight, grad, state):
        """One step of ``weight`` and ``state``, written in place."""
        self._update_count(index)
        step = self.update_rsp if grad.stype == "row_sparse" \
            else self._update_dense
        step(index, weight, grad, state, self.step_lr(index))

    def _update_dense(self, index, weight, grad, state, lr):
        arrays = flat_state(state)
        with torch.no_grad():
            new_w, new_states = self.step_tensors(
                index, weight._data, grad._data, [a._data for a in arrays],
                lr, self.rescale_grad, self.clip_gradient)
            for arr, value in zip([weight] + arrays, [new_w] + new_states):
                arr._set_data(value)

    # ----------------------------------------------------- hyperparameters
    def _sym_attr_mults(self, attr_key):
        """Multipliers declared as symbol attributes (__lr_mult__ etc.)."""
        table = {}
        if self.sym is not None:
            attrs = self.sym.attr_dict()
            for name in self.sym.list_arguments():
                if attr_key in attrs.get(name, ()):
                    table[name] = float(attrs[name][attr_key])
        return table

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = self._sym_attr_mults("__lr_mult__")
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        """Bias/gamma/beta entries default to zero weight decay."""
        self.wd_mult = {
            n: 0.0 for n in self.idx2name.values()
            if not n.endswith(("_weight", "_gamma"))}
        self.wd_mult.update(self._sym_attr_mults("__wd_mult__"))
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        count = self._index_update_count.get(index, self.begin_num_update) + 1
        self._index_update_count[index] = count
        self.num_update = max(count, self.num_update)

    def _mult_for(self, table, index):
        if index in table:
            return table[index]
        if index in self.idx2name:
            return table.get(self.idx2name[index], 1.0)
        return 1.0

    def _resume_extras(self):
        """Host-side scalar state that must survive checkpoint-resume
        beyond per-index counts; optimizers with extra running scalars
        override (Nadam's m_schedule)."""
        return {}

    def _get_lr(self, index):
        base = (self.lr_scheduler(self.num_update)
                if self.lr_scheduler is not None else self.lr)
        return base * self._mult_for(self.lr_mult, index)

    def _get_wd(self, index):
        return self.wd * self._mult_for(self.wd_mult, index)


register = Optimizer.register


def create(name, **kwargs):
    """Instantiate a registered optimizer by name."""
    return Optimizer.create_optimizer(name, **kwargs)


@register
class SGD(Optimizer):
    """(Momentum) SGD with optional fp16 master weights, through the
    sgd_update / sgd_mom_update / mp_sgd_* ops; a row-sparse gradient
    takes the lazy row path."""

    def __init__(self, momentum=0.0, multi_precision=False, **kwargs):
        super().__init__(**kwargs)
        _store_hyperparams(self, locals(), "momentum", "multi_precision")

    def create_state(self, index, weight):
        if self.multi_precision and weight.dtype == np.float16:
            master = weight.astype(np.float32)
            mom = (nd.zeros(weight.shape, weight.context, dtype=np.float32)
                   if self.momentum != 0.0 else None)
            return (mom, master)
        if weight.dtype == np.float16:
            logging.warning(
                "Accumulating with float16 in optimizer can lead to poor "
                "accuracy or slow convergence. Consider using "
                "multi_precision=True option of the SGD optimizer")
        if self.momentum == 0.0:
            return None
        return nd.zeros(weight.shape, weight.context, dtype=weight.dtype)

    def step_tensors(self, index, weight, grad, states, lr, rescale_grad,
                     clip_gradient):
        kw = dict(lr=lr, wd=self._get_wd(index), rescale_grad=rescale_grad,
                  clip_gradient=clip_gradient)
        if self.momentum > 0:
            kw["momentum"] = self.momentum
        master = self.multi_precision and weight.dtype == torch.float16
        name = ("mp_" if master else "") + \
            ("sgd_mom_update" if self.momentum > 0 else "sgd_update")
        return _apply_op(name, weight, grad, states, **kw)

    def update_rsp(self, index, weight, grad, state, lr):
        from .ndarray import sparse as sp

        common = dict(lr=lr, wd=self._get_wd(index),
                      rescale_grad=self.rescale_grad,
                      clip_gradient=self.clip_gradient)
        if isinstance(state, (list, tuple)):
            sp.mp_sgd_update_rsp(weight, grad, state[0], state[1],
                                 momentum=self.momentum, **common)
        elif state is not None:
            sp.sgd_mom_update_rsp(weight, grad, state,
                                  momentum=self.momentum, **common)
        else:
            sp.sgd_update_rsp(weight, grad, **common)


@register
class ccSGD(SGD):
    """[DEPRECATED] Alias of SGD, kept for reference back-compat
    (reference: optimizer.py:657)."""


@register
class DCASGD(Optimizer):
    """Delay-compensated async SGD (Zheng et al. 2016): the state is the
    momentum (None at momentum 0) and the previous weight."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        _store_hyperparams(self, locals(), "momentum", "lamda")

    def create_state(self, index, weight):
        mom = (nd.zeros(weight.shape, weight.context, dtype=weight.dtype)
               if self.momentum != 0.0 else None)
        return (mom, weight.copy())

    def step_tensors(self, index, weight, grad, states, lr, rescale_grad,
                     clip_gradient):
        wd = self._get_wd(index)
        g = _prep_grad(_grad_attrs(rescale_grad, clip_gradient), grad)
        stale = states[-1]
        # the delayed gradient compensated by a curvature estimate
        compensated = g + self.lamda * g * g * (weight - stale)
        step = -_lr_mul(lr, compensated + wd * weight)
        # the new stale weight is this step's old one (a copy: update()
        # writes the new weight in place first)
        if len(states) == 2:
            mom = states[0] * self.momentum + step
            return weight + mom, [mom, weight.clone()]
        assert self.momentum == 0.0
        return weight + step, [weight.clone()]


@register
class SGLD(Optimizer):
    """Stochastic Gradient Langevin Dynamics: SGD plus Gaussian noise of
    variance lr. The noise comes from the optimizer's own stream (``seed``
    and a draw counter, each draw a ``torch.Generator`` seeded from the
    pair), not from ``mx.random``; the counter rides ``_resume_extras``,
    so a resumed run replays the same noise. The stream is torch's, not
    the JAX package's: the two agree in distribution."""

    def __init__(self, seed=0, **kwargs):
        super().__init__(**kwargs)
        self.seed = int(seed)
        self._noise_draws = 0

    def _next_noise(self, weight, std):
        key = np.random.SeedSequence([self.seed, self._noise_draws])
        self._noise_draws += 1
        gen = torch.Generator(device=weight.device)
        gen.manual_seed(int(key.generate_state(1, np.uint64)[0] >> 1))
        return std * torch.randn(weight.shape, generator=gen,
                                 device=weight.device, dtype=weight.dtype)

    def _resume_extras(self):
        return {"_noise_draws": self._noise_draws}

    def step_tensors(self, index, weight, grad, states, lr, rescale_grad,
                     clip_gradient):
        wd = self._get_wd(index)
        g = _prep_grad(_grad_attrs(rescale_grad, clip_gradient), grad)
        noise = self._next_noise(weight, math.sqrt(float(lr)))
        return weight + (-_lr_mul(lr, g + wd * weight) / 2 + noise), []


@register
class NAG(SGD):
    """Nesterov accelerated gradient. It has no lazy row path: a
    row-sparse gradient is densified, so every row takes the Nesterov
    step, momentum decay and weight decay (not SGD's lazy update)."""

    update_rsp = Optimizer.update_rsp

    def step_tensors(self, index, weight, grad, states, lr, rescale_grad,
                     clip_gradient):
        wd = self._get_wd(index)
        g = _prep_grad(_grad_attrs(rescale_grad, clip_gradient), grad)
        if not states:
            assert self.momentum == 0.0
            return weight - _lr_mul(lr, g + wd * weight), []
        mom = states[0] * self.momentum
        g = g + wd * weight
        mom = mom + g
        g = g + self.momentum * mom
        return weight - _lr_mul(lr, g), [mom]


@register
class Adam(Optimizer):
    """Adam with the bias correction folded into the step size (the
    adam_update op)."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        _store_hyperparams(self, locals(), "beta1", "beta2", "epsilon")

    def create_state(self, index, weight):
        return (nd.zeros(weight.shape, weight.context, dtype=weight.dtype),
                nd.zeros(weight.shape, weight.context, dtype=weight.dtype))

    def step_lr(self, index):
        t = self._index_update_count[index]
        return (self._get_lr(index)
                * math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t))

    def step_tensors(self, index, weight, grad, states, lr, rescale_grad,
                     clip_gradient):
        return _apply_op("adam_update", weight, grad, states, lr=lr,
                         wd=self._get_wd(index), rescale_grad=rescale_grad,
                         clip_gradient=clip_gradient, beta1=self.beta1,
                         beta2=self.beta2, epsilon=self.epsilon)

    def update_rsp(self, index, weight, grad, state, lr):
        from .ndarray import sparse as sp

        sp.adam_update_rsp(weight, grad, state[0], state[1], lr=lr,
                           beta1=self.beta1, beta2=self.beta2,
                           epsilon=self.epsilon, wd=self._get_wd(index),
                           rescale_grad=self.rescale_grad,
                           clip_gradient=self.clip_gradient)


@register
class AdaGrad(Optimizer):
    """AdaGrad: per-coordinate lr from the accumulated squared gradient."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return nd.zeros(weight.shape, weight.context)

    def step_tensors(self, index, weight, grad, states, lr, rescale_grad,
                     clip_gradient):
        wd = self._get_wd(index)
        g = _prep_grad(_grad_attrs(rescale_grad, clip_gradient), grad)
        history = states[0] + g * g
        denom = torch.sqrt(history + self.float_stable_eps)
        return weight - _lr_mul(lr, g / denom + wd * weight), [history]


@register
class RMSProp(Optimizer):
    """RMSProp (Tieleman) / centered RMSProp (Graves), through the
    rmsprop_update / rmspropalex_update ops."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        _store_hyperparams(self, locals(), "gamma1", "gamma2", "centered",
                           "epsilon", "clip_weights")

    def create_state(self, index, weight):
        def zeros():
            return nd.zeros(weight.shape, weight.context)
        return (zeros(), zeros(), zeros()) if self.centered else zeros()

    def step_tensors(self, index, weight, grad, states, lr, rescale_grad,
                     clip_gradient):
        kw = dict(lr=lr, wd=self._get_wd(index), rescale_grad=rescale_grad,
                  clip_gradient=clip_gradient, gamma1=self.gamma1,
                  epsilon=self.epsilon, clip_weights=self.clip_weights)
        if self.centered:
            return _apply_op("rmspropalex_update", weight, grad, states,
                             gamma2=self.gamma2, **kw)
        return _apply_op("rmsprop_update", weight, grad, states, **kw)


@register
class AdaDelta(Optimizer):
    """AdaDelta: lr-free, the ratio of running RMS values."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        _store_hyperparams(self, locals(), "rho", "epsilon")

    def create_state(self, index, weight):
        return (nd.zeros(weight.shape, weight.context),
                nd.zeros(weight.shape, weight.context))

    def step_tensors(self, index, weight, grad, states, lr, rescale_grad,
                     clip_gradient):
        wd = self._get_wd(index)
        g = _prep_grad(_grad_attrs(rescale_grad, clip_gradient), grad)
        acc_g, acc_delta = states
        acc_g = self.rho * acc_g + (1.0 - self.rho) * g * g
        step = (torch.sqrt(acc_delta + self.epsilon)
                / torch.sqrt(acc_g + self.epsilon)) * g
        acc_delta = self.rho * acc_delta + (1.0 - self.rho) * step * step
        return weight - (step + wd * weight), [acc_g, acc_delta]


@register
class Ftrl(Optimizer):
    """Follow-the-regularized-leader, through the ftrl_update op."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        _store_hyperparams(self, locals(), "lamda1", "beta")

    def create_state(self, index, weight):
        return (nd.zeros(weight.shape, weight.context),   # z
                nd.zeros(weight.shape, weight.context))   # n

    def step_tensors(self, index, weight, grad, states, lr, rescale_grad,
                     clip_gradient):
        return _apply_op("ftrl_update", weight, grad, states, lr=lr,
                         wd=self._get_wd(index), rescale_grad=rescale_grad,
                         clip_gradient=clip_gradient, lamda1=self.lamda1,
                         beta=self.beta)

    def update_rsp(self, index, weight, grad, state, lr):
        from .ndarray import sparse as sp

        sp.ftrl_update_rsp(weight, grad, state[0], state[1], lr=lr,
                           lamda1=self.lamda1, beta=self.beta,
                           wd=self._get_wd(index),
                           rescale_grad=self.rescale_grad,
                           clip_gradient=self.clip_gradient)


def _decayed_grad(opt, index, weight, grad, rescale_grad, clip_gradient):
    """``grad * rescale + wd * weight``, then clipped: Adamax's and
    Nadam's order (weight decay before the clip)."""
    g = grad * rescale_grad + opt._get_wd(index) * weight
    if clip_gradient is not None:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


@register
class Adamax(Optimizer):
    """AdaMax: the infinity-norm variant of Adam."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        _store_hyperparams(self, locals(), "beta1", "beta2")

    def create_state(self, index, weight):
        return (nd.zeros(weight.shape, weight.context, dtype=weight.dtype),
                nd.zeros(weight.shape, weight.context, dtype=weight.dtype))

    def step_lr(self, index):
        t = self._index_update_count[index]
        return self._get_lr(index) / (1.0 - self.beta1 ** t)

    def step_tensors(self, index, weight, grad, states, lr, rescale_grad,
                     clip_gradient):
        g = _decayed_grad(self, index, weight, grad, rescale_grad,
                          clip_gradient)
        m_t, u_t = states
        m_t = self.beta1 * m_t + (1.0 - self.beta1) * g
        u_t = torch.maximum(self.beta2 * u_t, torch.abs(g))
        return weight - _lr_mul(lr, m_t) / u_t, [m_t, u_t]


@register
class Nadam(Optimizer):
    """Adam with Nesterov momentum (Dozat 2016). ``m_schedule`` is one
    host float shared by every parameter: each parameter's update
    multiplies it by that step's momentum, so the result depends on the
    order of the updates."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        _store_hyperparams(self, locals(), "beta1", "beta2", "epsilon",
                           "schedule_decay")
        self.m_schedule = 1.0

    def _resume_extras(self):
        return {"m_schedule": self.m_schedule}

    def create_state(self, index, weight):
        return (nd.zeros(weight.shape, weight.context, dtype=weight.dtype),
                nd.zeros(weight.shape, weight.context, dtype=weight.dtype))

    def _momentum_schedule(self, t):
        """(mu_t, mu_{t+1}) of the decaying momentum schedule."""
        def mu(step):
            return self.beta1 * (1.0 - 0.5 * (0.96 ** (step * self.schedule_decay)))
        return mu(t), mu(t + 1)

    def step_tensors(self, index, weight, grad, states, lr, rescale_grad,
                     clip_gradient):
        t = self._index_update_count[index]
        g = _decayed_grad(self, index, weight, grad, rescale_grad,
                          clip_gradient)
        mu_t, mu_next = self._momentum_schedule(t)
        self.m_schedule *= mu_t
        schedule_next = self.m_schedule * mu_next
        m_t, v_t = states
        m_t = self.beta1 * m_t + (1.0 - self.beta1) * g
        v_t = self.beta2 * v_t + (1.0 - self.beta2) * g * g
        grad_hat = g / (1.0 - self.m_schedule)
        m_hat = m_t / (1.0 - schedule_next)
        v_hat = v_t / (1.0 - self.beta2 ** t)
        blended = (1.0 - mu_t) * grad_hat + mu_next * m_hat
        return (weight - _lr_mul(lr, blended)
                / (torch.sqrt(v_hat) + self.epsilon), [m_t, v_t])


@register
class Test(Optimizer):
    """Accumulate-gradient optimizer used by the reference test suite:
    ``weight += grad * rescale``, the state a copy of the new weight (no
    update count)."""

    def create_state(self, index, weight):
        return nd.zeros(weight.shape, weight.context)

    def update(self, index, weight, grad, state):
        if grad.stype != "default":
            from .ndarray.sparse import cast_storage
            grad = cast_storage(grad, "default")
        with torch.no_grad():
            weight._set_data(weight._data + grad._data * self.rescale_grad)
            state._set_data(weight._data)


def _to_host(value):
    """NDArray (possibly nested in tuples) -> numpy for pickling."""
    if isinstance(value, NDArray):
        return value.asnumpy()
    if isinstance(value, (tuple, list)):
        return tuple(_to_host(v) for v in value)
    return value


class Updater:
    """Per-key stateful update callable (local updates + kvstore server)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
            self.states_synced[index] = True
        elif not self.states_synced[index]:
            self.states[index] = self.sync_state_context(
                self.states[index], weight.context)
            self.states_synced[index] = True
        self.optimizer.update(index, weight, grad, self.states[index])

    def sync_state_context(self, state, context):
        """Rebuild loaded state on the right device (numpy → NDArray)."""
        if isinstance(state, NDArray):
            return state.as_in_context(context)
        if isinstance(state, np.ndarray):
            # get_states serializes to numpy; rebuild NDArrays on load so
            # the first post-resume update doesn't see raw numpy
            return nd.array(state, ctx=context)
        if isinstance(state, (tuple, list)):
            return type(state)(
                self.sync_state_context(s, context) for s in state)
        return state

    def set_states(self, states):
        obj = pickle.loads(states)
        if isinstance(obj, dict) and obj.get("__format__") == "mxtpu_v2":
            self.states = obj["states"]
            self._loaded_counts = dict(obj["counts"])
            self._loaded_num_update = obj["num_update"]
            self._loaded_extras = dict(obj.get("extras", {}))
            self._apply_counts(self.optimizer)
        elif isinstance(obj, tuple) and len(obj) == 2 \
                and isinstance(obj[1], Optimizer):
            # reference dump_optimizer format (optimizer.py get_states
            # pickles ``(states, optimizer)``): restore both — the
            # shipped optimizer carries its own update counts
            self.states, self.optimizer = obj
            self._loaded_counts = None
        elif isinstance(obj, dict):
            # legacy blob (reference format): bare {index: state} dict —
            # update counts are not recorded there, matching the
            # reference 1.0.0 wart that Adam's t restarts on resume
            self.states = obj
            self._loaded_counts = None
        else:
            raise TypeError(
                "set_states expects a pickled {index: state} dict, a "
                "(states, optimizer) tuple (dump_optimizer format), or "
                "an mxtpu_v2 blob; got %s" % type(obj).__name__)
        self.states_synced = dict.fromkeys(self.states, False)

    def _apply_counts(self, optimizer):
        """Restore per-index update counts (Adam/Adamax/Nadam bias
        correction, scheduler num_update) and host-side scalar state
        (Nadam's m_schedule) into ``optimizer``. Re-applied by callers
        that swap ``self.optimizer`` after set_states."""
        if getattr(self, "_loaded_counts", None) is None:
            return
        # REPLACE, don't merge: a rollback load (re-loading a step-100
        # checkpoint after training to step 200 in the same process)
        # must rewind the scheduler's num_update and every per-index
        # count together, or lr and Adam bias correction disagree
        optimizer._index_update_count = dict(self._loaded_counts)
        optimizer.num_update = self._loaded_num_update
        for k, v in getattr(self, "_loaded_extras", {}).items():
            setattr(optimizer, k, v)

    def get_states(self, dump_optimizer=False):
        host_states = {k: _to_host(v) for k, v in self.states.items()}
        if dump_optimizer:
            # reference format: pickle (states, optimizer) together so a
            # kvstore server can rebuild the whole updater from one blob
            return pickle.dumps((host_states, self.optimizer))
        return pickle.dumps({
            "__format__": "mxtpu_v2",
            "states": host_states,
            "counts": dict(self.optimizer._index_update_count),
            "num_update": self.optimizer.num_update,
            "extras": self.optimizer._resume_extras(),
        })


def get_updater(optimizer):
    """Wrap an optimizer in a fresh Updater."""
    return Updater(optimizer)
