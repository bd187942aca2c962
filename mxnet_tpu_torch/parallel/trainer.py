"""ShardedTrainer: a Symbol's whole training step (forward, backward and the
fused optimizer update) on one device, captured once as a CUDA graph.

Counterpart of ``mxnet_tpu/parallel/trainer.py``, which compiles the step
into one jitted XLA program over a mesh (and ``multi_step`` into one
``lax.scan``). Here the step is the eager walk of the raw symbol under
autograd (``executor._GraphProgram.train_walk``, no graph passes, as in the
JAX package), the gradients from ``torch.autograd.grad`` seeded with ones,
and the registry's update op per parameter. On the card it is captured
once per batch signature (shapes and dtypes) as a ``torch.cuda.CUDAGraph``:

- the graph reads and writes the trainer's own state buffers. A state dict
  whose tensors are those buffers (what ``step`` and ``multi_step``
  return) is updated in place, as the JAX package donates its state: it
  is not valid after the next step. Any other state (``init``'s,
  ``load_checkpoint``'s, another trainer's) is copied into the buffers
  first and stays as it was;
- the batch is copied into the graph's input buffers unless it is them;
- each replay reads its learning rate from a device vector at a device step
  index that the graph advances, and writes ``mean(outputs[0])`` in fp32 to
  that index of a device loss vector, so ``multi_step(n)`` is n replays with
  no host work between them and a learning-rate schedule needs no
  recapture;
- warm-up before capture runs the step on a side stream and drops its
  results, so it advances no state (moving statistics, momentum).

On the CPU the same step body runs eagerly, without a graph. A mesh of more
than one device raises (ROADMAP.md Queue A10).
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError, torch_dtype
from ..convert import tensor_from_array
from ..executor import _GraphProgram, _grads_of
from ..ops.registry import OpAttrs, get_op
from .mesh import data_parallel_sharding, replicated_sharding

__all__ = ["ShardedTrainer"]

# optimizer name -> (update op, optimizer state names in op order)
_FUSED_OPT = {
    "sgd": ("sgd_update", ()),
    "sgd_mom": ("sgd_mom_update", ("mom",)),
    "mp_sgd": ("mp_sgd_update", ("weight32",)),
    "mp_sgd_mom": ("mp_sgd_mom_update", ("mom", "weight32")),
    "adam": ("adam_update", ("mean", "var")),
    "rmsprop": ("rmsprop_update", ("n",)),
    "rmspropalex": ("rmspropalex_update", ("n", "g", "delta")),
    "ftrl": ("ftrl_update", ("z", "n")),
}

_WARMUP_STEPS = 2      # eager steps on the side stream before a capture
_MIN_SLOTS = 256       # learning-rate / loss slots of the device vectors


class _Captured:
    """One captured step: the graph, its batch input buffers and its
    outputs (overwritten by every replay)."""

    def __init__(self, graph, batch, outs):
        self.graph = graph
        self.batch = batch
        self.outs = outs


class ShardedTrainer:
    """A Symbol's training step on a mesh of one device.

    Parameters
    ----------
    symbol : Symbol
        Loss-headed training symbol (e.g. ...SoftmaxOutput).
    mesh : parallel.Mesh
        From ``make_mesh``; one device (the card unless the caller names
        the CPU).
    optimizer : str
        'sgd' / 'mp_sgd' (momentum > 0 selects the _mom variant), 'adam',
        'rmsprop', 'rmspropalex' or 'ftrl'. 'mp_sgd' keeps an fp32 master
        copy of bf16 weights.
    optimizer_params : dict
        lr (or learning_rate; a callable of the step is a schedule), wd,
        momentum, ... forwarded to the fused update op.
    data_names / label_names : the input variable names.
    dtype : parameter and activation dtype: a numpy dtype, a torch dtype
        or a name such as ``"bfloat16"``.
    """

    def __init__(self, symbol, mesh, optimizer="sgd", optimizer_params=None,
                 data_names=("data",), label_names=("softmax_label",),
                 dp_axis="dp", dtype=np.float32):
        self.symbol = symbol
        self.mesh = mesh
        self.dp_axis = dp_axis
        self.dtype = dtype
        self._dtype = torch_dtype(dtype)
        self._prog = _GraphProgram(symbol)
        if any(node.opdef().needs_rng for node in self._prog.topo):
            raise MXNetError("ShardedTrainer: random ops in a training graph "
                             "are not yet ported (ROADMAP.md Queue A3)")
        self._input_names = [n for n in (*data_names, *label_names)
                             if n in self._prog.arg_names]
        self.param_names = [n for n in self._prog.arg_names
                            if n not in self._input_names]
        self.aux_names = list(self._prog.aux_names)

        opt_params = dict(optimizer_params or {})
        self._lr = opt_params.pop("learning_rate", opt_params.pop("lr", 0.01))
        self._user_rescale = "rescale_grad" in opt_params
        momentum = opt_params.get("momentum", 0.0)
        if optimizer in ("sgd", "mp_sgd"):
            if momentum > 0:
                optimizer += "_mom"
            else:
                opt_params.pop("momentum", None)
        if optimizer not in _FUSED_OPT:
            raise MXNetError("ShardedTrainer supports %s; got %r"
                             % (sorted(_FUSED_OPT), optimizer))
        op_name, state_names = _FUSED_OPT[optimizer]
        self._opt_opdef = get_op(op_name)
        self._opt_state_names = state_names
        # parse once with a placeholder lr to validate and fill defaults;
        # the step's lr is a device scalar spliced in per step
        self._opt_defaults = dict(
            self._opt_opdef.parse_attrs(dict(opt_params, lr=0.0))._d)
        self._label_set = set(label_names)

        self._dp_sharding = data_parallel_sharding(mesh, dp_axis)
        self._rep_sharding = replicated_sharding(mesh)
        self.device = self._rep_sharding.device
        self._graphs = {}      # batch signature -> _Captured
        self._bufs = None      # the state buffers every graph updates
        self._lrs = self._losses = self._index = None
        self._captures = 0

    # --- state initialization --------------------------------------------
    def init(self, data_shapes, initializer=None, seed=0):
        """Parameters from the initializer's numpy fill under
        ``np.random.seed(seed)``, cast to the trainer's dtype; fp32 aux
        states (``*var`` 1, else 0); fp32 zero optimizer state (the mp_sgd
        master copy is the fp32 value of the cast weight).

        ``data_shapes``: dict name -> batch shape for the data and label
        inputs. Returns the state dict used by :meth:`step`."""
        from ..initializer import InitDesc, Xavier

        initializer = initializer or Xavier(rnd_type="gaussian",
                                            factor_type="in", magnitude=2)
        if not self._user_rescale:
            # Module convention: rescale_grad = 1 / batch size
            batch = next(iter(data_shapes.values()))[0]
            self._set_rescale(1.0 / float(batch))
        arg_shapes, _, aux_shapes = self.symbol.infer_shape(**data_shapes)
        shapes = dict(zip(self._prog.arg_names, arg_shapes))
        aux_shape_d = dict(zip(self.aux_names, aux_shapes))

        np.random.seed(seed)
        params = {}
        for name in self.param_names:
            buf = np.zeros(shapes[name], dtype=np.float32)
            initializer(InitDesc(name), buf)
            params[name] = torch.from_numpy(buf).to(self._dtype) \
                .to(self.device)
        aux = {name: torch.full(aux_shape_d[name],
                                1.0 if name.endswith("var") else 0.0,
                                dtype=torch.float32, device=self.device)
               for name in self.aux_names}

        def init_state(state_name, param_name):
            if state_name == "weight32":
                return params[param_name].float()
            return torch.zeros(shapes[param_name], dtype=torch.float32,
                               device=self.device)

        opt_state = {name: tuple(init_state(s, name)
                                 for s in self._opt_state_names)
                     for name in self.param_names}
        return {"params": params, "aux": aux, "opt": opt_state, "step": 0}

    def shard_batch(self, arrays):
        """Host arrays (or tensors) onto the mesh's device: labels keep
        their dtype, data takes the trainer's."""
        out = {}
        for k, v in arrays.items():
            t = tensor_from_array(v, self._dp_sharding.device)
            out[k] = t if k in self._label_set else t.to(self._dtype)
        return out

    # --- the step ------------------------------------------------------------
    def _step_body(self, params, aux, opt_state, batch, lr):
        """One training step as a function of its inputs: (new params, new
        aux, new optimizer state, outputs). ``lr`` is a 0-dim fp32
        tensor, the JAX package's strongly typed scalar."""
        attrs = OpAttrs(dict(self._opt_defaults, lr=lr))
        arg_d = dict(batch)
        arg_d.update(params)
        outs, aux_upd, leaves = self._prog.train_walk(arg_d, aux,
                                                      self.param_names)
        grads = _grads_of(outs, leaves, [torch.ones_like(o) for o in outs])
        new_params, new_opt = {}, {}
        with torch.no_grad():
            for name in self.param_names:
                w = params[name]
                (new_w,), new_states = self._opt_opdef.apply(
                    attrs, (w, grads[name].to(w.dtype)), opt_state[name])
                # keep the weight dtype: bf16 weights with fp32 state
                new_params[name] = new_w.to(w.dtype)
                new_opt[name] = tuple(new_states)
        new_aux = dict(aux)
        new_aux.update((k, v.detach()) for k, v in aux_upd.items())
        return new_params, new_aux, new_opt, tuple(o.detach() for o in outs)

    def _lr_at(self, step):
        return self._lr(step) if callable(self._lr) else self._lr

    def _step_eager(self, state, batch):
        """The step body run eagerly on ``state`` (which it leaves as it
        was): the CPU's step, and on the card what the graph is held to."""
        lr = torch.tensor(self._lr_at(state["step"]), dtype=torch.float32,
                          device=self.device)
        params, aux, opt, outs = self._step_body(
            state["params"], state["aux"], state["opt"], batch, lr)
        return ({"params": params, "aux": aux, "opt": opt,
                 "step": state["step"] + 1}, outs)

    def step(self, state, batch):
        """One training step; returns (new state, outputs). On the card it
        is one replay of the captured step; the new state's tensors are
        the trainer's buffers (see the module docstring).

        ``batch``: dict of tensors from :meth:`shard_batch`."""
        if self.device.type != "cuda":
            return self._step_eager(state, batch)
        captured = self._prepare(state, batch, 1)
        self._set_lrs([self._lr_at(state["step"])])
        captured.graph.replay()
        return (self._state_view(state["step"] + 1),
                tuple(o.clone() for o in captured.outs))

    def multi_step(self, state, batch, n_steps):
        """``n_steps`` steps on one batch; returns (new state, the (n,)
        fp32 tensor of each step's ``mean(outputs[0])``). The schedule is
        evaluated on the host per step and read by each replay from the
        device, so the n replays need no host work between them."""
        step0 = state["step"]
        lrs = [self._lr_at(step0 + i) for i in range(n_steps)]
        if self.device.type != "cuda":
            losses = []
            for _ in range(n_steps):
                state, outs = self._step_eager(state, batch)
                losses.append(outs[0].float().mean())
            return state, torch.stack(losses)
        captured = self._prepare(state, batch, n_steps)
        self._set_lrs(lrs)
        for _ in range(n_steps):
            captured.graph.replay()
        return self._state_view(step0 + n_steps), \
            self._losses[:n_steps].clone()

    def lower_step(self, state, batch):
        """The JAX package lowers its jitted step to hand XLA's HLO to
        ``tools/hlo_layout_audit.py``; the port has no XLA program."""
        raise MXNetError("ShardedTrainer.lower_step hands XLA's HLO to "
                         "tools/hlo_layout_audit.py; the port's step is a "
                         "CUDA graph, and its audit is not yet ported "
                         "(ROADMAP.md Queue A13)")

    # --- the captured step -------------------------------------------------
    def _set_rescale(self, scale):
        if self._opt_defaults.get("rescale_grad") != scale:
            self._opt_defaults["rescale_grad"] = scale
            # a captured step baked the old value in
            self._graphs.clear()

    def _set_lrs(self, lrs):
        """The first ``len(lrs)`` slots of the learning-rate vector, and
        the step index back to 0 (both stream-ordered, no host wait)."""
        host = torch.tensor(lrs, dtype=torch.float32).pin_memory()
        self._lrs[:len(lrs)].copy_(host, non_blocking=True)
        self._index.zero_()

    def _state_view(self, step):
        b = self._bufs
        return {"params": dict(b["params"]), "aux": dict(b["aux"]),
                "opt": dict(b["opt"]), "step": step}

    def _load_state(self, state):
        """The trainer's buffers hold ``state``: allocated on first use,
        then copied into unless ``state`` holds the buffers themselves."""
        if self._bufs is None:
            self._bufs = {
                "params": {k: torch.empty_like(v, device=self.device)
                           for k, v in state["params"].items()},
                "aux": {k: torch.empty_like(v, device=self.device)
                        for k, v in state["aux"].items()},
                "opt": {k: tuple(torch.empty_like(s, device=self.device)
                                 for s in v)
                        for k, v in state["opt"].items()}}
        b = self._bufs
        pairs = [(b["params"][k], v) for k, v in state["params"].items()]
        pairs += [(b["aux"][k], v) for k, v in state["aux"].items()]
        pairs += [(bs, s) for k, v in state["opt"].items()
                  for bs, s in zip(b["opt"][k], v)]
        with torch.no_grad():
            for buf, t in pairs:
                if t is not buf:
                    buf.copy_(t)

    def _prepare(self, state, batch, n_steps):
        """Load the state and the batch into the buffers of the graph for
        this batch signature, capturing it first if there is none."""
        if self._lrs is None or self._lrs.numel() < n_steps:
            slots = max(_MIN_SLOTS, 1 << (n_steps - 1).bit_length())
            self._lrs = torch.zeros(slots, dtype=torch.float32,
                                    device=self.device)
            self._losses = torch.zeros(slots, dtype=torch.float32,
                                       device=self.device)
            self._index = torch.zeros(1, dtype=torch.int64,
                                      device=self.device)
            self._graphs.clear()   # they read the old vectors
        self._load_state(state)
        key = tuple((k, tuple(v.shape), v.dtype)
                    for k, v in sorted(batch.items()))
        captured = self._graphs.get(key)
        if captured is None:
            captured = self._graphs[key] = self._capture(batch)
        else:
            with torch.no_grad():
                for k, v in batch.items():
                    if v is not captured.batch[k]:
                        captured.batch[k].copy_(v)
        return captured

    def _capture(self, batch):
        """Capture one step over the state buffers and new batch input
        buffers. The warm-up runs on the capture's side stream (cuBLAS,
        cuDNN and the autograd engine settle there) and drops its results;
        the capture itself runs nothing."""
        static = {k: v.detach().clone() for k, v in batch.items()}
        b = self._bufs

        def body():
            lr = torch.index_select(self._lrs, 0, self._index).view(())
            return self._step_body(b["params"], b["aux"], b["opt"], static,
                                   lr)

        side = torch.cuda.Stream(device=self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(_WARMUP_STEPS):
                body()
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            params, aux, opt, outs = body()
            with torch.no_grad():
                for k, v in params.items():
                    b["params"][k].copy_(v)
                for k, v in aux.items():
                    b["aux"][k].copy_(v)
                for k, v in opt.items():
                    for buf, s in zip(b["opt"][k], v):
                        buf.copy_(s)
                self._losses.index_copy_(0, self._index,
                                         outs[0].float().mean().view(1))
                self._index.add_(1)
        self._captures += 1
        return _Captured(graph, static, outs)

    # --- checkpoint / resume ------------------------------------------------
    def save_checkpoint(self, state, prefix, epoch=0):
        """Write ``prefix-symbol.json`` and ``prefix-%04d.params`` (the
        Module checkpoint pair; bf16 parameters as fp32) and
        ``prefix-%04d.opt.npz`` (optimizer state, step count and
        rescale_grad), so training resumes exactly, in either package."""
        from .mesh import write_and_fence

        write_and_fence(lambda: self._write_checkpoint(state, prefix,
                                                       epoch),
                        "sharded_ckpt_%s_%d" % (prefix, epoch))

    def _write_checkpoint(self, state, prefix, epoch):
        from .. import ndarray as nd
        from ..ndarray.ndarray import _from_data

        self.symbol.save("%s-symbol.json" % prefix)
        save_dict = {}
        for k, v in state["params"].items():
            # bf16 round-trips exactly through fp32
            save_dict["arg:%s" % k] = _from_data(v.detach().float().cpu())
        for k, v in state["aux"].items():
            save_dict["aux:%s" % k] = _from_data(v.detach().cpu())
        nd.save("%s-%04d.params" % (prefix, epoch), save_dict)
        opt_np = {"step": np.int64(state["step"]),
                  "rescale_grad": np.float64(
                      self._opt_defaults.get("rescale_grad", 1.0))}
        for name, states in state["opt"].items():
            for i, s in enumerate(states):
                opt_np["%s/%d" % (name, i)] = _host_array(s)
        np.savez("%s-%04d.opt.npz" % (prefix, epoch), **opt_np)

    def load_checkpoint(self, prefix, epoch=0):
        """The state dict of a checkpoint written by either package, on the
        mesh's device; the next step copies it into the trainer's
        buffers, so the resumed run is bit-identical to an uninterrupted
        one."""
        from .. import ndarray as nd

        loaded = nd.load("%s-%04d.params" % (prefix, epoch))
        params, aux = {}, {}
        for k, v in loaded.items():
            tag, name = k.split(":", 1)
            if tag == "arg":
                params[name] = v._data.to(self.device, self._dtype)
            else:
                aux[name] = v._data.to(self.device)
        missing = set(self.param_names) - set(params)
        if missing:
            raise MXNetError("checkpoint %r is missing parameters: %s"
                             % (prefix, sorted(missing)))
        with np.load("%s-%04d.opt.npz" % (prefix, epoch)) as z:
            step = int(z["step"])
            if not self._user_rescale and "rescale_grad" in z:
                # init() derives it from the batch size; a resumed trainer
                # applies the checkpoint's without init()
                self._set_rescale(float(z["rescale_grad"]))
            opt_state = {name: tuple(
                _device_array(z["%s/%d" % (name, i)], self.device)
                for i in range(len(self._opt_state_names)))
                for name in self.param_names}
        return {"params": params, "aux": aux, "opt": opt_state,
                "step": step}

    # --- inference ----------------------------------------------------------
    def forward_fn(self):
        """The inference forward over the raw graph:
        ``fwd(params, aux, batch) -> outputs``."""
        infer = self._prog.infer_fn()

        def fwd(params, aux, batch):
            arg_d = dict(batch)
            arg_d.update(params)
            return infer(arg_d, aux)

        return fwd


def _host_array(t):
    """A tensor as numpy; bf16 as its raw 2-byte patterns (``V2``), as
    numpy stores the JAX package's ``ml_dtypes`` bfloat16."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def _device_array(arr, device):
    """:func:`_host_array`'s inverse, onto ``device``."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return torch.from_numpy(arr.view(np.int16).copy()) \
            .view(torch.bfloat16).to(device)
    return tensor_from_array(arr, device)
