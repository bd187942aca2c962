"""Port parity: ``parallel.ShardedTrainer`` of mxnet_tpu_torch against
mxnet_tpu's on a mesh of one device (the CPU, where the port's step runs
eagerly), with the fused update ops, the initializers the trainer may be
handed, checkpoints across packages and ``MXNET_BACKWARD_DO_MIRROR``.

The networks: the 16-hidden MLP of ``tests/test_parallel.py`` and the small
bottleneck ResNet of ``tests/test_torch_resnet_train.py`` (units [1, 1, 1],
32x32, 10 classes, NHWC). Both trainers ``init`` from the same seed and
start from the same bits.

Tolerances, each relative to the tensor's own max |value|:
- fp32 MLP after 3 steps, parameters, optimizer state and outputs: 1e-5;
- one update op on the same fp32 inputs: 1e-6. With bf16 weight and
  gradient and a 0-dim fp32 ``lr`` (the trainer's device scalar), the
  dtypes must be JAX's and the values within ``PROMOTED_TOL``, one bf16
  ulp (2**-8): the SGD family agrees to the bit, but the bf16 products
  of Adam's, RMSProp's and FTRL's gradient terms with Python scalars
  round differently under XLA on the CPU (measured 4.7e-4, Adam's mean);
- bf16 MLP after 3 steps: 2e-2 (sgd, and mp_sgd's fp32 master copy; the
  bf16 weight equals the master's cast to the bit). Both packages compute
  the forward and backward in bf16 but round differently: ``jax.nn.softmax``
  rounds its shifted logits, exponentials and partial sums to bf16, and
  XLA rounds ``dot`` before the bias add where ``F.linear`` rounds once,
  so a quarter of the first step's outputs sit one bf16 ulp apart and the
  master copies part by up to 7.9e-3 (fc2_bias, whose max is 0.02);
- the small ResNet's first step: outputs and new aux states 1e-5 in fp32
  and 2e-2 in bf16; its parameters after 2 steps: ``FIT_TOL`` in fp32
  (the reason is in tests/test_torch_resnet_train.py: BatchNorm's batch
  sums differ in their last bits and ReLUs amplify that) and
  ``RESNET_BF16_TOL`` in bf16. These two, and the aux states, are
  relative to max(1, max |value|): the trainer starts BatchNorm's betas
  and moving means at 0, so after a step or two they hold little more
  than one update or one batch mean of a normalised tensor (max 1.9e-4),
  a result of cancelling O(1) terms whose own max is no scale for its
  rounding (bn_data_beta after 2 fp32 steps: 6.8e-2 of its own max,
  9.2e-4 on this scale; bf16: 1.7e-2 on this scale, 0.54 of stage2's
  bn2_beta's own max, where bf16 moves it 0.40 from fp32 in the port and
  0.46 in the JAX package);
- resume in the port, ``MXNET_BACKWARD_DO_MIRROR`` and ``multi_step``:
  to the bit; checkpoints across packages: the next step within 1e-5.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu import initializer as jinit
from mxnet_tpu.ops.registry import OpAttrs as JOpAttrs
from mxnet_tpu.ops.registry import get_op as jax_get_op
from mxnet_tpu.parallel import ShardedTrainer as JaxTrainer
from mxnet_tpu.parallel import make_mesh as jax_make_mesh
from mxnet_tpu_torch import initializer as tinit
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.config import set_flag
from mxnet_tpu_torch.ops.registry import OpAttrs
from mxnet_tpu_torch.ops.registry import get_op as torch_get_op
from mxnet_tpu_torch.parallel import ShardedTrainer
from mxnet_tpu_torch.parallel import make_mesh

STEP_TOL = 1e-5
OP_TOL = 1e-6
PROMOTED_TOL = 2.0 ** -8
BF16_TOL = 2e-2
FIT_TOL = 1e-2
RESNET_BF16_TOL = 5e-2
BATCH = 8

# every _FUSED_OPT entry: (optimizer, optimizer_params, state count); the
# last three are tests/test_parallel.py's
OPTIMIZERS = [
    ("sgd", {"learning_rate": 0.1}, 0),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}, 1),
    ("mp_sgd", {"learning_rate": 0.1}, 1),
    ("mp_sgd", {"learning_rate": 0.1, "momentum": 0.9}, 2),
    ("adam", {"learning_rate": 0.01}, 2),
    ("rmsprop", {"learning_rate": 0.01}, 1),
    ("rmspropalex", {"learning_rate": 0.01}, 3),
    ("ftrl", {"learning_rate": 0.1}, 2),
]
OPT_IDS = ["sgd", "sgd_mom", "mp_sgd", "mp_sgd_mom", "adam", "rmsprop",
           "rmspropalex", "ftrl"]


def mlp(mx):
    data = mx.sym.Variable("data")
    fc1 = mx.sym.FullyConnected(data, num_hidden=16, name="fc1")
    act = mx.sym.Activation(fc1, act_type="relu")
    fc2 = mx.sym.FullyConnected(act, num_hidden=2, name="fc2")
    return mx.sym.SoftmaxOutput(fc2, name="softmax")


def small_resnet(mx):
    with mx.NameManager() if mx is tmx else mx.name.NameManager():
        return mx.models.resnet.resnet(
            units=[1, 1, 1], num_stages=3, filter_list=[16, 32, 64, 128],
            num_classes=10, image_shape=(3, 32, 32), bottle_neck=True,
            layout="NHWC")


def mlp_data(seed=1):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (BATCH, 10)).astype(np.float32)
    y = (x.sum(axis=1) > 0).astype(np.float32)
    return {"data": x, "softmax_label": y}


def resnet_data(seed=1):
    rng = np.random.RandomState(seed)
    x = rng.rand(BATCH, 32, 32, 3).astype(np.float32)
    y = (np.arange(BATCH) % 10).astype(np.float32)
    return {"data": x, "softmax_label": y}


def trainers(net, optimizer, opt_params, dtype, **kw):
    """(JAX trainer, port trainer) of ``net`` on one CPU device each."""
    jt = JaxTrainer(net(jmx), jax_make_mesh({"dp": 1},
                                            devices=jax.devices()[:1]),
                    optimizer=optimizer, optimizer_params=dict(opt_params),
                    dtype=jnp.bfloat16 if dtype == "bfloat16" else dtype,
                    **kw)
    tt = ShardedTrainer(net(tmx), make_mesh({"dp": 1}, devices=[tmx.cpu()]),
                        optimizer=optimizer,
                        optimizer_params=dict(opt_params), dtype=dtype, **kw)
    return jt, tt


def host(t):
    """A tensor of either package as fp32 numpy."""
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, dtype=np.float32)


def flat(state):
    """{name: fp32 numpy} of a state's parameters, aux and optimizer
    state."""
    out = {"arg:" + k: host(v) for k, v in state["params"].items()}
    out.update(("aux:" + k, host(v)) for k, v in state["aux"].items())
    out.update(("opt:%s/%d" % (k, i), host(s))
               for k, v in state["opt"].items() for i, s in enumerate(v))
    return out


def rel_err(got, want, floor=1e-30):
    """max |got - want| over max(floor, max |want|)."""
    return float(np.abs(got - want).max()
                 / max(float(np.abs(want).max()), floor))


def worst(got, want, prefix="", floor=1e-30):
    """(worst relative error, its name) over the names starting with
    ``prefix``."""
    errs = {k: rel_err(got[k], w, floor) for k, w in want.items()
            if k.startswith(prefix)}
    name = max(errs, key=errs.get)
    return errs[name], name


def run_both(net, data, optimizer, opt_params, dtype, n_steps, seed=7):
    """Init both trainers from ``seed`` (asserting equal bits) and run
    ``n_steps`` steps; returns (jax state, port state, jax outs, port outs,
    first-step jax outs, first-step port outs, jax trainer, port
    trainer)."""
    jt, tt = trainers(net, optimizer, opt_params, dtype)
    shapes = {k: v.shape for k, v in data.items()}
    js, ts = jt.init(shapes, seed=seed), tt.init(shapes, seed=seed)
    j0, t0 = flat(js), flat(ts)
    assert sorted(j0) == sorted(t0)
    for k in j0:
        assert np.array_equal(j0[k], t0[k]), k
    assert all(v.dtype == tt._dtype for v in ts["params"].values())
    # in fp32 the JAX package's mp_sgd master copy is the weight's own
    # buffer, which its step cannot donate twice: give it a copy
    js["opt"] = jax.tree.map(jnp.copy, js["opt"])
    jb, tb = jt.shard_batch(data), tt.shard_batch(data)
    first = None
    for _ in range(n_steps):
        js, jo = jt.step(js, jb)
        ts, to = tt.step(ts, tb)
        if first is None:
            first = ([host(o) for o in jo], [host(o) for o in to],
                     flat(js), flat(ts))
    return js, ts, jo, to, first, jt, tt


@pytest.fixture(autouse=True)
def _hermetic():
    yield
    set_flag("MXNET_BACKWARD_DO_MIRROR", None)


# ------------------------------------------------------------- the MLP

@pytest.mark.parametrize("optimizer,opt_params,n_states", OPTIMIZERS,
                         ids=OPT_IDS)
def test_mlp_fp32_matches_jax(optimizer, opt_params, n_states):
    """Each _FUSED_OPT entry through both trainers, fp32, 3 steps: the
    parameters, the optimizer state and the outputs."""
    js, ts, jo, to, _first, _jt, _tt = run_both(
        mlp, mlp_data(), optimizer, opt_params, np.float32, 3)
    err, name = worst(flat(ts), flat(js))
    assert err <= STEP_TOL, (name, err)
    assert rel_err(host(to[0]), host(jo[0])) <= STEP_TOL
    for states in ts["opt"].values():
        assert len(states) == n_states
        assert all(s.dtype == torch.float32 for s in states)


def test_mlp_bf16_sgd_matches_jax():
    js, ts, jo, to, _first, _jt, _tt = run_both(
        mlp, mlp_data(), "sgd", {"learning_rate": 0.1, "momentum": 0.9},
        "bfloat16", 3)
    for k, v in ts["params"].items():
        assert v.dtype == torch.bfloat16, k
    for k, v in ts["opt"].items():
        assert v[0].dtype == torch.float32, k
    err, name = worst(flat(ts), flat(js))
    assert err <= BF16_TOL, (name, err)
    assert rel_err(host(to[0]), host(jo[0])) <= BF16_TOL


def test_mlp_bf16_mp_sgd_matches_jax():
    js, ts, _jo, _to, _first, _jt, _tt = run_both(
        mlp, mlp_data(), "mp_sgd", {"learning_rate": 0.1, "momentum": 0.9},
        "bfloat16", 3)
    for name, (mom, master) in ts["opt"].items():
        assert master.dtype == mom.dtype == torch.float32
        w = ts["params"][name]
        assert w.dtype == torch.bfloat16
        assert torch.equal(w, master.to(torch.bfloat16)), name
    err, name = worst(flat(ts), flat(js), "opt:")
    assert err <= BF16_TOL, (name, err)


# ------------------------------------------------------ the update ops

def _op_inputs(optimizer, opt_params, n_states, dtype, seed=5):
    """(attrs kwargs, weight, grad, states) as numpy for one update op."""
    from mxnet_tpu.parallel.trainer import _FUSED_OPT

    rng = np.random.RandomState(seed)
    kw = {k: v for k, v in opt_params.items() if k != "learning_rate"}
    kw.update(wd=1e-4, rescale_grad=0.125)
    name = optimizer + ("_mom" if kw.get("momentum", 0) > 0 else "")
    if optimizer in ("sgd", "mp_sgd") and "momentum" not in kw:
        kw.pop("momentum", None)
    op_name, state_names = _FUSED_OPT[name]
    w = rng.randn(6, 5).astype(np.float32)
    g = rng.randn(6, 5).astype(np.float32)
    states = []
    for s in state_names:
        if s == "weight32":
            states.append(w.copy())
        elif s in ("n", "var"):
            states.append(rng.rand(6, 5).astype(np.float32))
        else:
            states.append(rng.randn(6, 5).astype(np.float32) * 0.1)
    assert len(states) == n_states
    return op_name, kw, w, g, states


@pytest.mark.parametrize("optimizer,opt_params,n_states", OPTIMIZERS,
                         ids=OPT_IDS)
def test_update_op_matches_jax(optimizer, opt_params, n_states):
    op_name, kw, w, g, states = _op_inputs(optimizer, opt_params, n_states,
                                           np.float32)
    lr = opt_params["learning_rate"]
    jop, top = jax_get_op(op_name), torch_get_op(op_name)
    jattrs = jop.parse_attrs(dict(kw, lr=lr))
    tattrs = top.parse_attrs(dict(kw, lr=lr))
    (jw,), jst = jop.apply(jattrs, (jnp.asarray(w), jnp.asarray(g)),
                           tuple(jnp.asarray(s) for s in states))
    (tw,), tst = top.apply(tattrs, (torch.from_numpy(w),
                                    torch.from_numpy(g)),
                           tuple(torch.from_numpy(s) for s in states))
    assert len(tst) == len(jst) == n_states
    for got, want in zip((tw,) + tuple(tst), (jw,) + tuple(jst)):
        assert rel_err(host(got), host(want)) <= OP_TOL


@pytest.mark.parametrize("optimizer,opt_params,n_states", OPTIMIZERS,
                         ids=OPT_IDS)
def test_update_op_tensor_lr_promotes_as_jax(optimizer, opt_params,
                                             n_states):
    """bf16 weight and gradient, fp32 state, and ``lr`` a 0-dim fp32
    tensor: JAX's strongly typed scalar promotes the bf16 operand, so the
    results take JAX's dtypes (a bare 0-dim torch tensor would keep
    bf16)."""
    op_name, kw, w, g, states = _op_inputs(optimizer, opt_params, n_states,
                                           "bfloat16")
    lr = np.float32(opt_params["learning_rate"])
    jop, top = jax_get_op(op_name), torch_get_op(op_name)
    jattrs = JOpAttrs(dict(jop.parse_attrs(dict(kw, lr=0.0))._d,
                           lr=jnp.asarray(lr)))
    tattrs = OpAttrs(dict(top.parse_attrs(dict(kw, lr=0.0))._d,
                          lr=torch.tensor(lr)))
    (jw,), jst = jop.apply(
        jattrs, (jnp.asarray(w, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16)),
        tuple(jnp.asarray(s) for s in states))
    (tw,), tst = top.apply(
        tattrs, (torch.from_numpy(w).to(torch.bfloat16),
                 torch.from_numpy(g).to(torch.bfloat16)),
        tuple(torch.from_numpy(s) for s in states))
    for got, want in zip((tw,) + tuple(tst), (jw,) + tuple(jst)):
        assert str(got.dtype).replace("torch.", "") == str(want.dtype)
        assert rel_err(host(got), host(want)) <= PROMOTED_TOL
    # the promotion is what separates the two: without it, sgd's update
    # would be bf16
    if op_name == "sgd_update":
        assert tw.dtype == torch.float32


@pytest.mark.parametrize("op_name,n_states", [
    ("adam_update", 2), ("rmsprop_update", 1), ("rmspropalex_update", 3),
    ("ftrl_update", 2)])
def test_update_op_through_nd(op_name, n_states):
    """``mx.nd.<op>(weight, grad, *states, out=weight)`` writes the new
    weight and states in place, as in the JAX package."""
    rng = np.random.RandomState(2)
    w, g = rng.randn(4, 3).astype(np.float32), rng.randn(4, 3)
    # the first state (n, z, mean) well above the others keeps
    # rmspropalex's n - g**2 positive
    states = [(rng.rand(4, 3) + (1.0 if i == 0 else 0.0)).astype(np.float32)
              * (1.0 if i == 0 else 0.1) for i in range(n_states)]
    got, want = [], []
    for mx, out in ((tmx, got), (jmx, want)):
        ctx = {"ctx": mx.cpu()} if mx is tmx else {}
        arrs = [mx.nd.array(a, **ctx) for a in [w, g.astype(np.float32)]
                + states]
        getattr(mx.nd, op_name)(*arrs, out=arrs[0], lr=0.05, wd=1e-3)
        out.extend(a.asnumpy() for a in [arrs[0]] + arrs[2:])
    for a, b in zip(got, want):
        assert rel_err(a, b) <= OP_TOL


# ---------------------------------------------------- the small ResNet

def test_small_resnet_fp32_matches_jax():
    js, ts, _jo, _to, first, _jt, _tt = run_both(
        small_resnet, resnet_data(), "sgd",
        {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4},
        np.float32, 2)
    jouts, touts, jfirst, tfirst = first
    assert rel_err(touts[0], jouts[0]) <= STEP_TOL
    err, name = worst(tfirst, jfirst, "aux:", floor=1.0)
    assert err <= STEP_TOL, (name, err)
    err, name = worst(flat(ts), flat(js), "arg:", floor=1.0)
    assert err <= FIT_TOL, (name, err)


def test_small_resnet_bf16_matches_jax():
    js, ts, _jo, _to, first, _jt, _tt = run_both(
        small_resnet, resnet_data(), "sgd",
        {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4},
        "bfloat16", 2)
    jouts, touts, jfirst, tfirst = first
    assert rel_err(touts[0], jouts[0]) <= BF16_TOL
    for k, v in ts["aux"].items():
        assert v.dtype == torch.float32, k
    err, name = worst(tfirst, jfirst, "aux:", floor=1.0)
    assert err <= BF16_TOL, (name, err)
    err, name = worst(flat(ts), flat(js), "arg:", floor=1.0)
    assert err <= RESNET_BF16_TOL, (name, err)


# ----------------------------------------------- multi_step, schedules

@pytest.mark.parametrize("schedule", [False, True])
def test_multi_step_equals_steps(schedule):
    lr = (lambda step: 0.1 / (1 + step)) if schedule else 0.1
    _jt, tt = trainers(small_resnet, "sgd",
                       {"learning_rate": lr, "momentum": 0.9}, np.float32)
    data = resnet_data()
    shapes = {k: v.shape for k, v in data.items()}
    batch = tt.shard_batch(data)
    state = tt.init(shapes)
    multi, losses = tt.multi_step(state, batch, 3)
    stepped, want = tt.init(shapes), []
    for _ in range(3):
        stepped, outs = tt.step(stepped, batch)
        want.append(outs[0].float().mean())
    assert multi["step"] == stepped["step"] == 3
    assert losses.dtype == torch.float32 and losses.shape == (3,)
    assert torch.equal(losses, torch.stack(want))
    got, ref = flat(multi), flat(stepped)
    for k in ref:
        assert np.array_equal(got[k], ref[k]), k


def test_lr_schedule_matches_jax():
    """A callable learning rate is evaluated per step in both packages."""
    def lr(step):
        return 0.2 * 0.5 ** step

    jt, tt = trainers(mlp, "sgd", {"learning_rate": lr, "momentum": 0.9},
                      np.float32)
    data = mlp_data()
    shapes = {k: v.shape for k, v in data.items()}
    js, jl = jt.multi_step(jt.init(shapes), jt.shard_batch(data), 3)
    ts, tl = tt.multi_step(tt.init(shapes), tt.shard_batch(data), 3)
    assert js["step"] == ts["step"] == 3
    assert np.allclose(host(tl), host(jl), rtol=0, atol=1e-6)
    err, name = worst(flat(ts), flat(js))
    assert err <= STEP_TOL, (name, err)


# --------------------------------------------------------- checkpoints

def test_resume_is_bit_identical(tmp_path):
    _jt, tt = trainers(small_resnet, "sgd",
                       {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4},
                       "bfloat16")
    data = resnet_data()
    shapes = {k: v.shape for k, v in data.items()}
    batch = tt.shard_batch(data)
    whole, _ = tt.multi_step(tt.init(shapes), batch, 3)
    part, _ = tt.multi_step(tt.init(shapes), batch, 2)
    prefix = str(tmp_path / "rn")
    tt.save_checkpoint(part, prefix, epoch=2)
    assert os.path.exists(prefix + "-symbol.json")
    _jt2, fresh = trainers(small_resnet, "sgd",
                           {"learning_rate": 0.1, "momentum": 0.9,
                            "wd": 1e-4}, "bfloat16")
    resumed = fresh.load_checkpoint(prefix, epoch=2)
    assert resumed["step"] == 2
    assert all(v.dtype == torch.bfloat16
               for v in resumed["params"].values())
    resumed, _ = fresh.step(resumed, fresh.shard_batch(data))
    got, want = flat(resumed), flat(whole)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_across_packages(writer, tmp_path):
    """A checkpoint written after 2 steps by one package resumes in the
    other: the next step's parameters within 1e-5 of the writer's own."""
    jt, tt = trainers(mlp, "sgd", {"learning_rate": 0.1, "momentum": 0.9},
                      np.float32)
    data = mlp_data()
    shapes = {k: v.shape for k, v in data.items()}
    src, dst = (jt, tt) if writer == "jax" else (tt, jt)
    state = src.init(shapes)
    for _ in range(2):
        state, _ = src.step(state, src.shard_batch(data))
    prefix = str(tmp_path / "mlp")
    src.save_checkpoint(state, prefix)
    want, _ = src.step(state, src.shard_batch(data))
    resumed = dst.load_checkpoint(prefix)
    assert resumed["step"] == 2
    got, _ = dst.step(resumed, dst.shard_batch(data))
    err, name = worst(flat(got), flat(want))
    assert err <= STEP_TOL, (name, err)


def test_checkpoint_rescale_grad_is_applied(tmp_path):
    """A checkpoint written at batch 4 carries rescale_grad 1/4; a trainer
    initialised at batch 8 applies it on load, in either package, and the
    two resumed steps agree."""
    data = mlp_data()
    shapes = {k: v.shape for k, v in data.items()}
    results = []
    for i in (0, 1):
        writer = trainers(mlp, "sgd", {"learning_rate": 0.1}, np.float32)[i]
        state = writer.init({"data": (4, 10), "softmax_label": (4,)})
        prefix = str(tmp_path / ("w%d" % i))
        writer.save_checkpoint(state, prefix)
        reader = trainers(mlp, "sgd", {"learning_rate": 0.1}, np.float32)[i]
        reader.init(shapes)
        assert reader._opt_defaults["rescale_grad"] == 1.0 / BATCH
        resumed = reader.load_checkpoint(prefix)
        assert reader._opt_defaults["rescale_grad"] == 0.25
        new, _ = reader.step(resumed, reader.shard_batch(data))
        results.append(flat(new))
    err, name = worst(results[1], results[0])
    assert err <= STEP_TOL, (name, err)


# ------------------------------------------------------------ mirroring

def test_mirror_gives_the_same_bits():
    data = resnet_data()
    shapes = {k: v.shape for k, v in data.items()}
    states = []
    for mirror in (0, 1):
        set_flag("MXNET_BACKWARD_DO_MIRROR", mirror)
        _jt, tt = trainers(small_resnet, "sgd",
                           {"learning_rate": 0.1, "momentum": 0.9},
                           np.float32)
        state, _ = tt.multi_step(tt.init(shapes), tt.shard_batch(data), 2)
        states.append(flat(state))
    for k in states[0]:
        assert np.array_equal(states[0][k], states[1][k]), k


def test_mirror_recomputes_the_forward(monkeypatch):
    """Under the flag the backward walks the forward once more."""
    from mxnet_tpu_torch.executor import _GraphProgram

    calls = []
    real = _GraphProgram._walk

    def counted(self, *args):
        calls.append(1)
        return real(self, *args)

    monkeypatch.setattr(_GraphProgram, "_walk", counted)
    data = mlp_data()
    for mirror, walks in ((0, 1), (1, 2)):
        set_flag("MXNET_BACKWARD_DO_MIRROR", mirror)
        _jt, tt = trainers(mlp, "sgd", {"learning_rate": 0.1}, np.float32)
        state = tt.init({k: v.shape for k, v in data.items()})
        del calls[:]
        tt.step(state, tt.shard_batch(data))
        assert len(calls) == walks, mirror


# ---------------------------------------------------------- initializers

INITS = {
    "orthogonal_uniform": lambda m: m.Orthogonal(),
    "orthogonal_normal": lambda m: m.Orthogonal(scale=0.9,
                                                rand_type="normal"),
    "msra": lambda m: m.MSRAPrelu(factor_type="in", slope=0.1),
    "bilinear": lambda m: m.Bilinear(),
    "lstm_bias": lambda m: m.LSTMBias(forget_bias=2.0),
}
INIT_SHAPES = {"orthogonal_uniform": (6, 4, 2), "orthogonal_normal": (3, 8),
               "msra": (8, 3, 3, 3), "bilinear": (2, 3, 4, 5),
               "lstm_bias": (16,)}


@pytest.mark.parametrize("kind", sorted(INITS))
def test_initializer_matches_jax(kind):
    out = []
    for m in (jinit, tinit):
        np.random.seed(11)
        arr = np.zeros(INIT_SHAPES[kind], np.float32)
        INITS[kind](m)._init_weight(m.InitDesc("x_weight"), arr)
        out.append(arr)
    assert np.array_equal(out[0], out[1])
    assert INITS[kind](tinit).dumps() == INITS[kind](jinit).dumps()


def test_mixed_and_load_dispatch_as_jax():
    shapes = {"fc1_weight": (5, 4), "fc1_bias": (5,), "fc2_weight": (3, 5),
              "fc2_bias": (3,)}
    saved = {"arg:fc1_weight": np.arange(20, dtype=np.float32).reshape(5, 4)}
    out = []
    for m in (jinit, tinit):
        np.random.seed(3)
        mixed = m.Mixed([".*bias", ".*"], [m.Constant(0.5), m.Uniform(0.2)])
        load = m.Load(saved, default_init=mixed)
        got = {}
        for name, shape in shapes.items():
            got[name] = np.zeros(shape, np.float32)
            load(name, got[name])
        with pytest.raises(ValueError):
            m.Mixed(["fc.*"], [m.Zero()])("other", np.zeros(2, np.float32))
        with pytest.raises(AssertionError):
            m.Load(saved)("fc2_bias", np.zeros(3, np.float32))
        out.append(got)
    for name in shapes:
        assert np.array_equal(out[0][name], out[1][name]), name
    assert np.array_equal(out[1]["fc1_weight"], saved["arg:fc1_weight"])
    # the pattern picks the initializer, whose own name dispatch then
    # zeroes a bias
    assert not out[1]["fc2_bias"].any()
    w2 = out[1]["fc2_weight"]
    assert w2.all() and (np.abs(w2) <= 0.2).all()


def test_trainer_init_takes_an_initializer():
    data = mlp_data()
    shapes = {k: v.shape for k, v in data.items()}
    jt, tt = trainers(mlp, "sgd", {"learning_rate": 0.1}, np.float32)
    js = jt.init(shapes, initializer=jinit.Orthogonal(), seed=4)
    ts = tt.init(shapes, initializer=tinit.Orthogonal(), seed=4)
    got, want = flat(ts), flat(js)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def test_fused_rnn_initializer_raises():
    with pytest.raises(MXNetError, match="A7"):
        tinit.FusedRNN(None, 8, 1, "lstm")


# ------------------------------------------------------------- surface

def test_parallel_exports_match_jax():
    import mxnet_tpu.parallel as jpar
    import mxnet_tpu_torch.parallel as tpar

    public = lambda mod: {n for n in dir(mod) if not n.startswith("_")  # noqa: E731
                          and callable(getattr(mod, n))}
    missing = public(jpar) - public(tpar)
    assert missing <= {"ring_attention", "pipeline_apply"}, missing
    for name in ("ShardedTrainer", "make_mesh", "data_parallel_sharding",
                 "replicated_sharding", "TransformerParallel",
                 "flash_attention", "attention_reference"):
        assert hasattr(tpar, name), name


def test_lower_step_raises():
    _jt, tt = trainers(mlp, "sgd", {"learning_rate": 0.1}, np.float32)
    with pytest.raises(MXNetError, match="A13"):
        tt.lower_step(None, None)


def test_trainer_rejects_an_unknown_optimizer():
    with pytest.raises(MXNetError, match="supports"):
        ShardedTrainer(mlp(tmx), make_mesh({"dp": 1}, devices=[tmx.cpu()]),
                       optimizer="lamb")


def test_shardings_on_one_device():
    from mxnet_tpu_torch.parallel import (data_parallel_sharding,
                                          replicated_sharding)
    from mxnet_tpu_torch.parallel.mesh import write_and_fence

    mesh = make_mesh({"dp": 1}, devices=[tmx.cpu()])
    dp, rep = data_parallel_sharding(mesh), replicated_sharding(mesh)
    assert dp.spec == "dp" and rep.spec is None
    assert dp.device == rep.device == torch.device("cpu")
    with pytest.raises(ValueError):
        data_parallel_sharding(mesh, "mp")
    wrote = []
    write_and_fence(lambda: wrote.append(1), "key")
    assert wrote == [1]
    _jt, tt = trainers(mlp, "sgd", {"learning_rate": 0.1}, np.float32)
    batch = tt.shard_batch({"data": np.zeros((2, 10)),
                            "softmax_label": np.zeros(2, np.int32)})
    assert batch["data"].dtype == torch.float32
    assert batch["softmax_label"].dtype == torch.int32


@pytest.mark.parametrize("dtype", ["bfloat16", torch.bfloat16,
                                   jnp.bfloat16])
def test_trainer_dtype_spellings(dtype):
    tt = ShardedTrainer(mlp(tmx), make_mesh({"dp": 1}, devices=[tmx.cpu()]),
                        dtype=dtype)
    assert tt._dtype == torch.bfloat16


def test_forward_fn_matches_jax():
    data = mlp_data()
    shapes = {k: v.shape for k, v in data.items()}
    jt, tt = trainers(mlp, "sgd", {"learning_rate": 0.1}, np.float32)
    js, ts = jt.init(shapes, seed=2), tt.init(shapes, seed=2)
    want = jt.forward_fn()(js["params"], js["aux"], jt.shard_batch(data))
    got = tt.forward_fn()(ts["params"], ts["aux"], tt.shard_batch(data))
    assert rel_err(host(got[0]), host(want[0])) <= STEP_TOL
