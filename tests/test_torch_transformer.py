"""Port parity: the causal-LM transformer training slice
(mxnet_tpu_torch/parallel/transformer.py) against the JAX package's
``TransformerParallel`` on a one-device CPU mesh.

Same numpy seed, same configuration (n_experts 2, so the MoE einsums and
the gate run), same tokens: the initial parameters must be equal bit for
bit, and the loss and every parameter after two SGD steps close. Off the
TPU the JAX step attends with ``attention_reference`` (scores in the
storage dtype) and the port with its flash kernels' plain versions (fp32
scores): fp32 agrees to 1e-5 of each tensor's max |value|; in bf16 the two
round at different places, hence 2e-2.
"""
import os

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu.parallel import make_mesh as jmake_mesh
from mxnet_tpu.parallel.transformer import TransformerParallel as JTP
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import TransformerParallel, make_mesh

_CFG = dict(vocab=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
            n_experts=2)
_DTYPES = {"float32": np.dtype(np.float32),
           "bfloat16": np.dtype(ml_dtypes.bfloat16)}
_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _models(dtype):
    jmesh = jmake_mesh({"dp": 1}, devices=jax.devices("cpu")[:1])
    jtp = JTP(jmesh, dtype=_DTYPES[dtype], **_CFG)
    ttp = TransformerParallel(make_mesh({"dp": 1}, devices=[mx.cpu()]),
                              dtype=_DTYPES[dtype], **_CFG)
    return jtp, ttp


def _bits(a):
    """Raw bit patterns of an array or tensor, for bit-exact compares."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy().view(np.uint32)
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _tokens(B=2, T=16, seed=0):
    tok = np.random.RandomState(seed).randint(0, _CFG["vocab"], (B, T))
    tok = tok.astype(np.int32)
    return tok, np.roll(tok, -1, axis=1)


def _close(a, b, tol, what):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = float(np.abs(a - b).max())
    assert err <= tol * max(float(np.abs(b).max()), 1e-30), (what, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_and_weight_carrier_bit_exact(dtype):
    jtp, ttp = _models(dtype)
    jparams = jtp.init(0)
    tparams = ttp.init(0)
    carried, _ = mx.params_from_jax(jparams, device=mx.cpu())
    assert sorted(jparams) == sorted(tparams) == sorted(carried)
    for k in jparams:
        assert tparams[k].dtype == carried[k].dtype == ttp.dtype, k
        assert tparams[k].is_leaf and tparams[k].requires_grad, k
        np.testing.assert_array_equal(_bits(tparams[k]), _bits(jparams[k]),
                                      err_msg=k)
        np.testing.assert_array_equal(_bits(carried[k]), _bits(jparams[k]),
                                      err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_sgd_steps_match_jax(dtype):
    jtp, ttp = _models(dtype)
    tok, tgt = _tokens()
    jparams = jtp.init(0)
    jtok, jtgt = jtp.shard_batch(tok, tgt)
    jstep = jtp.step_fn(lr=0.1)
    tparams = ttp.init(0)
    ttok, ttgt = ttp.shard_batch(tok, tgt)
    tstep = ttp.step_fn(lr=0.1)
    assert tstep is ttp.step_fn(lr=0.1)
    for i in range(2):
        jparams, jloss = jstep(jparams, jtok, jtgt)
        same, tloss = tstep(tparams, ttok, ttgt)
        assert same is tparams  # updated in place
        assert np.isfinite(float(tloss))
        _close(float(tloss), float(jloss), _TOL[dtype], "loss %d" % i)
    for k in jparams:
        assert tparams[k].dtype == ttp.dtype
        _close(tparams[k].detach().float().numpy(),
               np.asarray(jparams[k], np.float32), _TOL[dtype], k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_written_by_either_package_loads(dtype, tmp_path):
    jtp, ttp = _models(dtype)
    jparams = jtp.init(0)
    tparams = ttp.init(0)
    with torch.no_grad():  # make the two sets differ from init
        for t in tparams.values():
            t.mul_(-2)
    jpath = os.path.join(str(tmp_path), "jax.npz")
    tpath = os.path.join(str(tmp_path), "torch")   # ".npz" is appended
    jtp.save_checkpoint(jparams, jpath)
    ttp.save_checkpoint(tparams, tpath)
    from_jax = ttp.load_checkpoint(jpath)
    for k in jparams:
        np.testing.assert_array_equal(_bits(from_jax[k]), _bits(jparams[k]),
                                      err_msg=k)
        assert from_jax[k].requires_grad
    # the same on-disk layout: one array per name, same dtype descr
    with np.load(jpath) as zj, np.load(tpath + ".npz") as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for k in zj.files:
            assert zj[k].dtype == zt[k].dtype and zj[k].shape == zt[k].shape
    if dtype == "float32":
        from_torch = jtp.load_checkpoint(tpath)
        for k in tparams:
            np.testing.assert_array_equal(_bits(from_torch[k]),
                                          _bits(tparams[k]), err_msg=k)
    else:
        # numpy stores ml_dtypes bfloat16 as raw 2-byte voids (V2) and
        # the JAX package's load casts them with np.asarray(dtype=bf16),
        # which numpy refuses: it cannot load a bf16 checkpoint from
        # either package (ROADMAP Queue C). The port reads the V2 bits.
        with pytest.raises(ValueError):
            jtp.load_checkpoint(jpath)
        again = ttp.load_checkpoint(tpath)
        for k in tparams:
            np.testing.assert_array_equal(_bits(again[k]), _bits(tparams[k]),
                                          err_msg=k)


def test_mesh_device_rules():
    # decided here, not at import: the tests are collected on machines
    # with and without a card
    if torch.cuda.is_available():
        assert make_mesh().devices[0].type == "cuda"
    else:
        with pytest.raises(MXNetError, match="CUDA is not available"):
            TransformerParallel(make_mesh(), **_CFG)
    with pytest.raises(MXNetError, match="Queue A10"):
        make_mesh({"dp": 2}, devices=[mx.cpu(), mx.cpu()])
    mesh = make_mesh(devices=mx.cpu())
    assert mesh.shape == {"dp": 1} and mesh.axis_names == ("dp",)
    tp = TransformerParallel(mesh, dtype="float32", **_CFG)
    params = tp.init(1)
    tok, tgt = tp.shard_batch(*_tokens(seed=1))
    assert tok.dtype == torch.int32 and tok.device.type == "cpu"
    step = tp.step_fn(lr=0.5)
    losses = [float(step(params, tok, tgt)[1]) for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
