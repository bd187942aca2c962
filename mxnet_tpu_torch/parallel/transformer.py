"""The causal-LM transformer training step on one device.

Counterpart of ``mxnet_tpu/parallel/transformer.py`` ``TransformerParallel``
on a one-device mesh: the same parameters (a flat dict, the same numpy
draws from the same seed), the same layer math (RMS norm, Q/K/V
projections, causal attention, a soft-gated MoE FFN with tanh GELU) and
the same SGD step, in PyTorch. Attention goes through
:func:`~.flash_attention.flash_attention`, whose forward and backward are
the hand-written CUDA kernels on the card and their plain versions on the
CPU.

What differs from the JAX step, and why:

* The step is eager PyTorch (forward, autograd backward, update), not one
  compiled program, and the SGD update is made in place under
  ``torch.no_grad()``: the step returns the same dict it was given, with
  its tensors updated (the JAX step donates its params for the same
  memory reason).
* On the card attention always takes the flash kernels: the JAX package's
  ``T >= 128`` threshold exists for TPU block shapes, and the CUDA kernels
  mask ragged T.
* Sharded meshes (tp, sp, ep, dp > 1) and ring attention wait for
  distribution (ROADMAP Queue A8/A10); ``make_mesh`` refuses them.

The generation engine (``serving/generation/``) runs the same layer math
through ``prefill_forward``, ``decode_forward`` and ``verify_forward``. On
the card the prefill attends with the flash forward kernel at every
bucket length; on the CPU with the reference's dense fp32 softmax.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..base import torch_dtype
from ..context import as_device
from ..convert import tensor_from_array
from .flash_attention import flash_attention

__all__ = ["TransformerParallel"]


class TransformerParallel:
    """A compact causal-LM transformer; parameters are a flat dict of leaf
    tensors on the mesh's device, and ``step_fn`` runs forward, backward
    and SGD."""

    def __init__(self, mesh, vocab=64, d_model=32, n_heads=4, n_layers=2,
                 d_ff=64, n_experts=2, dtype=np.float32):
        self.mesh = mesh
        self.cfg = dict(vocab=vocab, d_model=d_model, n_heads=n_heads,
                        n_layers=n_layers, d_ff=d_ff, n_experts=n_experts)
        self.dtype = torch_dtype(dtype)
        self.device = as_device(mesh.devices[0])
        self._step_cache = {}   # lr -> step function (identity-stable)

    def param_names(self):
        names = ["embed", "out_w"]
        for li in range(self.cfg["n_layers"]):
            names += ["l%d_%s" % (li, n) for n in
                      ("wq", "wk", "wv", "wo", "w1", "w2", "gate")]
        return names

    def _place(self, arr):
        """A numpy array as a leaf tensor of the model dtype on the
        device."""
        return tensor_from_array(arr, self.device).to(self.dtype) \
            .requires_grad_(True)

    def init(self, seed=0):
        """The JAX package's draws, in its order: one ``RandomState(seed)``
        normal draw per parameter. bf16 is rounded from the fp32 value, to
        nearest even, as ``astype(bfloat16)`` rounds the float64 draw."""
        c = self.cfg
        r = np.random.RandomState(seed)
        np_dt = np.float32 if self.dtype == torch.bfloat16 else \
            str(self.dtype).replace("torch.", "")

        def mk(shape, scale):
            return self._place((r.randn(*shape) * scale).astype(np_dt))

        d, f, e = c["d_model"], c["d_ff"], c["n_experts"]
        params = {"embed": mk((c["vocab"], d), 0.02),
                  "out_w": mk((d, c["vocab"]), 0.02)}
        for li in range(c["n_layers"]):
            p = "l%d_" % li
            params[p + "wq"] = mk((d, d), 0.02)
            params[p + "wk"] = mk((d, d), 0.02)
            params[p + "wv"] = mk((d, d), 0.02)
            params[p + "wo"] = mk((d, d), 0.02)
            params[p + "w1"] = mk((e, d, f), 0.02)
            params[p + "w2"] = mk((e, f, d), 0.02)
            params[p + "gate"] = mk((d, e), 0.02)
        return params

    # --- the model --------------------------------------------------------
    def _qkv(self, params, p, ln):
        """Q/K/V projections of a normed activation block, in the
        (B, T, H, hd) layout."""
        c = self.cfg
        B, T = ln.shape[0], ln.shape[1]
        H = c["n_heads"]
        hd = c["d_model"] // H
        q = (ln @ params[p + "wq"]).reshape(B, T, H, hd)
        k = (ln @ params[p + "wk"]).reshape(B, T, H, hd)
        v = (ln @ params[p + "wv"]).reshape(B, T, H, hd)
        return q, k, v

    def _moe_ffn(self, params, p, x):
        """MoE FFN residual delta: a soft gate over the experts."""
        ln = _rms_norm(x)
        gate = torch.softmax(ln @ params[p + "gate"], dim=-1)
        hidden = torch.einsum("btd,edf->btef", ln, params[p + "w1"])
        # jax.nn.gelu defaults to the tanh approximation
        hidden = F.gelu(hidden, approximate="tanh")
        expert_out = torch.einsum("btef,efd->bted", hidden, params[p + "w2"])
        return torch.einsum("bted,bte->btd", expert_out, gate)

    def _forward(self, params, tokens):
        c = self.cfg
        B, T = tokens.shape
        d = c["d_model"]
        x = F.embedding(tokens, params["embed"])  # (B, T, d)
        for li in range(c["n_layers"]):
            p = "l%d_" % li
            q, k, v = self._qkv(params, p, _rms_norm(x))
            q, k, v = (a.transpose(1, 2).contiguous() for a in (q, k, v))
            att = _local_attention(q, k, v, self.mesh)
            att = att.transpose(1, 2).reshape(B, T, d)
            x = x + att @ params[p + "wo"]
            x = x + self._moe_ffn(params, p, x)
        return _rms_norm(x) @ params["out_w"]

    # --- incremental decode (generation subsystem) ------------------------
    def _token_tensor(self, tokens):
        if isinstance(tokens, torch.Tensor):
            return tokens.long()
        return torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                               device=self.device)

    def prefill_forward(self, params, tokens, attend=None):
        """Causal forward over a (B, T) prompt that also returns the K/V it
        computed: ``(logits, ks, vs)``, fp32 logits (B, T, V) and stacked
        projections (L, B, T, H, hd) in the paged cache's layout. Rows at
        or past the true prompt length are padding the caller never reads.
        ``attend(li, q, k, v) -> (B, H, T, hd)`` (optional) replaces each
        layer's attention; the projections, MoE FFN and norms stay the
        shared ones."""
        c = self.cfg
        tokens = self._token_tensor(tokens)
        B, T = tokens.shape
        x = F.embedding(tokens, params["embed"])
        ks, vs = [], []
        for li in range(c["n_layers"]):
            p = "l%d_" % li
            q, k, v = self._qkv(params, p, _rms_norm(x))
            ks.append(k)
            vs.append(v)
            q, k, v = (a.transpose(1, 2).contiguous() for a in (q, k, v))
            att = (_prefill_attention(q, k, v) if attend is None
                   else attend(li, q, k, v))
            att = att.transpose(1, 2).reshape(B, T, c["d_model"])
            x = x + att @ params[p + "wo"]
            x = x + self._moe_ffn(params, p, x)
        logits = (_rms_norm(x) @ params["out_w"]).float()
        return logits, torch.stack(ks), torch.stack(vs)

    def decode_forward(self, params, tokens, attend):
        """One decode step over a slot batch: ``tokens`` (S,) each slot's
        previous token; ``attend(li, q, k_new, v_new) -> (S, H, hd)`` the
        caller's attention against its paged cache. Returns fp32 logits
        (S, V)."""
        c = self.cfg
        tokens = self._token_tensor(tokens)
        S = tokens.shape[0]
        x = F.embedding(tokens, params["embed"])  # (S, d)
        for li in range(c["n_layers"]):
            p = "l%d_" % li
            q, k, v = self._qkv(params, p, _rms_norm(x)[:, None, :])
            att = attend(li, q[:, 0], k[:, 0], v[:, 0])
            x = x + att.reshape(S, c["d_model"]) @ params[p + "wo"]
            x = x + self._moe_ffn(params, p, x[:, None, :])[:, 0]
        return (_rms_norm(x) @ params["out_w"]).float()

    def verify_forward(self, params, tokens, attend):
        """The batched verify of speculative decoding: ``tokens`` (S, Q),
        each slot's last committed token and its k draft candidates, in
        one forward; ``attend(li, q, k_new, v_new) -> (S, Q, H, hd)``, all
        in the cache's (S, Q, H, hd) layout. Returns fp32 logits
        (S, Q, V)."""
        c = self.cfg
        tokens = self._token_tensor(tokens)
        S, Q = tokens.shape
        x = F.embedding(tokens, params["embed"])  # (S, Q, d)
        for li in range(c["n_layers"]):
            p = "l%d_" % li
            q, k, v = self._qkv(params, p, _rms_norm(x))
            att = attend(li, q, k, v)
            x = x + att.reshape(S, Q, c["d_model"]) @ params[p + "wo"]
            x = x + self._moe_ffn(params, p, x)
        return (_rms_norm(x) @ params["out_w"]).float()

    def loss_fn(self, params, tokens, targets):
        logits = self._forward(params, tokens)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
        return nll.mean()

    def value_and_grad(self, params, tokens, targets):
        """``(loss, grads)``, grads a dict with the params' keys."""
        names = list(params)
        leaves = [params[n] if params[n].requires_grad
                  else params[n].requires_grad_(True) for n in names]
        with torch.enable_grad():
            loss = self.loss_fn(params, tokens, targets)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), dict(zip(names, grads))

    # --- the train step ---------------------------------------------------
    def step_fn(self, lr=0.1):
        """``(params, tokens, targets) -> (params, loss)`` with ``lr``
        bound. The update ``p - lr * g`` rounds in the param dtype, as in
        the JAX step, and is written into ``params`` in place; the same
        dict is returned. ``step_fn(lr=x) is step_fn(lr=x)``."""
        lr = float(lr)
        if lr not in self._step_cache:
            def step(params, tokens, targets, _lr=lr):
                loss, grads = self.value_and_grad(params, tokens, targets)
                with torch.no_grad():
                    for n, g in grads.items():
                        params[n].sub_(_lr * g)
                return params, loss

            self._step_cache[lr] = step
        return self._step_cache[lr]

    def shard_batch(self, tokens, targets):
        """Tokens and targets as int32 tensors on the mesh's device (one
        device: nothing to shard)."""
        def place(a):
            return tensor_from_array(a, self.device).to(torch.int32)

        return place(tokens), place(targets)

    # --- checkpoint / resume ----------------------------------------------
    def save_checkpoint(self, params, path):
        """Write the parameters to ``path`` (.npz) in the JAX package's
        layout: one array per name; bf16 as its raw 2-byte patterns (numpy
        stores ``ml_dtypes`` bfloat16 as ``V2``)."""
        host = {}
        for k, v in params.items():
            t = v.detach().cpu()
            if t.dtype == torch.bfloat16:
                host[k] = t.view(torch.int16).numpy().view("V2")
            else:
                host[k] = t.numpy()
        np.savez(path if path.endswith(".npz") else path + ".npz", **host)

    def load_checkpoint(self, path):
        """The parameter dict from a checkpoint written by either
        package, as leaf tensors of the model dtype on the device."""
        if not path.endswith(".npz"):
            path += ".npz"
        names = self.param_names()
        out = {}
        with np.load(path) as z:
            missing = set(names) - set(z.files)
            if missing:
                raise ValueError("checkpoint %r missing parameters: %s"
                                 % (path, sorted(missing)))
            for k in names:
                arr = z[k]
                if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
                    t = torch.from_numpy(arr.view(np.int16).copy()).view(
                        torch.bfloat16)
                else:
                    t = torch.from_numpy(np.ascontiguousarray(arr))
                out[k] = t.to(self.device, self.dtype).detach() \
                    .requires_grad_(True)
        return out


def _prefill_attention(q, k, v):
    """Causal attention of the generation prefill: the flash forward kernel
    on the card, at every T; on the CPU :func:`prefill_attention_reference`,
    the JAX package's formula off the TPU."""
    if q.device.type != "cpu":
        return flash_attention(q, k, v, causal=True)
    return prefill_attention_reference(q, k, v)


def prefill_attention_reference(q, k, v):
    """The reference's dense causal attention with scores, softmax and the
    P.V product in fp32, the discipline of ``paged_decode_attention``, so
    that prefill and decode agree token for token."""
    T, d = q.shape[2], q.shape[3]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (
        1.0 / math.sqrt(d))
    causal = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    w = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v.float()).to(q.dtype)


def _local_attention(q, k, v, mesh=None):
    """Causal attention of one device's heads: the flash kernels on the
    card (forward and backward, no T x T tensor in device memory), their
    plain versions on the CPU."""
    return flash_attention(q, k, v, causal=True)


def _rms_norm(x):
    x32 = x.float()
    scale = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + 1e-6)
    return (x32 * scale).to(x.dtype)
