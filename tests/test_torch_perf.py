"""The port's roofline attribution (observability/perf.py) against the JAX
package's, on the CPU.

* ``node_cost`` / ``program_cost``: the same symbols and shapes through
  both packages give the same FLOPs, bytes and per-op rows, exactly:
  convolution NCHW and NHWC, FullyConnected, ``batch_dot``, movement ops,
  the resnet-toy zoo graph, and the ``_FusedRegion`` rows the bind-time
  graph passes carve (an inference ``Executor``'s program cost).
* the calibration table (``autotune.cost_model``): one ceiling per compute
  dtype, the card's fingerprint, the ridge and roofline on it.
* the step waterfall of ``Module.fit``: its segments sum to the wall, one
  program note per step, the cost walk memoized (0 steady-state walks).
* the ledger: the same rows through both packages' ``ledger_verdict``.
"""
import re

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.observability import perf as jperf
from mxnet_tpu_torch.autotune import cost_model
from mxnet_tpu_torch.config import set_flag
from mxnet_tpu_torch.observability import metrics as tmetrics
from mxnet_tpu_torch.observability import perf as tperf

_ROW_KEYS = ("name", "op", "flops", "bytes", "out_bytes")


@pytest.fixture(autouse=True)
def _perf_reset():
    tperf.reset()
    yield
    tperf.reset()


def _walk(perf, sym, var_shapes, dtype_bytes=4, train=False):
    topo = [n for n in sym.topo_nodes() if not n.is_variable]
    return perf.program_cost(sym, topo, var_shapes, dtype_bytes=dtype_bytes,
                             train=train, graph="test")


def _base(name):
    # each package numbers its auto-named nodes from its own counter
    return re.sub(r"\d+$", "", name)


def _rows(cost):
    return [dict({k: r[k] for k in _ROW_KEYS}, name=_base(r["name"]))
            for r in cost["ops"]]


def _same_cost(build, var_shapes, dtype_bytes=4, train=False):
    """Walk the symbol ``build(mx)`` builds in each package; assert the
    totals and per-op rows equal exactly; return the port's cost."""
    j = _walk(jperf, build(jmx), var_shapes, dtype_bytes, train)
    t = _walk(tperf, build(tmx), var_shapes, dtype_bytes, train)
    assert t["flops"] == j["flops"]
    assert t["hbm_bytes"] == j["hbm_bytes"]
    assert _rows(t) == _rows(j)
    return t


def _conv_nchw(mx):
    return mx.sym.Convolution(mx.sym.var("data"), kernel=(3, 3),
                              num_filter=16, pad=(1, 1), name="conv")


def _conv_nhwc(mx):
    return mx.sym.Convolution(mx.sym.var("data"), kernel=(2, 2),
                              num_filter=8, no_bias=True, layout="NHWC",
                              name="conv")


def _fc(mx):
    return mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=6, name="fc")


def _fc_no_flatten(mx):
    return mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=7,
                                 flatten=False, no_bias=True, name="fc")


def _batch_dot(mx):
    return mx.sym.batch_dot(mx.sym.var("a"), mx.sym.var("b"))


def _movement(mx):
    return mx.sym.Flatten(mx.sym.Reshape(mx.sym.var("data"), shape=(2, -1)),
                          name="flat")


_CASES = {
    # (symbol maker, var shapes, the single row's hand count (flops, bytes))
    "conv_nchw": (_conv_nchw, {"data": (2, 3, 8, 8),
                               "conv_weight": (16, 3, 3, 3),
                               "conv_bias": (16,)},
                  (2 * 27 * 2048 + 2048,
                   (2 * 3 * 8 * 8 + 16 * 27 + 16 + 2048) * 4)),
    "conv_nhwc": (_conv_nhwc, {"data": (1, 8, 8, 4),
                               "conv_weight": (2, 2, 4, 8)},
                  (2 * 16 * 7 * 7 * 8,
                   (8 * 8 * 4 + 2 * 2 * 4 * 8 + 7 * 7 * 8) * 4)),
    "fc": (_fc, {"data": (4, 2, 5), "fc_weight": (6, 10), "fc_bias": (6,)},
           (2 * 10 * 24 + 24, (40 + 60 + 6 + 24) * 4)),
    "fc_no_flatten": (_fc_no_flatten, {"data": (3, 5, 4),
                                       "fc_weight": (7, 4)},
                      (2 * 4 * 105, (60 + 28 + 105) * 4)),
    "batch_dot": (_batch_dot, {"a": (2, 3, 4), "b": (2, 4, 5)},
                  (2 * 4 * 30, (24 + 40 + 30) * 4)),
}


@pytest.mark.parametrize("case", sorted(_CASES))
@pytest.mark.parametrize("dtype_bytes", [4, 2])
def test_node_rules_equal_and_hand_counted(case, dtype_bytes):
    build, shapes, (flops, nbytes) = _CASES[case]
    cost = _same_cost(build, shapes, dtype_bytes=dtype_bytes)
    row = cost["ops"][-1]
    assert row["flops"] == flops
    assert row["bytes"] == nbytes // 4 * dtype_bytes
    assert cost["compute_dtype"] == ("bfloat16" if dtype_bytes == 2
                                     else "float32")


def test_movement_ops_are_zero_flops():
    cost = _same_cost(_movement, {"data": (2, 3, 4)})
    assert all(r["flops"] == 0 for r in cost["ops"])
    assert all(r["bound"] == "bandwidth" for r in cost["ops"])


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("backward", [False, True])
def test_flash_attention_cost_equal(causal, backward):
    args = dict(B=2, H=8, T=1024, D=64, causal=causal, dtype_bytes=2,
                backward=backward)
    assert tperf.flash_attention_cost(**args) == \
        jperf.flash_attention_cost(**args)
    flops, nbytes = tperf.flash_attention_cost(2, 8, 1024, 64,
                                               causal=False)
    assert flops == 4 * 2 * 8 * 1024 * 1024 * 64
    assert nbytes == 4 * 2 * 8 * 1024 * 64 * 2


def _toy_resnet_shapes(mx):
    sym = mx.models.get_resnet(num_classes=10, num_layers=8,
                               image_shape=(3, 16, 16))
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(2, 3, 16, 16),
                                                softmax_label=(2,))
    shapes = dict(zip(sym.list_arguments(), map(tuple, arg_shapes)))
    shapes.update(zip(sym.list_auxiliary_states(), map(tuple, aux_shapes)))
    return shapes


@pytest.mark.parametrize("train", [False, True])
def test_resnet_toy_zoo_graph_exact(train):
    shapes = _toy_resnet_shapes(jmx)
    assert shapes == _toy_resnet_shapes(tmx)
    cost = _same_cost(lambda mx: mx.models.get_resnet(
        num_classes=10, num_layers=8, image_shape=(3, 16, 16)),
        shapes, train=train)
    fwd = _walk(tperf, tmx.models.get_resnet(
        num_classes=10, num_layers=8, image_shape=(3, 16, 16)), shapes)
    if train:
        assert cost["flops"] == tperf.TRAIN_FLOPS_MULT * fwd["flops"]
        assert cost["hbm_bytes"] == tperf.TRAIN_BYTES_MULT * fwd["hbm_bytes"]
    assert cost["fusion_candidates"] == tperf.fusion_candidates(cost["ops"])
    # the ranking rule is the JAX package's: its candidates over the
    # port's rows (its ridge is its own chip's) equal the port's
    assert jperf.fusion_candidates(cost["ops"]) == cost["fusion_candidates"]


def _bind_cost(mx, sym, shapes, seed=0):
    """An inference bind on the CPU (the graph passes run: prune, bn_fold,
    fuse) and its program's cost at the bound shapes."""
    rng = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    args = {n: mx.nd.array(rng.rand(*s).astype(np.float32), ctx=mx.cpu())
            for n, s in zip(sym.list_arguments(), arg_shapes)}
    aux = {n: mx.nd.array(rng.rand(*s).astype(np.float32) + 0.5,
                          ctx=mx.cpu())
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    ex = sym.bind(mx.cpu(), args, args_grad=None, grad_req="null",
                  aux_states=aux)
    return ex.perf_program_cost(is_train=False)


@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
def test_fused_region_program_cost_after_graph_passes(layout):
    image = (16, 16, 3) if layout == "NHWC" else (3, 16, 16)
    shapes = {"data": (2,) + image}

    def build(mx):
        return mx.models.get_resnet(num_classes=10, num_layers=8,
                                    image_shape=(3, 16, 16), layout=layout)

    j = _bind_cost(jmx, build(jmx), shapes)
    t = _bind_cost(tmx, build(tmx), shapes)
    assert t["graph"] == j["graph"]
    assert (t["flops"], t["hbm_bytes"]) == (j["flops"], j["hbm_bytes"])
    assert _rows(t) == _rows(j)
    assert [(len(r["members"]), r["saved_bytes"])
            for r in t["fused_regions"]] == \
        [(len(r["members"]), r["saved_bytes"]) for r in j["fused_regions"]]
    assert t["fused_saved_bytes"] == j["fused_saved_bytes"]
    assert any(r["op"] == "_FusedRegion" for r in t["ops"])
    fused = [r for r in t["ops"] if r.get("fused")]
    assert [r["interior_saved_bytes"] for r in fused] == \
        [r["interior_saved_bytes"] for r in j["ops"] if r.get("fused")]


def test_mlp_train_program_cost_equal():
    def build(mx):
        data = mx.sym.Variable("data")
        fc1 = mx.sym.Activation(mx.sym.FullyConnected(
            data, num_hidden=512, name="o1"), act_type="relu")
        return mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
            fc1, num_hidden=16, name="o2"), name="softmax")

    shapes = {"data": (128, 64), "softmax_label": (128,),
              "o1_weight": (512, 64), "o1_bias": (512,),
              "o2_weight": (16, 512), "o2_bias": (16,)}
    cost = _same_cost(build, shapes, train=True)
    assert cost["mode"] == "train"


def _tanh_mlp(mx):
    data = mx.sym.Variable("data")
    fc1 = mx.sym.FullyConnected(data, num_hidden=32, name="o1")
    return mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        mx.sym.tanh(fc1), num_hidden=8, name="o2"), name="softmax")


def _bound_train_cost(inputs_need_grad, passes="-fuse"):
    from mxnet_tpu_torch import graph_pass

    graph_pass.set_passes(passes)
    try:
        mod = tmx.mod.Module(_tanh_mlp(tmx), context=tmx.cpu())
        mod.bind(data_shapes=[("data", (16, 12))],
                 label_shapes=[("softmax_label", (16,))],
                 inputs_need_grad=inputs_need_grad)
        mod.init_params()
        ex = mod._exec_group.execs[0]
        prog = ex._train_program()
        arg_d, aux_d = ex._feeds(prog)
        shapes = {n: tuple(v.shape) for n, v in arg_d.items()}
        return ex.perf_program_cost(True), prog, shapes
    finally:
        graph_pass.set_passes(None)


def test_bound_train_cost_with_every_argument_on_the_path_is_the_rule():
    """A bind whose data takes a gradient runs every backward product:
    the executor's program cost is program_cost's 3x rule, which is the
    JAX package's."""
    cost, prog, shapes = _bound_train_cost(True)
    j = _walk(jperf, _tanh_mlp(jmx), shapes, train=True)
    assert (cost["flops"], cost["hbm_bytes"]) == (j["flops"], j["hbm_bytes"])
    assert _rows(cost) == _rows(j)
    assert cost["compute_dtype"] == "float32"


def test_bound_train_cost_drops_the_data_gradient_it_never_computes():
    """Without inputs_need_grad the first FullyConnected has no data
    gradient: it pays its forward and its weight gradient, every other
    node the 3x rule; the rows stay the forward walk's."""
    cost, prog, shapes = _bound_train_cost(False)
    fwd = _walk(tperf, prog.symbol, shapes)
    rows = {r["name"]: r for r in fwd["ops"]}
    o1 = rows["o1"]
    assert cost["flops"] == 3 * fwd["flops"] - o1["flops"]
    assert cost["hbm_bytes"] == 3 * fwd["hbm_bytes"] - o1["bytes"]
    assert _rows(cost) == _rows(fwd)
    full, _prog, _shapes = _bound_train_cost(True)
    assert cost["flops"] < full["flops"]


def test_bound_cost_compute_dtype_is_the_contractions_after_amp():
    """An amp program keeps fp32 arguments but multiplies in bf16: its
    compute dtype (the MFU ceiling) is bfloat16, training and inference;
    the byte rule's dtype stays the bound tensors'."""
    cost, _prog, _shapes = _bound_train_cost(False, "default,amp")
    assert cost["compute_dtype"] == "bfloat16"
    assert cost["dtype_bytes"] == 4
    assert cost["ridge_intensity"] == cost_model.ridge_intensity("bfloat16")


# ------------------------------------------------- the calibration table

def test_ceilings_per_compute_dtype():
    c = cost_model.CEILINGS
    assert set(c["matmul_tf_s"]) == {"float32", "bfloat16"}
    assert c["spec_matmul_tf_s"] == {"float32": 67.0, "bfloat16": 989.0}
    assert c["spec_hbm_gb_s"] == 3350.0
    assert c["card"].startswith("NVIDIA H100")
    # measured below spec on every dtype: achieved-of-attainable
    for dt in ("float32", "bfloat16"):
        assert 0 < c["matmul_tf_s"][dt] < c["spec_matmul_tf_s"][dt]
    assert 0 < c["hbm_gb_s"] < c["spec_hbm_gb_s"]
    assert cost_model.compute_dtype(2) == "bfloat16"
    assert cost_model.compute_dtype(4) == "float32"
    ridge = cost_model.ridge_intensity("float32")
    assert ridge == (c["matmul_tf_s"]["float32"] * 1e12
                     / (c["hbm_gb_s"] * 1e9))
    assert cost_model.roofline_seconds(ridge * 1e9, 1e9) == \
        pytest.approx(1e9 / (c["hbm_gb_s"] * 1e9))


def test_roofline_basis_is_cost_model():
    cost = _walk(tperf, _fc(tmx), {"data": (4, 2, 5), "fc_weight": (6, 10),
                                   "fc_bias": (6,)}, dtype_bytes=2)
    assert cost["roofline_s"] == cost_model.roofline_seconds(
        cost["flops"], cost["hbm_bytes"], "bfloat16")
    assert cost["ridge_intensity"] == cost_model.ridge_intensity("bfloat16")


def test_fusion_candidates_ranked_by_saved_bytes():
    rows = [
        {"name": "a", "op": "Activation", "flops": 10, "bytes": 100,
         "out_bytes": 40, "bound": "bandwidth"},
        {"name": "b", "op": "Activation", "flops": 10, "bytes": 100,
         "out_bytes": 30, "bound": "bandwidth"},
        {"name": "mm", "op": "dot", "flops": 10**9, "bytes": 10,
         "out_bytes": 10, "bound": "compute"},
        {"name": "c", "op": "softmax", "flops": 10, "bytes": 100,
         "out_bytes": 25, "bound": "bandwidth"},
        {"name": "d", "op": "Activation", "flops": 10, "bytes": 100,
         "out_bytes": 20, "bound": "bandwidth"},
    ]
    cands = tperf.fusion_candidates(rows)
    assert cands == jperf.fusion_candidates(rows)
    assert [c["ops"] for c in cands] == [["a", "b"], ["c", "d"]]
    assert cands[0]["saved_bytes"] == 2 * 40


# ------------------------------------------------- the fit-loop waterfall

def _mlp(mx, hidden=16):
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=hidden, name="fc1")
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, num_hidden=4, name="fc2")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def _toy_fit(steps=3, bs=8, epochs=1):
    rng = np.random.RandomState(0)
    x = rng.rand(bs * steps, 10).astype(np.float32)
    y = rng.randint(0, 4, bs * steps).astype(np.float32)
    with tmx.cpu():
        it = tmx.io.NDArrayIter(x, y, batch_size=bs,
                                label_name="softmax_label")
        mod = tmx.mod.Module(_mlp(tmx), context=tmx.cpu())
        mod.fit(it, num_epoch=epochs, optimizer="sgd",
                optimizer_params=(("learning_rate", 0.1),))
    return mod


def test_waterfall_partition_exact():
    _toy_fit(steps=3)
    falls = tperf.waterfalls()
    assert len(falls) == 3
    for rec in falls:
        assert rec["host_s"] == rec["wall_s"] - (rec["data_wait_s"]
                                                 + rec["device_s"]
                                                 + rec["kvstore_s"])
        parts = (rec["data_wait_s"] + rec["device_s"] + rec["kvstore_s"]
                 + rec["host_s"])
        assert abs(parts - rec["wall_s"]) < 1e-9
        assert rec["data_wait_s"] > 0   # the lookahead timed next()
        assert rec["device_s"] > 0      # the program's wall on the CPU
        assert rec["wall_s"] > rec["device_s"]
        # one program note per step (the group notes once)
        assert rec["programs"] == 1
        # a CPU run is not held to the card's ceilings
        assert rec["mfu_pct"] is None
    assert [r["step"] for r in falls] == [1, 2, 3]


def test_fit_populates_program_attribution():
    mod = _toy_fit(steps=4, epochs=2)
    progs = tperf.program_table()
    assert len(progs) == 1
    p = progs[0]
    assert p["mode"] == "train"
    assert p["flops"] > 0 and p["hbm_bytes"] > 0
    assert p["runs"] == 7 and p["warmup_runs"] == 1
    assert p["mfu_pct"] is None and p["device_ms_ema"] > 0
    assert p["residual"] is not None and p["residual"] > 0
    assert p["ops_top"] and p["fusion_candidates"] is not None
    assert not tperf.step_active()
    # the step index runs on across epochs
    assert [r["step"] for r in tperf.waterfalls()] == list(range(1, 9))
    # the note's cost is the executor's memoized program cost
    ex = mod._exec_group.execs[0]
    assert p["flops"] == ex.perf_program_cost(is_train=True)["flops"]


def test_steady_state_steps_do_no_cost_walk():
    mod = _toy_fit(steps=2)
    ex = mod._exec_group.execs[0]
    prog = ex._train_program()
    walks = len(prog._perf_costs)
    assert walks == 1
    rng = np.random.RandomState(1)
    with tmx.cpu():
        batch = tmx.io.DataBatch(
            data=[tmx.nd.array(rng.rand(8, 10).astype(np.float32))],
            label=[tmx.nd.array(rng.randint(0, 4, 8).astype(np.float32))])
        for i in range(5):
            tperf.step_begin()
            mod.forward_backward(batch)
            mod.update()
            tperf.step_end(step=i)
    assert len(prog._perf_costs) == walks


def test_scope_suspended_hides_and_restores():
    tperf.step_begin()
    assert tperf.step_active()
    with tperf.scope_suspended():
        assert not tperf.step_active()
        tperf.note_kv(1.0)  # swallowed: no scope visible
    assert tperf.step_active()
    rec = tperf.step_end(step=1)
    assert rec["kvstore_s"] == 0.0


def test_kvstore_segment_accounted():
    tperf.step_begin()
    tperf.note_kv(0.25)
    tperf.note_kv(0.25)
    tperf.note_data_wait(0.125)
    rec = tperf.step_end(step=1)
    assert rec["kvstore_s"] == 0.5
    assert rec["data_wait_s"] == 0.125
    assert rec["host_s"] == rec["wall_s"] - (0.5 + 0.125)


def test_warmup_run_does_not_publish_program_gauge():
    tmetrics.set_enabled(True)
    try:
        cost = {"graph": "g", "mode": "train", "flops": 10 ** 9,
                "hbm_bytes": 10 ** 6, "roofline_s": 1e-4,
                "ridge_intensity": 17.6, "basis": "forward walk",
                "compute_dtype": "float32", "ops": [],
                "fusion_candidates": []}
        before = tmetrics.get_value("perf.mfu_pct", None,
                                    labels={"scope": "program"})
        tperf.note_program_run(cost, device_s=1e-3, host_s=1e-3)
        assert tmetrics.get_value("perf.mfu_pct", None,
                                  labels={"scope": "program"}) == before
        tperf.note_program_run(cost, device_s=1e-3, host_s=1e-3)
        mfu = tmetrics.get_value("perf.mfu_pct", 0,
                                 labels={"scope": "program"})
        want = 100.0 * 1e12 / (cost_model.MEASURED_MATMUL_TF["float32"]
                               * 1e12)
        assert mfu == pytest.approx(want)
        p = tperf.program_table()[0]
        assert p["mfu_spec_pct"] == pytest.approx(100.0 * 1e12 / 67e12)
    finally:
        tmetrics.reset_metrics()
        tmetrics.set_enabled(False)


def test_perf_disabled_is_inert():
    set_flag("MXNET_PERF", 0)
    try:
        _toy_fit(steps=2)
        assert tperf.waterfalls() == []
        assert tperf.program_table() == []
    finally:
        set_flag("MXNET_PERF", None)


def test_summary_brief_and_provider():
    assert tperf.summary() is None
    brief = tperf.summary_brief()
    assert brief["programs"] == 0 and brief["waterfall"] is None
    _toy_fit(steps=2)
    s = tperf.summary()
    assert s["ceilings"]["card"] == cost_model.CARD
    assert len(s["programs"]) == 1 and len(s["waterfalls"]) == 2
    brief = tperf.summary_brief()
    assert brief["programs"] == 1 and brief["waterfall"]["step"] == 2
    from mxnet_tpu_torch.observability import flight_recorder

    assert flight_recorder.provider_sections()["perf"]["programs"]


# ------------------------------------------------------------- ledger

def _verdicts(rows):
    t, j = tperf.ledger_verdict(rows), jperf.ledger_verdict(rows)
    assert t == j
    return t


def test_ledger_round_trip_and_verdict(tmp_path):
    path = str(tmp_path / "ledger.jsonl")
    row = {"ts": "t1", "quick": True, "fingerprint": {"device": "cpu"},
           "benches": {"a": {"value": 100.0, "unit": "x", "mfu_pct": 27.9},
                       "b": {"value": 5.0, "unit": "x"}},
           "programs": [{"graph": "g", "mode": "train", "flops": 123,
                         "hbm_bytes": 456, "roofline_ms": 0.1,
                         "residual": 2.0}]}
    tperf.append_ledger(row, path)
    tperf.append_ledger(dict(row, ts="t2"), path)
    rows = tperf.read_ledger(path)
    assert rows == jperf.read_ledger(path)
    assert [r["ts"] for r in rows] == ["t1", "t2"]
    assert _verdicts(rows)["verdict"] == "ok"
    bad = dict(row, ts="t3", benches={"a": {"error": "RuntimeError"},
                                      "b": {"value": 5.0, "unit": "x"}})
    tperf.append_ledger(bad, path)
    v = _verdicts(tperf.read_ledger(path))
    assert v["verdict"] == "regression"
    assert any("newly failing" in r for r in v["regressions"])


def test_ledger_flags_analytic_drift_and_throughput_warning(tmp_path):
    path = str(tmp_path / "l.jsonl")
    base = {"ts": "t1", "quick": True, "fingerprint": {"device": "cpu"},
            "benches": {"a": {"value": 100.0, "unit": "x"}},
            "programs": [{"graph": "g", "mode": "train", "flops": 100,
                          "hbm_bytes": 200}]}
    tperf.append_ledger(base, path)
    tperf.append_ledger(dict(base, ts="t2",
                             benches={"a": {"value": 50.0, "unit": "x"}},
                             programs=[{"graph": "g", "mode": "train",
                                        "flops": 101, "hbm_bytes": 200}]),
                        path)
    v = _verdicts(tperf.read_ledger(path))
    assert v["verdict"] == "regression"
    assert any("analytic flops drift" in r for r in v["regressions"])
    assert any("throughput" in w for w in v["warnings"])


def test_ledger_incomparable_rows_and_corrupt_lines(tmp_path):
    path = str(tmp_path / "l.jsonl")
    tperf.append_ledger({"ts": "t1", "quick": False,
                         "fingerprint": {"device": "NVIDIA H100"},
                         "benches": {"a": {"value": 1.0, "unit": "x"}}},
                        path)
    with open(path, "a") as f:
        f.write("{truncated\n")
    tperf.append_ledger({"ts": "t2", "quick": True,
                         "fingerprint": {"device": "cpu"},
                         "benches": {"a": {"error": "boom"}}}, path)
    rows = tperf.read_ledger(path)
    assert [r["ts"] for r in rows] == ["t1", "t2"]
    v = _verdicts(rows)
    assert v["verdict"] == "ok" and "note" in v
