"""Port parity for CTC on the CPU: the ``ctc_loss`` op
(``_contrib_CTCLoss``, ``contrib_ctc_loss``) and ``gluon.loss.CTCLoss``,
against the JAX package's on the same seeded numpy inputs.

The op's conventions are the JAX package's: pre-softmax (T, N, C) input,
the per-sample loss in float64 (the JAX package's recursion runs in
float64); blank 0 with 0-padded labels (``first``) or blank C-1
with -1-padded labels (``last``); data and label lengths; an infeasible
alignment costs about 1e30 (log-space minus infinity is -1e30), not inf; a
zero-length label costs the all-blank path. Losses and input gradients
within 1e-5 of each tensor's max (fp32). ``CTCLoss`` is held through both
pred layouts and both label layouts, imperative and hybridized, with and
without the length inputs, and the CPU route against
``torch.nn.functional.ctc_loss`` where the library defines the loss.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx

TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, what=""):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= TOL * (scale if scale > 0 else 1.0), \
        "%s: %.3g against max %.3g" % (what, err, scale)


def _labels(seed, n, lmax, classes, blank_label="first", lens=None):
    """(N, lmax) labels in [1, C) ("first", 0-padded) or [0, C-1)
    ("last", -1-padded), and their lengths."""
    r = np.random.RandomState(seed)
    lens = r.randint(1, lmax + 1, n) if lens is None else np.asarray(lens)
    pad = 0 if blank_label == "first" else -1
    lo, hi = (1, classes) if blank_label == "first" else (0, classes - 1)
    lab = np.full((n, lmax), pad, np.float32)
    for i, k in enumerate(lens):
        lab[i, :k] = r.randint(lo, hi, k)
    return lab, lens.astype(np.float32)


def _op_run(mx, arrays, attrs, seed=9):
    ctx = {"ctx": tmx.cpu()} if mx is tmx else {}
    ins = [mx.nd.array(a, **ctx) for a in arrays]
    ins[0].attach_grad()
    with mx.autograd.record():
        out = mx.nd.ctc_loss(*ins, **attrs)
    rng = np.random.RandomState(seed)
    out.backward(mx.nd.array(rng.rand(*out.shape) + 0.5, dtype="float64",
                             **ctx))
    return out.asnumpy(), ins[0].grad.asnumpy()


def _data(seed, T, N, C):
    return np.random.RandomState(seed).randn(T, N, C).astype(np.float32)


def _case_plain():
    lab, _ = _labels(2, 4, 5, 7)
    return [_data(1, 12, 4, 7), lab], {}


def _case_last():
    lab, _ = _labels(4, 3, 4, 6, "last")
    return [_data(3, 10, 3, 6), lab], dict(blank_label="last")


def _case_lengths():
    lab, lens = _labels(6, 4, 6, 8)
    return ([_data(5, 15, 4, 8), lab,
             np.array([15, 11, 9, 14], np.float32), lens],
            dict(use_data_lengths=True, use_label_lengths=True))


def _case_data_lengths_last():
    lab, _ = _labels(8, 3, 3, 5, "last")
    return ([_data(7, 9, 3, 5), lab, np.array([9, 6, 7], np.float32)],
            dict(use_data_lengths=True, blank_label="last"))


def _case_repeats():
    """Repeated labels need a blank between them."""
    lab = np.array([[2, 2, 3, 3], [1, 1, 1, 0], [4, 0, 0, 0]], np.float32)
    return [_data(9, 8, 3, 5), lab], {}


def _case_infeasible():
    """Sample 0's label (length 5, two repeats) needs 7 steps of 6; sample
    1's 5 with its repeat needs 6 of 4 data steps."""
    lab = np.array([[1, 1, 2, 2, 3], [3, 3, 1, 2, 0], [2, 0, 0, 0, 0]],
                   np.float32)
    return ([_data(10, 6, 3, 4), lab, np.array([6, 4, 6], np.float32)],
            dict(use_data_lengths=True))


def _case_zero_length():
    lab = np.array([[0, 0, 0], [2, 1, 0], [0, 0, 0]], np.float32)
    return [_data(11, 7, 3, 4), lab], {}


def _case_zero_length_given():
    lab = np.array([[3, 1, 2], [2, 1, 3]], np.float32)
    return ([_data(12, 6, 2, 4), lab, np.array([0, 2], np.float32)],
            dict(use_label_lengths=True))


CASES = {"plain": _case_plain, "blank-last": _case_last,
         "lengths": _case_lengths,
         "data-lengths-last": _case_data_lengths_last,
         "repeats": _case_repeats, "infeasible": _case_infeasible,
         "zero-length": _case_zero_length,
         "zero-length-given": _case_zero_length_given}


@pytest.mark.parametrize("case", list(CASES))
def test_ctc_loss_matches_the_reference(case):
    arrays, attrs = CASES[case]()
    want, want_g = _op_run(jmx, arrays, attrs)
    got, got_g = _op_run(tmx, arrays, attrs)
    _close(got, want, "loss")
    _close(got_g, want_g, "data gradient")


def test_infeasible_alignment_costs_1e30_not_inf():
    arrays, attrs = _case_infeasible()
    loss, grad = _op_run(tmx, arrays, attrs)
    assert np.isfinite(loss).all() and np.isfinite(grad).all()
    assert loss[0] >= 1e29 and loss[1] >= 1e29 and loss[2] < 1e3


def test_zero_length_label_costs_the_all_blank_path():
    arrays, _attrs = _case_zero_length()
    data = torch.from_numpy(arrays[0])
    blank_path = -torch.log_softmax(data, dim=2)[:, :, 0].sum(0).numpy()
    loss, _ = _op_run(tmx, arrays, {})
    np.testing.assert_allclose(loss[[0, 2]], blank_path[[0, 2]], rtol=1e-5)


@pytest.mark.parametrize("blank_label", ["first", "last"])
def test_recursion_matches_torch_ctc_where_it_is_defined(blank_label):
    T, N, C = 14, 5, 9
    data = _data(13, T, N, C)
    lab, lens = _labels(14, N, 6, C, blank_label)
    dlen = np.array([14, 12, 13, 14, 11], np.float32)
    got, _ = _op_run(tmx, [data, lab, dlen],
                     dict(use_data_lengths=True, blank_label=blank_label))
    blank = 0 if blank_label == "first" else C - 1
    want = torch.nn.functional.ctc_loss(
        torch.log_softmax(torch.from_numpy(data), 2),
        torch.from_numpy(np.maximum(lab, 0)).long(),
        torch.from_numpy(dlen).long(), torch.from_numpy(lens).long(),
        blank=blank, reduction="none")
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5)


def test_ctc_aliases_are_one_op():
    get = tmx.ops.registry.get_op
    assert get("ctc_loss") is get("_contrib_CTCLoss") \
        is get("contrib_ctc_loss")
    assert tmx.nd.contrib.CTCLoss is not None
    assert tmx.sym.contrib.CTCLoss is not None


def _block_run(mx, layout, label_layout, hybridize, with_lengths, seed=20):
    T, N, C = 10, 4, 6
    pred = _data(seed, T, N, C)
    lab, lens = _labels(seed + 1, N, 4, C)
    if layout == "NTC":
        pred = pred.transpose(1, 0, 2).copy()
    if label_layout == "TN":
        lab = lab.T.copy()
    ctx = {"ctx": tmx.cpu()} if mx is tmx else {}
    loss_fn = mx.gluon.loss.CTCLoss(layout=layout, label_layout=label_layout,
                                    weight=0.5)
    if hybridize:
        loss_fn.hybridize()
    p = mx.nd.array(pred, **ctx)
    p.attach_grad()
    extra = []
    if with_lengths:
        extra = [mx.nd.array(np.array([10, 8, 9, 10], np.float32), **ctx),
                 mx.nd.array(lens, **ctx)]
    with mx.autograd.record():
        out = loss_fn(p, mx.nd.array(lab, **ctx), *extra)
    out.backward()
    return out.asnumpy(), p.grad.asnumpy()


@pytest.mark.parametrize("layout,label_layout",
                         [("NTC", "NT"), ("TNC", "TN"), ("NTC", "TN"),
                          ("TNC", "NT")])
@pytest.mark.parametrize("hybridize", [False, True],
                         ids=["imperative", "hybridized"])
def test_ctc_loss_block_matches_the_reference(layout, label_layout,
                                              hybridize):
    for with_lengths in (False, True):
        want = _block_run(jmx, layout, label_layout, hybridize, with_lengths)
        got = _block_run(tmx, layout, label_layout, hybridize, with_lengths)
        _close(got[0], want[0], "loss")
        _close(got[1], want[1], "pred gradient")


def test_ctc_loss_block_rejects_unknown_layouts():
    with pytest.raises(AssertionError):
        tmx.gluon.loss.CTCLoss(layout="CTN")
    with pytest.raises(AssertionError):
        tmx.gluon.loss.CTCLoss(label_layout="TT")
