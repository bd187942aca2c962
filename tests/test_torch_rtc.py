"""mx.rtc in the port: CUDA C compiled by NVRTC and launched on NDArrays.

On the CPU: the signature grammar and its errors against the JAX
package's ``_parse_signature``, the scalar casts against
``np.asarray(value, dtype)`` as the JAX package casts, and the error paths
that need no card (no NVRTC, a CPU context, arity, an unknown kernel, bad
launch dims, ``PallasModule``), and, over a stand-in driver, the
context a launch makes current and sets back. The JAX package is imported inside those
tests only, so that the card-only tests below run on a machine with
PyTorch alone:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_rtc.py

On the card (``cuda`` marker): the eight behaviours of tests/test_rtc.py
as CUDA C (the sources and checks of ``chip_smoke.py``'s rtc phase), the
custom softmax head's two kernels against their plain versions at ragged
widths, launches into outputs that need a temporary, and the error paths
that fail before or at ``cuLaunchKernel`` (none of which faults the
context). Tolerances: exact for copies, the int cast and the backward;
1e-6 of max |y| for the softmax forward (fp32, another summation order).
"""
import ctypes
import importlib
import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import cuda_build, nvrtc
from mxnet_tpu_torch import rtc as trtc
from mxnet_tpu_torch.base import MXNetError

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__),
                                                "..")))
import chip_smoke  # noqa: E402  (the rtc user programs)

_TYPE_WORDS = ["float", "float32", "double", "float64", "half", "float16",
               "bfloat16", "int", "int32", "int8", "uint8", "int64", "long",
               "bool"]

_SIGNATURES = (
    ["const %s *x, %s *out, %s alpha" % (w, w, w) for w in _TYPE_WORDS] +
    ["const float* x,float*y", "  const  float  *  x ,  float  *  y  ",
     "const float *x, float *y, int n,", "float32 *out", "int32 k",
     "const half*a,const bfloat16 *b,uint8* c,bool flag,long n",
     "const double *x, double *y, double alpha, int64 n",
     "float *a, const float *b, float *c, int8 s"])

_MALFORMED = ["const", "qfloat *o", "float *", "float", "const *x",
              "float *x, const", "int8"]


def _jax_rtc():
    return importlib.import_module("mxnet_tpu.rtc")


@pytest.mark.parametrize("sig", _SIGNATURES)
def test_parse_signature_matches_jax(sig):
    want = [(n, np.dtype(d).name, t, i)
            for n, d, t, i in _jax_rtc()._parse_signature(sig)]
    assert trtc._parse_signature(sig) == want


@pytest.mark.parametrize("sig", _MALFORMED)
def test_malformed_signature_raises_in_both(sig):
    jrtc = _jax_rtc()
    from mxnet_tpu.base import MXNetError as JaxMXNetError

    with pytest.raises(JaxMXNetError) as jerr:
        jrtc._parse_signature(sig)
    with pytest.raises(MXNetError) as terr:
        trtc._parse_signature(sig)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("dtype,values", [
    ("int32", [4.9, -4.9, 7, True, 2 ** 31 - 1]),
    ("int64", [4.9, -3.2, 2 ** 40 + 1]),
    ("int8", [100.7, -128, 5]),
    ("uint8", [200.3, 0, 255]),
    ("bool", [0.5, 0, 1, -2.0]),
    ("float32", [1.0 / 3.0, -2.5e-8, 1e30, 7]),
    ("float64", [1.0 / 3.0, -2.5e-300]),
    ("float16", [1.0 / 3.0, 65504.0, 1e-4, -2.75, 3]),
    ("bfloat16", [1.0 / 3.0, 3.140625, -2.7, 1e-3, 65504.0, 3]),
])
def test_scalar_packing_casts_as_jax(dtype, values):
    """Each scalar's bytes as the kernel receives them against
    ``np.asarray(value, dtype)`` with the JAX package's dtype (an
    ``ml_dtypes`` bfloat16 there)."""
    jdtype = _jax_rtc()._DTYPES[dtype]
    for v in values:
        got = bytes(trtc._pack_scalar(v, dtype))
        assert got == np.asarray(v, dtype=jdtype).tobytes(), (dtype, v)
    assert bytes(trtc._pack_scalar(4.9, "int32")) == \
        np.int32(4).tobytes()


def test_cuda_module_without_nvrtc_raises(monkeypatch):
    monkeypatch.setattr(nvrtc, "_nvrtc", None)
    monkeypatch.setattr(nvrtc, "_nvrtc_dirs", lambda: [])
    monkeypatch.setattr(nvrtc.ctypes.util, "find_library", lambda n: None)
    with pytest.raises(MXNetError, match="NVRTC"):
        tmx.rtc.CudaModule('extern "C" __global__ void k() {}')


def test_pallas_module_raises():
    with pytest.raises(MXNetError, match="CudaModule"):
        tmx.rtc.PallasModule("def k(o_ref):\n    pass\n")


@pytest.fixture
def fake_module(monkeypatch):
    """A CudaModule whose compile is replaced by a stand-in cubin naming
    ``scale`` and one export: enough for what fails before the card."""
    cubin = (b"\x7fELF\0.shstrtab\0.text.scale\0"
             b".rel.text._Z6axpy_tIfEvPKT_PS0_S0_i\0")
    monkeypatch.setattr(nvrtc, "compile_cuda", lambda src, opts, exports: (
        cubin, {"axpy_t<float>": "_Z6axpy_tIfEvPKT_PS0_S0_i"}))
    return tmx.rtc.CudaModule("stand-in", exports=["axpy_t<float>"])


def test_launch_errors_before_the_card(fake_module):
    f = fake_module.get_kernel("scale", "const float *x, float *out, int k, "
                                        "int n")
    assert f._params[2] == ("k", "int32", False, True)
    x = tmx.nd.ones((4,), ctx=tmx.cpu())
    out = tmx.nd.zeros((4,), ctx=tmx.cpu())
    with pytest.raises(MXNetError, match="takes 4 arguments"):
        f.launch([x, out, 2], tmx.gpu(0), (1, 1, 1))
    with pytest.raises(MXNetError, match="must be an NDArray"):
        f.launch([x, np.zeros(4), 2, 4], tmx.gpu(0), (1, 1, 1))
    with pytest.raises(MXNetError, match="GPU context"):
        f.launch([x, out, 2, 4], tmx.cpu(), (1, 1, 1))
    with pytest.raises(MXNetError, match="GPU context"):
        f.launch([x, out, 2, 4], None, (1, 1, 1))
    # the export resolves to its lowered name; an unknown name raises
    g = fake_module.get_kernel("axpy_t<float>", "const float *x, float *y, "
                                                "float a, int n")
    assert g._lowered == "_Z6axpy_tIfEvPKT_PS0_S0_i"
    with pytest.raises(MXNetError, match="not in the module"):
        fake_module.get_kernel("missing", "float *o")
    # a name that only ends another kernel's name is not that kernel
    with pytest.raises(MXNetError, match="not in the module"):
        fake_module.get_kernel("ale", "float *o")
    with pytest.raises(MXNetError, match="unsupported type"):
        fake_module.get_kernel("scale", "qfloat *o")


class _FakeDriver:
    """The five driver calls of ``nvrtc.device_context`` over a thread's
    current context; context handle ``100 + d`` belongs to device ``d``."""

    def __init__(self, current):
        self.current = current
        self.sets = []

    def cuCtxGetCurrent(self, out):
        out._obj.value = self.current
        return 0

    def cuDeviceGet(self, out, ordinal):
        out._obj.value = ordinal
        return 0

    def cuCtxGetDevice(self, out):
        out._obj.value = self.current - 100
        return 0

    def cuDevicePrimaryCtxRetain(self, out, dev):
        out._obj.value = 100 + dev.value
        return 0

    def cuCtxSetCurrent(self, ctx):
        self.current = ctx.value
        self.sets.append(ctx.value)
        return 0


@pytest.mark.parametrize("current,inside,after,sets", [
    (None, 101, 101, [101]),         # none current: the primary stays
    (101, 101, 101, []),             # the device's own: nothing is set
    (100, 101, 100, [101, 100]),     # another device's: set back after
])
def test_device_context_restores_another_devices_context(
        monkeypatch, current, inside, after, sets):
    fake = _FakeDriver(current)
    monkeypatch.setattr(nvrtc, "_driver_lib", lambda: fake)
    monkeypatch.setattr(nvrtc, "_primary", {})
    with nvrtc.device_context(1):
        assert fake.current == inside
    assert fake.current == after
    assert fake.sets == sets


@pytest.mark.parametrize("dims", [(), (1, 1, 1, 1), (0, 1, 1), (2, -1)])
def test_bad_launch_dims_raise(dims):
    with pytest.raises(MXNetError, match="positive ints"):
        trtc._dims(dims, "grid_dims")


def test_launch_dims_pad_to_three():
    assert trtc._dims(None, "block_dims") == (1, 1, 1)
    assert trtc._dims((5,), "grid_dims") == (5, 1, 1)
    assert trtc._dims([3, 2], "grid_dims") == (3, 2, 1)


# ------------------------------------------------------------- the card

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def spec_module(card):
    return chip_smoke.rtc_spec_module(tmx)


@pytest.fixture(scope="module")
def softmax(card):
    return chip_smoke.RtcSoftmax(tmx)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [n for n, _ in chip_smoke.RTC_SPECS])
def test_spec_behaviour_on_the_card(spec_module, name):
    spec = dict(chip_smoke.RTC_SPECS)[name]
    before = cuda_build.launch_counts()
    err = spec(tmx, spec_module)
    assert err <= 1e-5
    after = cuda_build.launch_counts()
    assert sum(after.values()) > sum(before.values())


@pytest.mark.cuda
@pytest.mark.parametrize("cols", [1, 17, 1000, 32768])
@pytest.mark.parametrize("rows", [1, 7])
def test_softmax_kernels_match_plain(softmax, rows, cols):
    gen = torch.Generator(device="cuda").manual_seed(cols + rows)
    x = tmx.nd.array(torch.randn(rows, cols, device="cuda",
                                 generator=gen) * 4.0)
    label = tmx.nd.array(torch.randint(0, cols, (rows,), device="cuda",
                                       generator=gen).float())
    y = tmx.nd.zeros((rows, cols), ctx=tmx.gpu())
    dx = tmx.nd.zeros((rows, cols), ctx=tmx.gpu())
    c0 = cuda_build.launch_counts()
    softmax.forward(x, y)
    softmax.backward(label, y, dx)
    torch.cuda.synchronize()
    c1 = cuda_build.launch_counts()
    for k in ("rtc:softmax_fwd", "rtc:softmax_bwd"):
        assert c1.get(k, 0) == c0.get(k, 0) + 1
    ref = chip_smoke.softmax_fwd_plain(x._data)
    err = (y._data - ref).abs().max().item()
    assert err <= chip_smoke.SOFTMAX_FWD_TOL * ref.abs().max().item()
    assert torch.equal(dx._data, chip_smoke.softmax_bwd_plain(label._data,
                                                              y._data))


@pytest.mark.cuda
def test_softmax_unstaged_row_matches_plain(softmax):
    """A row too wide for shared memory re-reads x in each pass."""
    cols = chip_smoke.SOFTMAX_STAGE_BYTES // 4 + 4
    x = tmx.nd.array(torch.randn(2, cols, device="cuda") * 3.0)
    y = tmx.nd.zeros((2, cols), ctx=tmx.gpu())
    softmax.forward(x, y)
    ref = chip_smoke.softmax_fwd_plain(x._data)
    torch.cuda.synchronize()
    assert (y._data - ref).abs().max().item() <= \
        chip_smoke.SOFTMAX_FWD_TOL * ref.abs().max().item()


@pytest.mark.cuda
def test_outputs_that_need_a_temporary(spec_module):
    """An fp64 output, a transposed (non-contiguous) output and an input on
    the host: launched through a seeded contiguous copy, written back."""
    f = spec_module.get_kernel("accum", "const float *x, float *y, "
                                        "float alpha, int n")
    x = tmx.nd.array(np.arange(6, dtype=np.float32), ctx=tmx.cpu())
    y64 = tmx.nd.array(np.full(6, 10.0), ctx=tmx.gpu(), dtype="float64")
    f.launch([x, y64, 2.0, 6], tmx.gpu(), (1,), (32,))
    np.testing.assert_array_equal(y64.asnumpy(), 10.0 + 2.0 * np.arange(6))
    assert y64.dtype == np.float64
    base = tmx.nd.array(np.ones((2, 3), np.float32), ctx=tmx.gpu())
    yt = base.T                       # (3, 2) view, not contiguous
    xt = tmx.nd.array(np.arange(6, dtype=np.float32).reshape(3, 2),
                      ctx=tmx.gpu())
    f.launch([xt, yt, 1.0, 6], tmx.gpu(), (1,), (32,))
    np.testing.assert_array_equal(base.asnumpy(),
                                  1.0 + np.arange(6).reshape(3, 2).T)


@pytest.mark.cuda
def test_launch_is_captured_in_a_cuda_graph(spec_module):
    f = spec_module.get_kernel("accum", "const float *x, float *y, "
                                        "float alpha, int n")
    x = tmx.nd.ones((64,), ctx=tmx.gpu())
    y = tmx.nd.zeros((64,), ctx=tmx.gpu())
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        f.launch([x, y, 1.0, 64], tmx.gpu(), (1,), (64,))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        f.launch([x, y, 1.0, 64], tmx.gpu(), (1,), (64,))
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    np.testing.assert_array_equal(y.asnumpy(), 4.0)


@pytest.mark.cuda
def test_launch_from_a_new_thread(spec_module):
    """A thread where torch has not worked on the card: the launch makes
    the device's primary context current itself."""
    import threading

    f = spec_module.get_kernel("scale", "const float *x, float *out, int k, "
                                        "int n")
    x = tmx.nd.ones((8,), ctx=tmx.gpu())
    out = tmx.nd.zeros((8,), ctx=tmx.gpu())
    errors = []

    def run():
        try:
            f.launch([x, out, 3, 8], tmx.gpu(), (1,), (32,))
            torch.cuda.synchronize()
        except Exception as e:  # reported below
            errors.append(e)

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and not errors, errors
    np.testing.assert_array_equal(out.asnumpy(), 3.0)


@pytest.mark.cuda
def test_errors_on_the_card(spec_module):
    with pytest.raises(MXNetError, match="NVRTC compile"):
        tmx.rtc.CudaModule('extern "C" __global__ void k(float *o) '
                           '{ o[0] = undefined_name; }')
    with pytest.raises(MXNetError, match="not in the module"):
        spec_module.get_kernel("axpy_t", "const float *x, float *y, "
                                         "float a, int n")
    f = spec_module.get_kernel("scale", "const float *x, float *out, int k, "
                                        "int n")
    x = tmx.nd.ones((8,), ctx=tmx.gpu())
    out = tmx.nd.zeros((8,), ctx=tmx.gpu())
    with pytest.raises(MXNetError, match="takes 4 arguments"):
        f.launch([x, out], tmx.gpu(), (1,))
    with pytest.raises(MXNetError, match="GPU context"):
        f.launch([x, out, 2, 8], tmx.cpu(), (1,))
    with pytest.raises(MXNetError, match="cuLaunchKernel"):
        f.launch([x, out, 2, 8], tmx.gpu(), (1,), (2048, 1, 1))
    with pytest.raises(MXNetError, match="MAX_DYNAMIC_SHARED"):
        f.launch([x, out, 2, 8], tmx.gpu(), (1,), (32,),
                 shared_mem=300 * 1024)
    # the context is still good
    f.launch([x, out, 2, 8], tmx.gpu(), (1,), (32,))
    np.testing.assert_array_equal(out.asnumpy(), 2.0)
    assert ctypes.sizeof(trtc._pack_scalar(1, "bool")) == 1
