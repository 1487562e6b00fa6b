"""The hand kernels as ``torch.library`` custom ops (``ops/registry.py``).

Each ``cgs::`` op is checked by ``torch.library.opcheck`` on the CPU at
small shapes (its schema, its fake implementation against its CPU one, no
input written, and, but where the plain version refines by autograd inside
the op, its run under AOT dispatch), and each wrapper is held to the plain
function it wraps bit for bit: on the CPU the op's implementation is that
function. The CUDA implementations launch the kernels and run on the card
only (``chip_smoke.py``); the binding they launch through
(``ops/_build.py::launch``) and their launch count are checked here on a
stand-in library.
"""

import ctypes

import numpy as np
import pytest
import torch

from collaborative_gan_sampling_torch.ops import _build, registry
from collaborative_gan_sampling_torch.ops import refine_mlp as R
from collaborative_gan_sampling_torch.ops.accept import (
    drs_accept_mask_from_uniform,
    drs_accept_mask_from_uniform_plain,
    drs_accept_mask_philox,
    drs_accept_mask_philox_plain,
)
from collaborative_gan_sampling_torch.ops.conv_refine import (
    fused_refine_conv28,
    fused_refine_conv28_bf16,
)
from collaborative_gan_sampling_torch.ops.conv_refine_ref import (
    FoldedConvD,
    refine_conv28_plain,
    refine_conv28_plain_bf16,
)
from collaborative_gan_sampling_torch.ops.refine_mlp import (
    fused_refine_mlp,
    refine_mlp_plain,
)

# opcheck's default checks; the AOT-dispatch one is left out where the plain
# version takes its gradient with torch.autograd.grad inside the op.
ALL_CHECKS = ("test_schema", "test_autograd_registration", "test_faketensor",
              "test_aot_dispatch_dynamic")
NO_AOT = ALL_CHECKS[:3]


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _folded(seed=0):
    r = _rng(seed)
    return FoldedConvD(
        w0=_t(r.standard_normal((5, 5, 1, 64)) * 0.2),
        b0=_t(r.standard_normal(64) * 0.1),
        w1=_t(r.standard_normal((5, 5, 64, 128)) * 0.03),
        b1=_t(r.standard_normal(128) * 0.1),
        wd=_t(r.standard_normal((6272, 1)) * 0.01),
        bd=_t(r.standard_normal(1) * 0.1))


def _mlp_layers(seed=1, d_in=2, hidden=8, relu=2):
    r = _rng(seed)
    shapes = ([(hidden, d_in)] + [(hidden, hidden)] * (relu - 1)
              + [(1, hidden)])
    return [(_t(r.standard_normal(s) * 0.5), _t(r.standard_normal(s[0])
                                                  * 0.1)) for s in shapes]


def _accept_inputs(n=37, seed=2):
    r = _rng(seed)
    logits = _t(r.standard_normal(n) * 2.0)
    return logits, torch.tensor([float(logits.max())]), \
        _t(r.uniform(size=n))


def _cases():
    """(op, args, checks) per op at small shapes."""
    logits, m, u = _accept_inputs()
    x28 = _t(_rng(3).standard_normal((2, 28, 28, 1)) * 0.5)
    x2 = _t(_rng(4).standard_normal((5, 2)))
    layers = _mlp_layers()
    seed = torch.tensor([12345], dtype=torch.int64)
    return {
        "drs_accept_philox": (
            (seed, logits, m, None, 0.25, 1e-6, 80.0), ALL_CHECKS),
        "drs_accept_from_uniform": (
            (u, logits, m, torch.tensor([-0.5]), 0.0, 1e-6, 0.0),
            ALL_CHECKS),
        "conv_refine28": ((x28, list(_folded()), 2, 0.02), NO_AOT),
        "conv_refine28_bf16": ((x28, list(_folded()), 2, 0.02), ALL_CHECKS),
        "refine_mlp": ((x2, [w for w, _ in layers], [b for _, b in layers],
                        3, 0.1), ALL_CHECKS),
    }


def test_registry_lists_every_op_with_cpu_cuda_and_fake_kernels():
    assert set(registry.OPS) == set(_cases())
    for name in registry.OPS:
        op = f"cgs::{name}"
        for key in ("CPU", "CUDA", "Meta"):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(op, key), \
                (op, key)
        for key in ("XPU", "MPS"):
            assert not torch._C._dispatch_has_kernel_for_dispatch_key(op,
                                                                      key)


@pytest.mark.parametrize("name", registry.OPS)
def test_opcheck(name):
    args, checks = _cases()[name]
    torch.library.opcheck(getattr(torch.ops.cgs, name).default, args,
                          test_utils=checks)


@pytest.mark.parametrize("pct,gamma", [(0.0, 0.0), (80.0, 0.25),
                                       (80.0, torch.tensor(-0.5))])
def test_accept_wrappers_equal_their_plain_versions(pct, gamma):
    logits, m, u = _accept_inputs(n=200, seed=5)
    seed = torch.tensor([987654321])
    g_got, g_want = torch.empty(1), torch.empty(1)
    got = drs_accept_mask_philox(seed, logits, m, gamma, 1e-6, pct,
                                 gamma_out=g_got)
    want = drs_accept_mask_philox_plain(seed, logits, m, gamma, 1e-6, pct,
                                        gamma_out=g_want)
    assert torch.equal(got, want) and torch.equal(g_got, g_want)
    got = drs_accept_mask_from_uniform(u, logits, m, gamma, 1e-6, pct)
    want = drs_accept_mask_from_uniform_plain(u, logits, m, gamma, 1e-6, pct)
    assert torch.equal(got, want) and 0 < int(got.sum()) < 200


@pytest.mark.parametrize("fused,plain", [
    (fused_refine_conv28, refine_conv28_plain),
    (fused_refine_conv28_bf16, refine_conv28_plain_bf16)])
@pytest.mark.parametrize("steps", [0, 2])
def test_conv_wrappers_equal_their_plain_versions(fused, plain, steps):
    params = _folded(seed=6)
    x0 = _t(_rng(7).standard_normal((3, 28, 28, 1)) * 0.5)
    before = x0.clone()
    got, want = fused(params, x0, steps, 0.02), plain(params, x0, steps,
                                                      0.02)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(x0, before)
    assert got[0].data_ptr() != x0.data_ptr()  # an op output, not x0


@pytest.mark.parametrize("steps", [0, 4])
def test_mlp_wrapper_equals_its_plain_version(steps):
    layers = _mlp_layers(seed=8, hidden=12, relu=3)
    x0 = _t(_rng(9).standard_normal((9, 2)))
    got = fused_refine_mlp(layers, x0, steps, 0.1)
    want = refine_mlp_plain([(w.t(), b) for w, b in layers], x0, steps, 0.1)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[0].data_ptr() != x0.data_ptr()


def test_cpu_calls_launch_nothing():
    """The launch counters count the CUDA implementations only."""
    counters = (drs_accept_mask_philox, drs_accept_mask_from_uniform,
                fused_refine_conv28, fused_refine_conv28_bf16,
                fused_refine_mlp)
    before = [c.launches for c in counters]
    for name, (args, _) in _cases().items():
        getattr(torch.ops.cgs, name)(*args)
    assert [c.launches for c in counters] == before


@pytest.mark.parametrize("call", [
    lambda x: fused_refine_mlp(_mlp_layers(), x.reshape(-1, 2)[:4], 1, 0.1),
    lambda x: fused_refine_conv28(_folded(), x.reshape(-1, 28, 28, 1), 1,
                                  0.1),
    lambda x: drs_accept_mask_philox(torch.tensor([1]), x[:8], 0.0, 0.0)])
def test_wrappers_refuse_other_devices(call):
    with pytest.raises(ValueError, match="kernel for device meta"):
        call(torch.zeros(784, device="meta"))


class _Entry:
    """A stand-in C entry: records its declarations and calls on its
    library and returns the library's error code."""

    def __init__(self, lib, name):
        object.__setattr__(self, "lib", lib)
        object.__setattr__(self, "name", name)

    def __setattr__(self, key, value):
        self.lib.declared.append((self.name, key))
        object.__setattr__(self, key, value)

    def __call__(self, *args):
        self.lib.calls.append((self.name, args))
        return self.lib.err


class _StandInLib:
    """Stands in for a loaded kernel library (no nvcc on this host)."""

    def __init__(self):
        self.err, self.calls, self.declared, self.entries = 0, [], [], {}

    def __getattr__(self, name):
        return self.entries.setdefault(name, _Entry(self, name))

    def cgs_error_string(self, err):
        return f"error string of {err}".encode()


_P = ctypes.c_void_p


def _declares_once(lib, monkeypatch):
    x = torch.zeros(4)
    for _ in range(3):
        _build.launch(lib, "k", [_P, ctypes.c_int], x, 4)
    assert lib.declared == [("k", "restype"), ("k", "argtypes")]
    assert lib.k.restype is ctypes.c_int
    assert lib.k.argtypes == [_P, ctypes.c_int, _P]  # the stream last
    assert len(lib.calls) == 3


def _raises_with_the_error_string(lib, monkeypatch):
    lib.err = 700
    with pytest.raises(RuntimeError,
                       match="^k: CUDA error 700: error string of 700$"):
        _build.launch(lib, "k", [_P], torch.zeros(2))


def _passes_pointers_and_the_stream_in_order(lib, monkeypatch):
    a, b = torch.zeros(3), torch.ones(2)
    _build.launch(lib, "k", [_P, _P, _P, ctypes.c_int, ctypes.c_float], a,
                  None, b, 7, 0.5)
    [(name, args)] = lib.calls
    assert name == "k" and args[0].value == a.data_ptr() and args[1] is None
    assert args[2].value == b.data_ptr() and args[3:] == (
        7, 0.5, f"stream of {a.data_ptr()}")


def _counts_one_launch_per_op_call(lib, monkeypatch):
    """The CUDA implementation of ``cgs::refine_mlp``, dispatched by key on
    CPU tensors, launches through the binding once and counts once."""
    monkeypatch.setitem(_build._LIBS, "refine_mlp", lib)
    # Other tests of this process hold the counter at 0: restored after.
    monkeypatch.setattr(fused_refine_mlp, "launches", 0)
    monkeypatch.setattr(R, "_sms", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    layers = _mlp_layers()
    x0 = _t(_rng(10).standard_normal((5, 2)))
    x_k, logits = torch.ops.cgs.refine_mlp.default.redispatch(
        torch._C.DispatchKeySet(torch._C.DispatchKey.CUDA), x0,
        [w for w, _ in layers], [b for _, b in layers], 3, 0.1)
    assert fused_refine_mlp.launches == 1
    [(name, args)] = lib.calls
    assert name == "refine_mlp"
    assert [a.value for a in args[:3]] == [x0.data_ptr(), x_k.data_ptr(),
                                           logits.data_ptr()]
    assert args[5:11] == (5, 2, 8, 2, 3, pytest.approx(0.1))
    assert args[-1] == f"stream of {x0.data_ptr()}"


@pytest.mark.parametrize("case", [
    _declares_once, _raises_with_the_error_string,
    _passes_pointers_and_the_stream_in_order,
    _counts_one_launch_per_op_call], ids=lambda f: f.__name__.strip("_"))
def test_binding(case, monkeypatch):
    """``_build.launch``, the one way the kernel modules call a C entry:
    declared once per library, tensors as pointers and the stream last, a
    nonzero cudaError_t raised with the library's string; an op's CUDA call
    counts one launch on its wrapper."""
    monkeypatch.setattr(_build, "stream_of",
                        lambda t: f"stream of {t.data_ptr()}")
    case(_StandInLib(), monkeypatch)
