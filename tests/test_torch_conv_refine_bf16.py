"""Parity of the port's bf16-operand conv-D refinement (the plain version of
``csrc/conv_refine28_bf16.cu``, its wrapper on the CPU, and the dtype
dispatch of ``sampling/refine.py``) with the JAX package's
``fused_refine_conv28_v2`` (interpret mode) and its bf16 mnist refine path.

Tolerances:

* bf16 plain version vs v2 with ``bf16=True``: atol 2e-6 on x and 2e-5 on
  logits. Both round the same operands to bf16 and sum exact products in
  float32 in another order (measured here: ~6e-8 and ~1.5e-7). The
  bf16-vs-f32 gap is ~2.7e-5 / 4.6e-4 at K = 1 and ~4.2e-5 / 4.4e-4 at
  K = 4, and the test requires it to exceed ten times the tolerance, so the
  tolerance tells the two precisions apart (a 4e-6 bound on x would leave
  K = 1's gap at only 6.7 times).
* f32 plain version vs v2 with ``bf16=False``: ``test_torch_conv_refine``'s
  rtol 1e-4 with atol 1e-6 on x and 1e-5 on logits (float32 sums in
  another order).
* The port's bf16 mnist refine path vs the JAX package's own (the s2d path
  at the preset's bf16): atol 2e-4 on x and 6e-3 on logits, twice the
  distance of JAX's bf16 path from its own f32 path at these inputs
  (1.0e-4 / 3.0e-3: JAX keeps every activation, BatchNorm and the dense
  head in bf16, the kernel only the matmul operands).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collaborative_gan_sampling_torch.config import RefineConfig as TRefineConfig
from collaborative_gan_sampling_torch.ops.conv_refine import (
    fused_refine_conv28,
    fused_refine_conv28_bf16,
)
from collaborative_gan_sampling_torch.ops.conv_refine_ref import (
    fold_dcgan_d,
    refine_conv28_plain,
    refine_conv28_plain_bf16,
)
from collaborative_gan_sampling_torch.sampling import refine as t_refine
from collaborative_gan_sampling_torch.sampling.refine import (
    make_refine_fn as t_make_refine_fn,
)
from collaborative_gan_sampling_tpu.config import RefineConfig
from collaborative_gan_sampling_tpu.ops.conv_refine_pallas import (
    fused_refine_conv28_v2,
)
from collaborative_gan_sampling_tpu.sampling.refine import make_refine_fn
from tests.test_torch_models import MNIST, make_pair

X_TOL, LOGIT_TOL = 2e-6, 2e-5
CASES = [(1, 0.05), (4, 0.02)]


@pytest.fixture(scope="module")
def mnist_pair():
    return make_pair(MNIST, seed=11)


def _x0(n=4, seed=3):
    return (np.random.default_rng(seed).standard_normal((n, 28, 28, 1))
            * 0.5).astype(np.float32)


def _max_abs(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


@pytest.mark.parametrize("steps,rate", CASES)
def test_plain_bf16_matches_v2_bf16(mnist_pair, steps, rate):
    _, _, _, d_vars, _, d = mnist_pair
    x0 = _x0()
    x_want, lg_want = fused_refine_conv28_v2(
        d_vars, jnp.asarray(x0), steps, rate, tile=4, interpret=True,
        bf16=True)
    params = fold_dcgan_d(d)
    x_got, lg_got = refine_conv28_plain_bf16(params, torch.from_numpy(x0),
                                             steps, rate)
    assert x_got.shape == (4, 28, 28, 1) and lg_got.shape == (4,)
    np.testing.assert_allclose(x_got.numpy(), np.asarray(x_want), rtol=0,
                               atol=X_TOL)
    np.testing.assert_allclose(lg_got.numpy(), np.asarray(lg_want), rtol=0,
                               atol=LOGIT_TOL)
    # The tolerance tells bf16 operands from f32 ones by a factor of ten.
    x32, lg32 = refine_conv28_plain(params, torch.from_numpy(x0), steps, rate)
    assert _max_abs(x_got, x32) > 10 * X_TOL
    assert _max_abs(lg_got, lg32) > 10 * LOGIT_TOL


@pytest.mark.parametrize("steps,rate", CASES)
def test_plain_f32_matches_v2_f32(mnist_pair, steps, rate):
    _, _, _, d_vars, _, d = mnist_pair
    x0 = _x0(seed=8)
    x_want, lg_want = fused_refine_conv28_v2(
        d_vars, jnp.asarray(x0), steps, rate, tile=4, interpret=True,
        bf16=False)
    x_got, lg_got = refine_conv28_plain(fold_dcgan_d(d),
                                        torch.from_numpy(x0), steps, rate)
    np.testing.assert_allclose(x_got.numpy(), np.asarray(x_want), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(lg_got.numpy(), np.asarray(lg_want),
                               rtol=1e-4, atol=1e-5)


def test_bf16_wrapper_on_cpu_takes_plain_version(mnist_pair):
    _, _, _, _, _, d = mnist_pair
    params = fold_dcgan_d(d)
    x0 = torch.from_numpy(_x0(3, seed=7))
    before = fused_refine_conv28_bf16.launches
    x_got, lg_got = fused_refine_conv28_bf16(params, x0, 2,
                                             torch.tensor(0.03))
    x_want, lg_want = refine_conv28_plain_bf16(params, x0, 2, 0.03)
    assert fused_refine_conv28_bf16.launches == before
    torch.testing.assert_close(x_got, x_want, rtol=0, atol=0)
    torch.testing.assert_close(lg_got, lg_want, rtol=0, atol=0)


@pytest.mark.parametrize("fn", [fused_refine_conv28, fused_refine_conv28_bf16],
                         ids=["f32", "bf16"])
def test_wrapper_raises_off_cpu_and_card(mnist_pair, fn):
    params = fold_dcgan_d(mnist_pair[5])
    x0 = torch.empty(2, 28, 28, 1, device="meta")
    with pytest.raises(ValueError, match="no .*kernel for device meta"):
        fn(params, x0, 1, 0.02)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_refine_dispatches_on_dtype(dtype, monkeypatch):
    """Inside the gate the model's compute dtype picks the kernel: bf16 for
    a bfloat16 model, f32 for a float32 one."""
    _, tb, _, _, _, d = make_pair(dict(MNIST, compute_dtype=dtype), seed=31)
    calls = []
    for name in ("fused_refine_conv28", "fused_refine_conv28_bf16"):
        real = getattr(t_refine, name)
        monkeypatch.setattr(t_refine, name,
                            lambda *a, _n=name, _r=real:
                            calls.append(_n) or _r(*a))
    x0 = torch.from_numpy(_x0(2, seed=4))
    x_got, aux = t_make_refine_fn(tb, TRefineConfig(steps=2, rate=0.05))(
        d, x0)
    want = ("fused_refine_conv28_bf16" if dtype == "bfloat16"
            else "fused_refine_conv28")
    assert calls == [want]
    assert fused_refine_conv28.launches == 0
    assert fused_refine_conv28_bf16.launches == 0
    plain = (refine_conv28_plain_bf16 if dtype == "bfloat16"
             else refine_conv28_plain)
    x_want, lg_want = plain(fold_dcgan_d(d), x0, 2, 0.05)
    torch.testing.assert_close(x_got, x_want, rtol=0, atol=0)
    torch.testing.assert_close(aux["logits"], lg_want, rtol=0, atol=0)


def test_bf16_mnist_refine_matches_jax_bf16_path():
    """The bf16 mnist preset's refinement (K = 10, rate 0.02) through the
    port's kernel path and through the JAX package's own path."""
    x0 = np.random.default_rng(4).uniform(-1, 1, (4, 28, 28, 1)).astype(
        np.float32)
    kw = dict(steps=10, rate=0.02)
    out = {}
    for dtype in ("bfloat16", "float32"):
        jb, tb, _, d_vars, _, d = make_pair(dict(MNIST, compute_dtype=dtype),
                                            seed=31)
        x_j, aux_j = make_refine_fn(jb, RefineConfig(**kw))(d_vars,
                                                            jnp.asarray(x0))
        x_t, aux_t = t_make_refine_fn(tb, TRefineConfig(**kw))(
            d, torch.from_numpy(x0))
        out[dtype] = (x_j, aux_j["logits"], x_t, aux_t["logits"])
    xj, lj, xt, lt = out["bfloat16"]
    xj32, lj32 = out["float32"][:2]
    # JAX's own bf16 rounding, which sets the tolerance below.
    assert 5e-5 < _max_abs(xj, xj32) < 2e-4
    assert 1e-3 < _max_abs(lj, lj32) < 6e-3
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=2e-4)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=0, atol=6e-3)
    moved = np.abs(xt.numpy() - x0).max()
    assert moved > 2 * 2e-4  # the refinement moved x well beyond the bound
