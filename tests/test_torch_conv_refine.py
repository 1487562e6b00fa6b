"""Parity of the port's conv-D refinement (fold, plain version, gate, CPU
dispatch) with the JAX package's fused conv-D kernel and its s2d oracle.

Tolerances as in tests/test_conv_refine.py: rtol 1e-4 / atol 1e-6 on x and
rtol 1e-4 / atol 1e-5 on logits, for float32 sums taken in another order
(the Pallas kernel runs in interpret mode on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collaborative_gan_sampling_torch.config import RefineConfig as TRefineConfig
from collaborative_gan_sampling_torch.ops.conv_refine import (
    fused_refine_conv28,
    refine_flops_per_sample,
    supports_conv_refine_kernel,
)
from collaborative_gan_sampling_torch.ops.conv_refine_ref import (
    d_forward_folded,
    fold_dcgan_d,
    refine_conv28_plain,
)
from collaborative_gan_sampling_tpu.ops.conv_refine_pallas import (
    fused_refine_conv28 as jax_fused_refine_conv28,
)
from collaborative_gan_sampling_tpu.ops.conv_refine_ref import (
    fold_dcgan_d as jax_fold_dcgan_d,
    refine_s2d_reference,
)
from tests.test_torch_models import MNIST, TINY, make_pair


@pytest.fixture(scope="module")
def mnist_pair():
    return make_pair(MNIST, seed=11)


def _x0(n=4, seed=3):
    return (np.random.default_rng(seed).standard_normal((n, 28, 28, 1))
            * 0.5).astype(np.float32)


def test_fold_matches_jax(mnist_pair):
    _, _, _, d_vars, _, d = mnist_pair
    want = jax_fold_dcgan_d(d_vars)
    got = fold_dcgan_d(d)
    for name in want._fields:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


def test_folded_forward_matches_model(mnist_pair):
    _, tb, _, _, _, d = mnist_pair
    x = torch.from_numpy(_x0(4, seed=5))
    with torch.no_grad():
        want = tb.discriminate(d, x, train=False)
        got = d_forward_folded(fold_dcgan_d(d), x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


@pytest.mark.parametrize("steps,rate", [(1, 0.05), (4, 0.02)])
def test_plain_matches_pallas_kernel_and_s2d_oracle(mnist_pair, steps, rate):
    _, _, _, d_vars, _, d = mnist_pair
    x0 = _x0()
    x_ref, lg_ref = refine_s2d_reference(jax_fold_dcgan_d(d_vars),
                                         jnp.asarray(x0), steps, rate)
    x_pl, lg_pl = jax_fused_refine_conv28(d_vars, jnp.asarray(x0), steps,
                                          rate, tile=4, interpret=True)
    x_got, lg_got = refine_conv28_plain(fold_dcgan_d(d), torch.from_numpy(x0),
                                        steps, rate)
    for x_want, lg_want in ((x_ref, lg_ref), (x_pl, lg_pl)):
        np.testing.assert_allclose(x_got.numpy(), np.asarray(x_want),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(lg_got.numpy(), np.asarray(lg_want),
                                   rtol=1e-4, atol=1e-5)


def test_wrapper_on_cpu_takes_plain_version(mnist_pair):
    _, _, _, _, _, d = mnist_pair
    params = fold_dcgan_d(d)
    x0 = torch.from_numpy(_x0(3, seed=7))
    before = fused_refine_conv28.launches
    x_got, lg_got = fused_refine_conv28(params, x0, 2, torch.tensor(0.03))
    x_want, lg_want = refine_conv28_plain(params, x0, 2, 0.03)
    assert fused_refine_conv28.launches == before
    torch.testing.assert_close(x_got, x_want, rtol=0, atol=0)
    torch.testing.assert_close(lg_got, lg_want, rtol=0, atol=0)


def test_gate():
    from collaborative_gan_sampling_torch.config import ModelConfig
    from collaborative_gan_sampling_torch.models import make_bundle

    mnist = make_bundle(ModelConfig(**MNIST), device="cpu")
    tiny = make_bundle(ModelConfig(**TINY), device="cpu")
    cfg = TRefineConfig()
    assert supports_conv_refine_kernel(mnist, cfg)
    assert not supports_conv_refine_kernel(tiny, cfg)
    assert not supports_conv_refine_kernel(mnist, cfg, return_trajectory=True)
    for change in (dict(use_pallas=False), dict(clip_norm=1.0),
                   dict(noise=0.1), dict(objective="kl"),
                   dict(stop_score=0.5), dict(proximal=0.1),
                   dict(space="z")):
        off = TRefineConfig(**change)
        assert not supports_conv_refine_kernel(mnist, off), change


def test_flop_count_matches_hand_count():
    # In-range taps only: SAME padding (low 1, high 2) leaves 67 of 70
    # (output, tap) pairs per axis of conv0 and 32 of 35 of conv1 inside
    # the image, so one D forward is 2 * (67^2*64 + 32^2*64*128 + 6272)
    # = 17,364,352 FLOP per sample (bench.py's 20.71 MFLOP counts all 25).
    assert refine_flops_per_sample(0) == 17_364_352
    assert refine_flops_per_sample(10) == 21 * refine_flops_per_sample(0)
