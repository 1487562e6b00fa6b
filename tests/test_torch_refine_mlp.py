"""Parity of the port's MLP-D refinement (``ops/refine_mlp.py``: plain
version, parameter order and forms, gate, CPU dispatch) with the JAX
package's fused MLP kernel (``fused_refine_mlp``, run in interpret mode on
the CPU) and its scan oracle.

Tolerances as in tests/test_refine_pallas.py: rtol 1e-4 / atol 1e-5 on x and
on the logits, for float32 sums taken in another order over up to 25 steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collaborative_gan_sampling_torch.config import (
    ModelConfig as TModelConfig,
    RefineConfig as TRefineConfig,
    get_preset,
)
from collaborative_gan_sampling_torch.models import make_bundle as t_make_bundle
from collaborative_gan_sampling_torch.ops.refine_mlp import (
    d_forward_flops,
    fused_refine_mlp,
    mlp_layers,
    mlp_params_from_d,
    refine_flops_per_sample,
    refine_mlp_plain,
    supports_mlp_refine_kernel,
)
from collaborative_gan_sampling_torch.sampling import refine as t_refine
from collaborative_gan_sampling_torch.sampling.refine import (
    make_refine_fn as t_make_refine_fn,
)
from collaborative_gan_sampling_tpu.config import RefineConfig
from collaborative_gan_sampling_tpu.ops.refine_pallas import (
    fused_refine_mlp as jax_fused_refine_mlp,
)
from collaborative_gan_sampling_tpu.sampling.refine import make_refine_fn
from tests.test_torch_mlp import MID, TOY2D
from tests.test_torch_models import make_pair

RTOL, ATOL = 1e-4, 1e-5


def _pair(kw, seed):
    jb, tb, _, d_vars, _, d = make_pair(kw, seed=seed)
    return jb, tb, d_vars, d


def _x0(n, seed, scale=2.0):
    return (np.random.default_rng(seed).standard_normal((n, 2))
            * scale).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("steps,rate,batch", [
    (1, 0.1, 64), (10, 0.1, 700), (25, 0.03, 256),
])
def test_plain_matches_pallas_kernel_and_scan(steps, rate, batch):
    jb, _, d_vars, d = _pair(TOY2D, seed=0)
    x0 = _x0(batch, seed=1)
    x_scan, aux = jax.jit(make_refine_fn(jb, RefineConfig(
        steps=steps, rate=rate)))(d_vars, jnp.asarray(x0))
    x_pal, lg_pal = jax_fused_refine_mlp(d_vars, jnp.asarray(x0), steps,
                                         rate, interpret=True)
    x_got, lg_got = refine_mlp_plain(mlp_params_from_d(d),
                                     torch.from_numpy(x0), steps, rate)
    for x_want, lg_want in ((x_pal, lg_pal), (x_scan, aux["logits"])):
        _close(x_got, x_want)
        _close(lg_got, lg_want)
    assert np.abs(x_got.numpy() - x0).max() > 1e-3  # the steps moved x


@pytest.mark.parametrize("seed", range(3))
def test_plain_parity_across_random_params(seed):
    kw = dict(MID, d_hidden=64, d_layers=2)
    _, _, d_vars, d = _pair(kw, seed=10 + seed)
    x0 = _x0(96, seed=20 + seed, scale=3.0)
    x_pal, lg_pal = jax_fused_refine_mlp(d_vars, jnp.asarray(x0), 5, 0.07,
                                         interpret=True)
    x_got, lg_got = refine_mlp_plain(mlp_params_from_d(d),
                                     torch.from_numpy(x0), 5, 0.07)
    _close(x_got, x_pal)
    _close(lg_got, lg_pal)


@pytest.mark.parametrize("batch", [37, 1])
def test_ragged_batch(batch):
    _, _, d_vars, d = _pair(TOY2D, seed=2)
    x0 = _x0(batch, seed=3, scale=1.0)
    x_pal, lg_pal = jax_fused_refine_mlp(d_vars, jnp.asarray(x0), 3, 0.1,
                                         tile=32, interpret=True)
    x_got, lg_got = fused_refine_mlp(mlp_layers(d), torch.from_numpy(x0),
                                     3, 0.1)
    assert x_got.shape == (batch, 2) and lg_got.shape == (batch,)
    _close(x_got, x_pal)
    _close(lg_got, lg_pal)


def test_single_hidden_layer():
    kw = dict(MID, d_hidden=32, d_layers=1)
    _, _, d_vars, d = _pair(kw, seed=4)
    x0 = _x0(16, seed=5)
    x_pal, lg_pal = jax_fused_refine_mlp(d_vars, jnp.asarray(x0), 4, 0.2,
                                         interpret=True)
    x_got, lg_got = refine_mlp_plain(mlp_params_from_d(d),
                                     torch.from_numpy(x0), 4, 0.2)
    _close(x_got, x_pal)
    _close(lg_got, lg_pal)


def test_param_extraction_order_and_shapes():
    _, _, _, d = _pair(dict(MID, d_hidden=64, d_layers=2), seed=6)
    params = mlp_params_from_d(d)
    assert [tuple(w.shape) for w, _ in params] == [(2, 64), (64, 64),
                                                   (64, 1)]
    assert [tuple(b.shape) for _, b in params] == [(64,), (64,), (1,)]


def test_flop_count_matches_hand_count():
    # 2 (d h + (L-1) h^2 + h) = 2 (256 + 32,768 + 128) per D forward.
    assert d_forward_flops(2, 128, 3) == 66_304
    assert refine_flops_per_sample(10, 2, 128, 3) == 21 * 66_304 == 1_392_384


def test_wrapper_on_cpu_takes_plain_version():
    _, _, _, d = _pair(TOY2D, seed=8)
    x0 = torch.from_numpy(_x0(5, seed=9))
    before = fused_refine_mlp.launches
    x_got, lg_got = fused_refine_mlp(mlp_layers(d), x0, 2, torch.tensor(0.03))
    x_want, lg_want = refine_mlp_plain(mlp_params_from_d(d), x0, 2, 0.03)
    assert fused_refine_mlp.launches == before
    torch.testing.assert_close(x_got, x_want, rtol=0, atol=0)
    torch.testing.assert_close(lg_got, lg_want, rtol=0, atol=0)


def test_gate():
    toy = t_make_bundle(get_preset("toy2d").model, device="cpu")
    mnist = t_make_bundle(get_preset("mnist").model, device="cpu")
    wide = t_make_bundle(TModelConfig(d_hidden=256), device="cpu")
    cfg = TRefineConfig()
    assert supports_mlp_refine_kernel(toy, cfg)
    assert not supports_mlp_refine_kernel(mnist, cfg)
    assert not supports_mlp_refine_kernel(wide, cfg)  # weights too large
    assert not supports_mlp_refine_kernel(toy, cfg, labels=torch.zeros(2))
    assert not supports_mlp_refine_kernel(toy, cfg, return_trajectory=True)
    assert supports_mlp_refine_kernel(toy, TRefineConfig(rate=0.37))
    for change in (dict(use_pallas=False), dict(clip_norm=1.0),
                   dict(noise=0.1), dict(objective="kl"),
                   dict(stop_score=0.5), dict(proximal=0.1),
                   dict(space="z")):
        off = TRefineConfig(**change)
        assert not supports_mlp_refine_kernel(toy, off), change


@pytest.mark.parametrize("rate", [None, 0.3], ids=["cfg_rate",
                                                   "tensor_rate"])
def test_toy2d_refine_dispatches_to_kernel_path(rate, monkeypatch):
    """Under the toy2d config the gate holds: the refine runs through the
    MLP kernel's wrapper (its plain version on the CPU), at the config's
    rate or at a tensor rate, and matches the JAX refine."""
    jb, tb, d_vars, d = _pair(TOY2D, seed=12)
    calls = []
    real = t_refine.fused_refine_mlp
    monkeypatch.setattr(t_refine, "fused_refine_mlp",
                        lambda *a: calls.append(1) or real(*a))
    kw = dict(steps=3, rate=0.1)
    x0 = _x0(8, seed=13)
    j_rate = None if rate is None else jnp.float32(rate)
    t_rate = None if rate is None else torch.tensor(rate)
    x_want, aux = make_refine_fn(jb, RefineConfig(**kw))(
        d_vars, jnp.asarray(x0), rate=j_rate)
    x_got, aux_t = t_make_refine_fn(tb, TRefineConfig(**kw))(
        d, torch.from_numpy(x0), rate=t_rate)
    assert calls == [1] and fused_refine_mlp.launches == 0
    _close(x_got, x_want)
    _close(aux_t["logits"], aux["logits"])


def test_autograd_path_when_gated_off():
    """With use_pallas off the autograd steps run and agree as well."""
    jb, tb, d_vars, d = _pair(TOY2D, seed=14)
    kw = dict(steps=3, rate=0.1, use_pallas=False)
    x0 = _x0(8, seed=15)
    x_want, aux = make_refine_fn(jb, RefineConfig(**kw))(d_vars,
                                                         jnp.asarray(x0))
    x_got, aux_t = t_make_refine_fn(tb, TRefineConfig(**kw))(
        d, torch.from_numpy(x0))
    _close(x_got, x_want)
    _close(aux_t["logits"], aux["logits"])


def test_wrapper_rejects_what_the_kernel_does_not_take():
    _, _, _, d = _pair(TOY2D, seed=16)
    x0 = torch.zeros(4, 2)
    with pytest.raises(ValueError, match="no MLP refine kernel"):
        fused_refine_mlp(mlp_layers(d), x0.to("meta"), 1, 0.1)
