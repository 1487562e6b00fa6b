"""The host side of ``csrc/refine_mlp.cu``: its launch plan, the two forms
of D's parameters, the wrapper's checks, and the kernel's decomposition of
the refinement, emulated in plain PyTorch on the CPU.

* ``emulate_kernel`` runs the kernel's arithmetic from D's own (out, in)
  tensors (``mlp_layers``), as the kernel orders it for a tile of T
  samples: layer 0 per (unit, sample); a hidden layer's forward sum split
  over the 4 lanes kq (k = 4 kq .. 4 kq + 3 mod 16), its input-VJP sum over
  the 8 lanes js (j = js mod 8), each lane's partial summed in k or j
  order, the partials then added as the shuffle reduce-scatter adds them
  for the lane that holds the (unit, sample); the head and the x update as
  warp sums (lanes over j mod 32, then the xor butterfly). Its
  multiply-adds are a multiply and an add here (fused on the card). It
  agrees with
  ``refine_mlp_plain`` and with the JAX package's ``fused_refine_mlp`` in
  interpret mode to rtol 1e-4 / atol 1e-5, the bound of
  tests/test_torch_refine_mlp.py: f32 sums in another order over 10 steps.
* ``launch_plan`` at the batches ``chip_smoke.py`` sends on an H100 (132
  SMs) and the shared-memory plan of ``Plan`` in the .cu.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collaborative_gan_sampling_torch.ops import _build
from collaborative_gan_sampling_torch.ops.refine_mlp import (
    MAX_LAYERS,
    SMEM_LIMIT,
    TILES,
    check_layers,
    fits_kernel,
    launch_plan,
    mlp_layers,
    mlp_params_from_d,
    plain_params,
    refine_mlp_plain,
    smem_bytes,
)
from collaborative_gan_sampling_tpu.ops.refine_pallas import (
    fused_refine_mlp as jax_fused_refine_mlp,
)
from tests.test_torch_mlp import MID, TOY2D
from tests.test_torch_models import make_pair

RTOL, ATOL = 1e-4, 1e-5
H100_SMS = 132


def _d(kw=TOY2D, seed=0):
    _, _, _, d_vars, _, d = make_pair(kw, seed=seed)
    return d_vars, d


def _x0(n, seed, scale=2.0):
    return (np.random.default_rng(seed).standard_normal((n, 2))
            * scale).astype(np.float32)


def _warp_sum(parts):
    """parts[lane] (32, ...): the xor butterfly of ``warp_sum``, lane 0's
    result."""
    s = list(parts)
    for o in (16, 8, 4, 2, 1):
        s = [s[i] + s[i ^ o] for i in range(32)]
    return s[0]


def _lane_sums(prod, n, stride):
    """prod(k) -> (B, ...) terms; per lane l < stride the sum over k = l,
    l + stride, ... < n, in order."""
    out = []
    for lane in range(stride):
        acc = torch.zeros_like(prod(0))
        for k in range(lane, n, stride):
            acc = acc + prod(k)
        out.append(acc)
    return out


def _half(batch, tile):
    """Per sample, whether it lies in the second half of its tile."""
    return (torch.arange(batch) % tile >= tile // 2)[:, None]


def _combine4(parts, holder):
    """The two-step shuffle reduce-scatter of four lanes' partials, for the
    holder lane h: (p[h] + p[h ^ 2]) + (p[h ^ 1] + p[h ^ 3])."""
    lvl1 = [parts[q] + parts[q ^ 2] for q in range(4)]
    lvl2 = [lvl1[q] + lvl1[q ^ 1] for q in range(4)]
    return torch.stack(lvl2).gather(0, holder[None])[0]


def _dense_fwd(a, w, b, tile):
    """A hidden layer's forward, a (B, h) -> relu (B, h), w (h, h) (out,
    in), in the kernel's order: 4 lanes' partials over k = 4 q .. 4 q + 3
    (mod 16), held by the lane that the unit's half of 128 and the sample's
    half of its tile pick."""
    h = w.shape[0]
    parts = []
    for kq in range(4):
        acc = torch.zeros(a.shape[0], h)
        for k0 in range(4 * kq, h, 16):
            for r in range(4):
                acc = acc + a[:, k0 + r, None] * w[None, :, k0 + r]
        parts.append(acc)
    j = torch.arange(h)
    holder = 2 * (j % 128 >= 64).long()[None, :] \
        + _half(a.shape[0], tile).long()
    return torch.relu(_combine4(parts, holder.expand(a.shape)) + b)


def _dense_bwd(dz, w, prev, tile):
    """prev <- [prev > 0] * dz w, w (h, h) (out, in), in the kernel's order:
    rows j = js mod 8 summed on 8 lanes, then three reduce-scatter steps."""
    h = w.shape[0]
    r = torch.arange(h) % 4
    parts = []
    for js in range(8):
        acc = torch.zeros(dz.shape[0], h)
        for j in range(js, h, 8):
            acc = acc + dz[:, j, None] * w[None, j, :]
        parts.append(acc)
    lvl = parts
    for o in (4, 2, 1):
        lvl = [lvl[q] + lvl[q ^ o] for q in range(8)]
    holder = (4 * (r >> 1) + 2 * (r & 1))[None, :] \
        + _half(dz.shape[0], tile).long()
    total = torch.stack(lvl).gather(0, holder.expand(dz.shape)[None])[0]
    return torch.where(prev > 0, total, 0.0)


def _forward(layers, x, tile):
    (w0, b0), *hidden, (wo, bo) = layers
    a = torch.zeros(x.shape[0], w0.shape[0])
    for c in range(x.shape[1]):
        a = a + w0[None, :, c] * x[:, c, None]
    acts = [torch.relu(a + b0)]
    for w, b in hidden:
        acts.append(_dense_fwd(acts[-1], w, b, tile))
    h = w0.shape[0]

    def prod(j):
        return acts[-1][:, j] * wo[0, j]

    return _warp_sum(_lane_sums(prod, h, 32)) + bo[0], acts


def emulate_kernel(layers, x0, steps, rate, tile):
    """The kernel's refinement from ``mlp_layers(d)``, tile by tile (a
    sample's sums depend on its place in its tile)."""
    (w0, _), *hidden, (wo, _) = layers
    x, h = x0.clone(), w0.shape[0]
    for _ in range(steps):
        logit, acts = _forward(layers, x, tile)
        g = -1.0 / (1.0 + torch.exp(logit))
        dz = torch.where(acts[-1] > 0, g[:, None] * wo[0][None, :], 0.0)
        for i in range(len(hidden), 0, -1):
            dz = _dense_bwd(dz, hidden[i - 1][0], acts[i - 1], tile)
        for c in range(x.shape[1]):
            def prod(j, c=c):
                return dz[:, j] * w0[j, c]

            x[:, c] = x[:, c] - rate * _warp_sum(_lane_sums(prod, h, 32))
    logit, _ = _forward(layers, x, tile)
    return x, logit


@pytest.mark.parametrize("tile,batch", [(2, 64), (2, 37), (8, 40),
                                        (8, 45)])
def test_emulated_kernel_matches_plain_and_pallas(tile, batch):
    d_vars, d = _d(seed=3)
    x0 = _x0(batch, seed=4)
    x_emu, lg_emu = emulate_kernel(mlp_layers(d), torch.from_numpy(x0), 10,
                                   0.1, tile)
    x_pl, lg_pl = refine_mlp_plain(mlp_params_from_d(d), torch.from_numpy(x0),
                                   10, 0.1)
    x_jax, lg_jax = jax_fused_refine_mlp(d_vars, jnp.asarray(x0), 10, 0.1,
                                         interpret=True)
    for x_want, lg_want in ((x_pl.numpy(), lg_pl.numpy()),
                            (np.asarray(x_jax), np.asarray(lg_jax))):
        np.testing.assert_allclose(x_emu.numpy(), x_want, rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(lg_emu.numpy(), lg_want, rtol=RTOL,
                                   atol=ATOL)
    assert np.abs(x_emu.numpy() - x0).max() > 1e-2  # the steps moved x


@pytest.mark.parametrize("tile,hidden", [(2, 64), (8, 64), (2, 100),
                                         (8, 100)])
def test_emulated_kernel_at_a_narrower_width(tile, hidden):
    """h = 64 and 100: the units a thread holds beyond h (its second unit)
    read a valid row and drop the sum; at h = 100 the last input-VJP round
    has one live group of 4 inputs in its warp, and the forward's k-sums
    end after 7 or 6 strides."""
    d_vars, d = _d(dict(MID, d_hidden=hidden, d_layers=2), seed=5)
    x0 = _x0(24, seed=6)
    x_emu, lg_emu = emulate_kernel(mlp_layers(d), torch.from_numpy(x0), 4,
                                   0.07, tile)
    x_jax, lg_jax = jax_fused_refine_mlp(d_vars, jnp.asarray(x0), 4, 0.07,
                                         interpret=True)
    np.testing.assert_allclose(x_emu.numpy(), np.asarray(x_jax), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(lg_emu.numpy(), np.asarray(lg_jax), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("batch,tile,grid", [
    (1, 2, 1), (37, 2, 19), (256, 2, 128), (264, 2, 132), (266, 8, 34),
    (1001, 8, 126), (65536, 8, 132),
])
def test_launch_plan(batch, tile, grid):
    """Tiles of 2 while they fit in one wave of 132 blocks (one a SM at
    141 KB): the main path's B = 256 spreads over 128 blocks. Beyond that,
    tiles of 8: at 65,536 each of 132 persistent blocks walks over 62 or
    63 of them."""
    plan = launch_plan(batch, 2, 128, 3, H100_SMS)
    assert (plan.tile, plan.grid) == (tile, grid)
    assert plan.smem == smem_bytes(2, 128, 3, tile) <= SMEM_LIMIT


def test_launch_plan_forced_and_unknown_tiles():
    assert launch_plan(256, 2, 128, 3, H100_SMS, tile=8) == (8, 32,
                                                             150_656)
    assert launch_plan(65536, 2, 128, 3, H100_SMS, tile=2)[:2] == (2, 132)
    for tile in (4, 16, 32):
        with pytest.raises(ValueError, match="tiles are"):
            launch_plan(256, 2, 128, 3, H100_SMS, tile=tile)


def test_launch_plan_keeps_the_tile_that_fits():
    """h = 164, 3 layers: tiles of 2 fit (228,352 B), tiles of 8 do not
    (240,224 B), so even a large batch takes tiles of 2."""
    assert smem_bytes(2, 164, 3, 2) <= SMEM_LIMIT < smem_bytes(2, 164, 3, 8)
    assert fits_kernel(2, 164, 3)
    assert launch_plan(65536, 2, 164, 3, H100_SMS)[:2] == (2, 132)


@pytest.mark.parametrize("tile,want", [(2, 141_376), (8, 150_656)])
def test_shared_memory_plan(tile, want):
    # W0 (128, 2) and b0; two hidden layers of 128 rows at a pitch of 132
    # floats and their biases; the head; activations (3, 128, T); x (T, 2)
    # and the logits, each rounded up to 4 floats; 4 mbarriers.
    floats = (256 + 128 + 2 * (128 * 132 + 128) + 128 + 3 * 128 * tile
              + max(4, 2 * tile) + max(4, tile))
    assert smem_bytes(2, 128, 3, tile) == 4 * floats + 8 * 4 == want


@pytest.mark.parametrize("d_in,hidden,layers,fits", [
    (2, 128, 3, True), (2, 32, 1, True), (2, 96, 3, True),
    (2, 100, 3, True),  # rows of 100 floats are whole float4s
    (2, 160, 3, True),  # 217,664 B at tiles of 2
    (2, 8, 11, True),  # tests/test_torch_mlp.py's DEEP D
    (2, 102, 3, False),  # not a multiple of 4
    (2, 256, 3, False),  # 2 x 256 x 260 floats > 227 KB
    (2, 128, 0, False),
    (2, 8, MAX_LAYERS, True),
    (2, 8, MAX_LAYERS + 1, False),
])
def test_gate_follows_the_plan(d_in, hidden, layers, fits):
    assert TILES == (2, 8)
    assert fits_kernel(d_in, hidden, layers) is fits


def test_kernel_constants_match_the_source():
    src = (_build.CSRC / "refine_mlp.cu").read_text()
    assert re.search(r"constexpr int MAX_LAYERS = (\d+);", src).group(1) \
        == str(MAX_LAYERS)
    assert "const Plan p{d, h, L, T, h + 4};" in src
    assert "h < 4 || h % 4 != 0" in src
    assert re.findall(r"case (\d+):", src) == [str(t) for t in TILES]


def test_layers_are_the_module_tensors_and_convert_to_plain_form():
    _, d = _d(seed=7)
    layers = mlp_layers(d)
    modules = [d.fc0, d.fc1, d.fc2, d.out]
    assert [tuple(w.shape) for w, _ in layers] == [(128, 2), (128, 128),
                                                  (128, 128), (1, 128)]
    for (w, b), m in zip(layers, modules):
        assert w.data_ptr() == m.weight.data_ptr()
        assert b.data_ptr() == m.bias.data_ptr()
        assert not w.requires_grad
    params = plain_params(layers)
    assert [tuple(w.shape) for w, _ in params] == [(2, 128), (128, 128),
                                                   (128, 128), (128, 1)]
    for (w, b), (pw, pb) in zip(layers, params):
        torch.testing.assert_close(pw, w.t(), rtol=0, atol=0)
        torch.testing.assert_close(pb, b, rtol=0, atol=0)


def test_check_layers_takes_the_module_tensors():
    _, d = _d(seed=8)
    assert check_layers(mlp_layers(d), torch.zeros(4, 2)) == (128, 3)


def test_check_layers_raises_on_a_noncontiguous_weight():
    _, d = _d(seed=9)
    layers = mlp_layers(d)
    w = layers[1][0]
    layers[1] = (w.t().contiguous().t(), layers[1][1])
    assert not layers[1][0].is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        check_layers(layers, torch.zeros(4, 2))


def test_check_layers_raises_on_a_misaligned_weight():
    _, d = _d(seed=10)
    layers = mlp_layers(d)
    w = layers[2][0]
    buf = torch.empty(w.numel() + 1)
    shifted = buf[1:].view_as(w)
    shifted.copy_(w)
    assert shifted.data_ptr() % 16 and shifted.is_contiguous()
    layers[2] = (shifted, layers[2][1])
    with pytest.raises(ValueError, match="16-byte aligned"):
        check_layers(layers, torch.zeros(4, 2))


def test_check_layers_raises_on_what_the_kernel_does_not_take():
    _, d = _d(seed=11)
    layers = mlp_layers(d)
    with pytest.raises(ValueError, match="float32"):
        check_layers([(w.double(), b) for w, b in layers], torch.zeros(4, 2))
    with pytest.raises(ValueError, match="one-unit head"):
        check_layers(layers[:-1] + [(layers[1][0], layers[1][1])],
                     torch.zeros(4, 2))
    with pytest.raises(ValueError, match="relu layers"):
        check_layers(layers[-1:], torch.zeros(4, 2))
