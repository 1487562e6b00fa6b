"""The host side of ``csrc/conv_refine28.cu``: the weight packing that the
wrapper hands the kernel, the build's cache name, and the kernel's
decomposition of the refinement, emulated in plain PyTorch on the CPU.

* Each tile is read back here by an independent decoding: a forward tile
  is 16 input channels x 128 output channels ([ci][co]) of one tap, a VJP
  tile 32 output channels x 64 input channels ([co][ci]).
* ``pack_conv1_f32`` followed by that decoding round-trips w1 bit for bit,
  from both the forward and the VJP tiles.
* ``emulate_kernel`` runs the kernel's steps as the kernel orders them: two
  samples per block with a ragged last block, conv0 as an im2col GEMM over
  the zero-bordered x, conv1 tap by tap and tile by tile (16 input channels
  each) skipping rows on the border, its VJP by parity class in the
  ``vjp_schedule`` order tile by tile (32 output channels each), each
  output row's sums split in two by tile parity (the row's two warps) and
  added at the end of the pass or class, conv0's VJP as a GEMM into
  per-(cell, tap) partials plus a col2im sum. It agrees with
  ``refine_conv28_plain`` within 1e-6 on x and logits: both multiply the
  same f32 values and sum in f32, in another order (measured here: at most
  1.5e-7).
* ``ops/_build.py::lib_path`` names the library by the source and every
  header of ``csrc/``, so an edited header builds a new library.
"""

import shutil

import numpy as np
import pytest
import torch

from collaborative_gan_sampling_torch.ops import _build
from collaborative_gan_sampling_torch.ops.conv_refine import (
    F32_TILE_ELEMS,
    VJP_CLASSES,
    fused_refine_conv28,
    pack_conv1_f32,
    pack_f32_refine_weights,
    vjp_schedule,
)
from collaborative_gan_sampling_torch.ops.conv_refine_ref import (
    fold_dcgan_d,
    refine_conv28_plain,
)
from tests.test_torch_models import MNIST, make_pair

TOL = 1e-6


@pytest.fixture(scope="module")
def params():
    return fold_dcgan_d(make_pair(MNIST, seed=11)[5])


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy()


def fwd_tile(tiles: torch.Tensor, tap: int, q: int) -> torch.Tensor:
    """w1[tap][16 q : 16 q + 16][:] from forward tile 4 tap + q."""
    return tiles[4 * tap + q].reshape(16, 128)


def vjp_tile(tiles: torch.Tensor, j: int, q: int) -> torch.Tensor:
    """w1[tap][:][32 q : 32 q + 32] transposed ([co][ci]) from VJP tile
    100 + 4 j + q, where tap is the VJP's j-th."""
    return tiles[100 + 4 * j + q].reshape(32, 64)


def unpack_conv1(tiles: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """w1 (5, 5, 64, 128) read back from the forward and the VJP tiles."""
    fwd = torch.stack([torch.cat([fwd_tile(tiles, t, q) for q in range(4)])
                       for t in range(25)])
    vjp = torch.empty_like(fwd)
    for j, tap in enumerate(vjp_schedule()[:25]):
        vjp[tap] = torch.cat([vjp_tile(tiles, j, q) for q in range(4)]).T
    return fwd.view(5, 5, 64, 128), vjp.view(5, 5, 64, 128)


@pytest.mark.parametrize("seed", [0, 1])
def test_pack_round_trip(seed):
    rng = np.random.default_rng(seed)
    w1 = torch.from_numpy(rng.standard_normal((5, 5, 64, 128)).astype(
        np.float32))
    w1[0, 0, 0, :4] = torch.tensor([0.0, -0.0, 1e-40, -3e38])
    tiles = pack_conv1_f32(w1)
    assert tiles.shape == (200, F32_TILE_ELEMS)
    assert tiles.dtype == torch.float32
    fwd, vjp = unpack_conv1(tiles)
    np.testing.assert_array_equal(_bits(fwd), _bits(w1))
    np.testing.assert_array_equal(_bits(vjp), _bits(w1))


def test_pack_f32_refine_weights(params):
    w0, b0, tiles, sched, b1, wd, bd = pack_f32_refine_weights(params, "cpu")
    assert w0.shape == (25, 64) and w0.dtype == torch.float32
    assert torch.equal(w0, params.w0.reshape(25, 64))
    assert torch.equal(tiles, pack_conv1_f32(params.w1))
    # The kernel takes the VJP's tiles in the table's order.
    assert sched.dtype == torch.int32 and sched.tolist() == vjp_schedule()
    w1 = params.w1.reshape(25, 64, 128)
    for j, tap in enumerate(vjp_schedule()[:25]):
        assert torch.equal(vjp_tile(tiles, j, 3), w1[tap, :, 96:].T)
    assert b0.shape == (64,) and b1.shape == (128,)
    assert wd.shape == (6272,) and bd.shape == (1,)


def _lrelu(t):
    return torch.where(t > 0, t, 0.2 * t)


def _conv0_cols():
    """(196, 25) indices into the zero-bordered 32 x 32 x of each (cell,
    tap) that conv0 reads."""
    cell, tap = torch.meshgrid(torch.arange(196), torch.arange(25),
                               indexing="ij")
    oy, ox, dy, dx = cell // 14, cell % 14, tap // 5, tap % 5
    return (2 * oy + dy) * 32 + 2 * ox + dx


def emulate_kernel(params, x0, steps, rate):
    """The kernel's decomposition in plain PyTorch, from the arguments the
    wrapper passes it."""
    w0, b0, tiles, sched, b1, wd, bd = pack_f32_refine_weights(params, "cpu")
    taps, starts = sched[:25].tolist(), sched[25:].tolist()
    wd = wd.reshape(49, 128)
    cols = _conv0_cols()
    jy, jx = torch.arange(7).view(7, 1), torch.arange(7).view(1, 7)
    n = x0.shape[0]
    x_out = torch.empty(n, 28, 28)
    logits = torch.empty(n)
    for blk in range(0, n, 2):  # two samples per block, ragged last block
        live = min(2, n - blk)
        xs = torch.zeros(2, 32, 32)
        xs[:live, 1:29, 1:29] = x0[blk:blk + live, :, :, 0]
        for k in range(steps + 1):
            h1 = _lrelu(xs.reshape(2, -1)[:, cols] @ w0 + b0)
            h1 = h1.view(2, 14, 14, 64)
            # Two warps a row: acc[half] sums the tiles q % 2 == half; the
            # odd warp's sums are added to the even one's after the pass.
            acc = torch.zeros(2, 2, 7, 7, 128)
            for t in range(25):
                dy, dx = divmod(t, 5)
                for oy in range(7):  # row oy; rows on the border skipped
                    iy = 2 * oy + dy - 1
                    if not 0 <= iy < 14:
                        continue
                    ox = [o for o in range(7) if 0 <= 2 * o + dx - 1 < 14]
                    rows = h1[:, iy, [2 * o + dx - 1 for o in ox]]
                    for q in range(4):
                        acc[q % 2][:, oy, ox] += (
                            rows[..., 16 * q:16 * q + 16]
                            @ fwd_tile(tiles, t, q))
            v = (acc[0] + acc[1]).view(2, 49, 128) + b1
            logit = (_lrelu(v) * wd).sum((1, 2)) + bd
            if k == steps:
                break
            gl = -1.0 / (1.0 + torch.exp(logit))
            g = gl[:, None, None] * wd
            dz2 = torch.where(v > 0, g, 0.2 * g).view(2, 7, 7, 128)
            dz1 = torch.empty_like(h1)
            for c, (py, px) in enumerate(VJP_CLASSES):
                # As in the forward, the two warps of a row split the tiles
                # by q % 2; their sums meet at the end of the class.
                acc = torch.zeros(2, 2, 7, 7, 64)
                for j in range(starts[c], starts[c + 1]):
                    dy, dx = divmod(taps[j], 5)
                    sy, sx = (py + 1 - dy) // 2, (px + 1 - dx) // 2
                    for r in range(7):  # row r; rows on the border skipped
                        if not 0 <= r + sy < 7:
                            continue
                        cs = [c_ for c_ in range(7) if 0 <= c_ + sx < 7]
                        rows = dz2[:, r + sy, [c_ + sx for c_ in cs]]
                        for q in range(4):
                            acc[q % 2][:, r, cs] += (
                                rows[..., 32 * q:32 * q + 32]
                                @ vjp_tile(tiles, j, q))
                acc = acc[0] + acc[1]
                h = h1[:, 2 * jy + py, 2 * jx + px]
                dz1[:, 2 * jy + py, 2 * jx + px] = torch.where(h > 0, acc,
                                                               0.2 * acc)
            part = dz1.view(2, 196, 64) @ w0.T  # (2, 196, 25) partials
            dx_ = torch.zeros(2, 32 * 32)
            dx_.index_add_(1, cols.reshape(-1), part.reshape(2, -1))
            # Pairs on the zero border feed no pixel.
            xs[:, 1:29, 1:29] -= rate * dx_.view(2, 32, 32)[:, 1:29, 1:29]
        x_out[blk:blk + live] = xs[:live, 1:29, 1:29]
        logits[blk:blk + live] = logit[:live]
    return x_out[..., None], logits


@pytest.mark.parametrize("steps", [0, 1, 4])
def test_emulated_decomposition_matches_plain(params, steps):
    x0 = torch.from_numpy((np.random.default_rng(5).standard_normal(
        (3, 28, 28, 1)) * 0.5).astype(np.float32))
    x_got, lg_got = emulate_kernel(params, x0, steps, 0.02)
    x_want, lg_want = refine_conv28_plain(params, x0, steps, 0.02)
    assert x_got.shape == x_want.shape and lg_got.shape == (3,)
    torch.testing.assert_close(x_got, x_want, rtol=0, atol=TOL)
    torch.testing.assert_close(lg_got, lg_want, rtol=0, atol=TOL)
    if steps:
        assert float((x_want - x0).abs().max()) > 100 * TOL


def test_wrapper_takes_the_plain_version_on_the_cpu(params):
    x0 = torch.from_numpy((np.random.default_rng(6).standard_normal(
        (2, 28, 28, 1)) * 0.5).astype(np.float32))
    before = fused_refine_conv28.launches
    x_got, lg_got = fused_refine_conv28(params, x0, 2, 0.02)
    x_want, lg_want = refine_conv28_plain(params, x0, 2, 0.02)
    assert torch.equal(x_got, x_want) and torch.equal(lg_got, lg_want)
    assert fused_refine_conv28.launches == before


@pytest.mark.parametrize("edited", ["hopper_async.cuh", "conv_refine28.cu"])
def test_lib_path_covers_the_headers(tmp_path, monkeypatch, edited):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    names = {n: _build.lib_path(n) for n in _build.KERNELS}
    assert names == {n: _build.lib_path(n) for n in _build.KERNELS}
    with open(csrc / edited, "a") as f:
        f.write("\n// edited\n")
    for n, path in names.items():
        # A header edit renames every library; a source edit only its own.
        assert (_build.lib_path(n) != path) == (
            edited.endswith(".cuh") or edited == f"{n}.cu")
