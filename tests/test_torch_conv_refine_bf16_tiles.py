"""The host side of ``csrc/conv_refine28_bf16.cu``: the weight packing that
the wrapper hands the kernel, its index maps, and the kernel's decomposition
of the refinement, emulated in plain PyTorch on the CPU.

* Each tile is read back here by an independent decoding of the 128-byte
  swizzled K-major layout that ``wgmma``'s B descriptor reads.
* ``pack_conv1_bf16`` followed by that decoding round-trips w1, bit for bit
  after the bf16 rounding, from both the forward and the VJP tiles.
* ``emulate_kernel`` runs the kernel's steps as the kernel orders them: two
  samples per block with a ragged last block, conv0 as an im2col GEMM with
  K padded to 32, conv1 tap by tap from the packed tiles, its VJP by parity
  class in the ``vjp_schedule`` order, conv0's VJP as a GEMM into
  per-(cell, tap) partials plus a col2im sum. It agrees with
  ``refine_conv28_plain_bf16`` within 1e-6 on x and logits: both round the
  same operands to bf16 and sum exact products in float32, in another order
  (measured here: at most 1.2e-7). The f32 plain version lies beyond five
  times that bound on x (K >= 1) and ten times on logits, so the bound
  tells the precisions apart.
* conv1's A operands, h1 and dz2 in planes of the no-swizzle K-major
  layout, are read back through an independent decoding of the ``wgmma``
  descriptor (start address, LBO, SBO) that the kernel builds for each tap:
  every forward tap and every (class, tap) pair of the VJP reads exactly the
  cells that ``_conv1_rows`` and ``_vjp_rows`` name on the 49 real rows, and
  zeros on the border. The kernel's constants and its offset functions
  (``h1_cell``, ``fwd_run``, ``vjp_run``, ``real_row``, ``border_cell``,
  ``plane_desc``) are read from its source and evaluated here.
"""

import re

import numpy as np
import pytest
import torch

from collaborative_gan_sampling_torch.ops import _build
from collaborative_gan_sampling_torch.ops.conv_refine import (
    TILE_ELEMS,
    VJP_CLASSES,
    pack_bf16_refine_weights,
    pack_conv1_bf16,
    vjp_schedule,
)
from collaborative_gan_sampling_torch.ops.conv_refine_ref import (
    fold_dcgan_d,
    refine_conv28_plain,
    refine_conv28_plain_bf16,
)
from tests.test_torch_models import MNIST, make_pair

TOL = 1e-6


@pytest.fixture(scope="module")
def params():
    return fold_dcgan_d(make_pair(MNIST, seed=11)[5])


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy()


def tile_matrix(tile: torch.Tensor, k: int) -> torch.Tensor:
    """B (k x n) from one packed tile: K-major rows of n, K in atoms of 64
    bf16 (8 KB each for 64 rows); in row r of an atom, the 16-byte chunk c
    of K is stored at chunk c ^ (r % 8)."""
    n = TILE_ELEMS // k
    flat = tile.reshape(-1)
    out = torch.empty(k, n, dtype=tile.dtype)
    for kk in range(k):
        atom, kin = divmod(kk, 64)
        rows = torch.arange(n)
        pos = (atom * n * 64 + rows * 64 + ((kin // 8) ^ (rows % 8)) * 8
               + kin % 8)
        out[kk] = flat[pos]
    return out


def unpack_conv1(tiles: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """w1 (5, 5, 64, 128) read back through ``tile_matrix`` from the
    forward tiles and from the VJP tiles."""
    fwd = torch.stack([tile_matrix(tiles[t], 64) for t in range(25)])
    vjp = torch.empty_like(fwd)
    for j, tap in enumerate(vjp_schedule()[:25]):
        vjp[tap] = tile_matrix(tiles[25 + j], 128).T
    return fwd.view(5, 5, 64, 128), vjp.view(5, 5, 64, 128)


@pytest.mark.parametrize("seed", [0, 1])
def test_pack_round_trip(seed):
    rng = np.random.default_rng(seed)
    w1 = torch.from_numpy(rng.standard_normal((5, 5, 64, 128)).astype(
        np.float32))
    w1[0, 0, 0, :4] = torch.tensor([0.0, -0.0, 1e-40, -3e38])
    tiles = pack_conv1_bf16(w1)
    assert tiles.shape == (50, TILE_ELEMS) and tiles.dtype == torch.bfloat16
    fwd, vjp = unpack_conv1(tiles)
    want = _bits(w1.to(torch.bfloat16))
    np.testing.assert_array_equal(_bits(fwd), want)
    np.testing.assert_array_equal(_bits(vjp), want)


def test_tiles_hold_the_wgmma_layout():
    """Forward tile t is B[ci][co] of tap t; VJP tile j is B[co][ci] of tap
    vjp_schedule()[j]; each read back through the swizzle."""
    w1 = torch.randn(5, 5, 64, 128, generator=torch.Generator().manual_seed(2))
    tiles = pack_conv1_bf16(w1)
    wb = w1.to(torch.bfloat16).reshape(25, 64, 128)
    for t in (0, 7, 24):
        assert torch.equal(tile_matrix(tiles[t], 64), wb[t])
    taps = vjp_schedule()[:25]
    for j in (0, 5, 24):
        assert torch.equal(tile_matrix(tiles[25 + j], 128), wb[taps[j]].T)


def test_vjp_schedule():
    sched = vjp_schedule()
    taps, starts = sched[:25], sched[25:]
    assert sorted(taps) == list(range(25))
    assert starts == [0, 4, 10, 16, 25]
    for c, (py, px) in enumerate(VJP_CLASSES):
        for tap in taps[starts[c]:starts[c + 1]]:
            dy, dx = divmod(tap, 5)
            assert (py + 1 - dy) % 2 == 0 and (px + 1 - dx) % 2 == 0


def test_pack_bf16_refine_weights(params):
    w0, b0, tiles, sched, b1, wd, bd = pack_bf16_refine_weights(params,
                                                                "cpu")
    assert w0.shape == (32, 64) and w0.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        _bits(w0[:25]), _bits(params.w0.reshape(25, 64).to(torch.bfloat16)))
    assert not w0[25:].float().any()
    assert torch.equal(tiles, pack_conv1_bf16(params.w1))
    assert sched.dtype == torch.int32 and sched.tolist() == vjp_schedule()
    assert b0.shape == (64,) and b1.shape == (128,)
    assert wd.shape == (6272,) and bd.shape == (1,)


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _lrelu(t):
    return torch.where(t > 0, t, 0.2 * t)


def _conv0_cols():
    """(196, 32) indices into the zero-bordered 32 x 32 x of each (cell,
    tap) that conv0 reads; taps 25..31 point at the zero corner."""
    cell, tap = torch.meshgrid(torch.arange(196), torch.arange(32),
                               indexing="ij")
    oy, ox, dy, dx = cell // 14, cell % 14, tap // 5, tap % 5
    return torch.where(tap < 25, (2 * oy + dy) * 32 + 2 * ox + dx, 0)


def _conv1_rows(tap):
    """(49,) h1 cell each output cell reads at tap, -1 on the border."""
    m = torch.arange(49)
    iy, ix = 2 * (m // 7) + tap // 5 - 1, 2 * (m % 7) + tap % 5 - 1
    ok = (iy >= 0) & (iy < 14) & (ix >= 0) & (ix < 14)
    return torch.where(ok, iy * 14 + ix, -1)


def _vjp_rows(py, px, tap):
    """(49,) dz2 cell that h1 cell (2 jy + py, 2 jx + px) reads at tap."""
    m = torch.arange(49)
    oy = m // 7 + (py + 1 - tap // 5) // 2
    ox = m % 7 + (px + 1 - tap % 5) // 2
    ok = (oy >= 0) & (oy < 7) & (ox >= 0) & (ox < 7)
    return torch.where(ok, oy * 7 + ox, -1)


def _gather(rows_of, idx):
    """rows_of (S, n, c) gathered at idx (m,), zeros where idx is -1."""
    out = rows_of[:, idx.clamp(min=0)]
    return torch.where((idx >= 0)[None, :, None], out, 0.0)


def emulate_kernel(params, x0, steps, rate):
    """The kernel's decomposition in plain PyTorch, from the arguments the
    wrapper passes it."""
    w0, b0, tiles, sched, b1, wd, bd = pack_bf16_refine_weights(params,
                                                                "cpu")
    w0 = w0.float()  # (32, 64), taps 25..31 zero
    taps, starts = sched[:25].tolist(), sched[25:].tolist()
    w_fwd = [tile_matrix(tiles[t], 64).float() for t in range(25)]
    w_vjp = [tile_matrix(tiles[25 + j], 128).float() for j in range(25)]
    wd = wd.reshape(49, 128)
    cols = _conv0_cols()
    n = x0.shape[0]
    x_out = torch.empty(n, 28, 28)
    logits = torch.empty(n)
    for blk in range(0, n, 2):  # two samples per block, ragged last block
        live = min(2, n - blk)
        xs = torch.zeros(2, 32, 32)
        xs[:live, 1:29, 1:29] = x0[blk:blk + live, :, :, 0]
        for k in range(steps + 1):
            a0 = _bf16(xs.reshape(2, -1)[:, cols]) @ w0 + b0
            h1 = _bf16(_lrelu(a0))  # (2, 196, 64)
            acc = sum(_gather(h1, _conv1_rows(t)) @ w_fwd[t]
                      for t in range(25))
            v = acc + b1
            logit = (_lrelu(v) * wd).sum((1, 2)) + bd
            if k == steps:
                break
            gl = -1.0 / (1.0 + torch.exp(logit))
            g = gl[:, None, None] * wd
            dz2 = _bf16(torch.where(v > 0, g, 0.2 * g))  # (2, 49, 128)
            dz1 = torch.empty_like(h1)
            for c, (py, px) in enumerate(VJP_CLASSES):
                acc = sum(_gather(dz2, _vjp_rows(py, px, taps[j])) @ w_vjp[j]
                          for j in range(starts[c], starts[c + 1]))
                m = torch.arange(49)
                cells = (2 * (m // 7) + py) * 14 + 2 * (m % 7) + px
                dz1[:, cells] = _bf16(torch.where(h1[:, cells] > 0, acc,
                                                  0.2 * acc))
            part = dz1 @ w0.T  # (2, 196, 32) per-(cell, tap) partials
            dx = torch.zeros(2, 32 * 32)
            dx.index_add_(1, cols[:, :25].reshape(-1),
                          part[:, :, :25].reshape(2, -1))
            # Pairs on the zero border feed no pixel.
            xs[:, 1:29, 1:29] -= rate * dx.reshape(2, 32, 32)[:, 1:29, 1:29]
        x_out[blk:blk + live] = xs[:live, 1:29, 1:29]
        logits[blk:blk + live] = logit[:live]
    return x_out[..., None], logits


@pytest.mark.parametrize("steps", [0, 1, 4])
def test_emulated_decomposition_matches_plain(params, steps):
    x0 = torch.from_numpy((np.random.default_rng(5).standard_normal(
        (3, 28, 28, 1)) * 0.5).astype(np.float32))
    x_got, lg_got = emulate_kernel(params, x0, steps, 0.02)
    x_want, lg_want = refine_conv28_plain_bf16(params, x0, steps, 0.02)
    assert x_got.shape == x_want.shape and lg_got.shape == (3,)
    torch.testing.assert_close(x_got, x_want, rtol=0, atol=TOL)
    torch.testing.assert_close(lg_got, lg_want, rtol=0, atol=TOL)
    x32, lg32 = refine_conv28_plain(params, x0, steps, 0.02)
    assert float((lg32 - lg_want).abs().max()) > 10 * TOL
    if steps:
        assert float((x32 - x_want).abs().max()) > 5 * TOL
        assert float((x_want - x0).abs().max()) > 100 * TOL


# ---- the planes that conv1's wgmma A operands read ------------------------

KERNEL = _build.CSRC / "conv_refine28_bf16.cu"


def _python(expr: str) -> str:
    """An integer expression of the kernel as Python: casts dropped, / as
    // (the layout divides only non-negative or even numbers, where C's
    truncation is the floor), && and ||, and a chain of ?: conditionals."""
    expr = " ".join(expr.split())
    expr = re.sub(r"static_cast<\w+>", "", expr)
    expr = expr.replace("&&", " and ").replace("||", " or ")
    expr = re.sub(r"(?<!/)/(?!/)", "//", expr)
    if "?" in expr:
        parts = re.split(r"[?:]", expr)
        out = parts[-1]
        for cond, val in reversed(list(zip(parts[0:-1:2], parts[1:-1:2]))):
            out = f"(({val}) if ({cond}) else ({out}))"
        expr = out
    return expr


def kernel_constants() -> dict[str, int]:
    """Every ``constexpr int`` of the kernel's source, evaluated in order."""
    env: dict[str, int] = {}
    for decl in re.findall(r"constexpr int ([^;]+);", KERNEL.read_text()):
        for name, expr in re.findall(r"(\w+) = ([^,]+)(?:,|$)", decl):
            env[name] = eval(_python(expr), {}, dict(env))
    return env


def kernel_fn(name: str):
    """The kernel's one-line device function ``name`` as a Python function
    over its constants and its other one-line functions."""
    env: dict = dict(kernel_constants())
    for fn, params, body in re.findall(
            r"(?:int|bool|uint64_t) (\w+)\(([^)]*)\) \{\s*return (.*?);\s*\}",
            KERNEL.read_text(), re.S):
        args = ", ".join(a.split()[-1] for a in params.split(","))
        env[fn] = eval(f"lambda {args}: {_python(body)}", env)
    return env[name]


def desc_operand(mem: torch.Tensor, desc: int) -> torch.Tensor:
    """A (64 x 16 bf16) as wgmma reads it through a no-swizzle K-major
    shared-memory descriptor: start address in bits 0-13, LBO in bits 16-29
    and SBO in bits 32-45 (16-byte units), layout (bits 62-63) 0. Core
    matrices of 8 rows x 16 bytes; row r of the one for rows 8i .. 8i + 7
    and channels 8j .. 8j + 7 at start + i SBO + j LBO + 16 (r % 8). ``mem``
    holds one value per 2 bytes; an index past its end raises."""
    assert desc >> 62 == 0 and (desc >> 49) & 7 == 0
    start = (desc & 0x3FFF) << 4
    lbo, sbo = ((desc >> 16) & 0x3FFF) << 4, ((desc >> 32) & 0x3FFF) << 4
    r = torch.arange(64).view(64, 1)
    k = torch.arange(16).view(1, 16)
    byte = start + (r // 8) * sbo + (k // 8) * lbo + (r % 8) * 16 + (k % 8) * 2
    if int(byte.max()) >= 2 * mem.numel():
        raise IndexError("the operand reads past the buffer")
    return mem[byte // 2]


def _out_rows():
    """Output rows m = oy * 8 + ox of the 49 cells (oy, ox), in cell
    order."""
    cell = torch.arange(49)
    return (cell // 7) * 8 + cell % 7


def _tagged(rows: torch.Tensor, channels: int) -> torch.Tensor:
    """(49, channels) tags of the cells ``rows`` names: 1 + row * channels
    + channel, 0 where the row is -1 (the border)."""
    c = torch.arange(channels).view(1, -1)
    return torch.where(rows.view(-1, 1) >= 0, 1 + rows.view(-1, 1) * channels
                       + c, 0)


@pytest.fixture(scope="module")
def planes():
    """The kernel's constants and functions, and h1 and dz2 as its writers
    leave them: conv0's epilogue writes h1 cell (iy, ix) channel c at
    element 8 h1_cell(iy, ix) + 8 (c / 8) H1_CHUNK + c % 8 of a zeroed h1
    area; the head writes dz2 row m = oy * 8 + ox at 8 (LEAD + m + (co / 8)
    DZ2_CHUNK) + co % 8 where real_row(m), and the border loop zeroes
    border_cell(i % BORDER) of chunk i / BORDER, over a scratch area that
    holds junk (-7) from the VJP partials before."""
    k = kernel_constants()
    h1_cell, real_row = kernel_fn("h1_cell"), kernel_fn("real_row")
    border_cell = kernel_fn("border_cell")
    h1 = torch.zeros(8 * k["H1_CELLS"], dtype=torch.long)
    for cell in range(196):
        iy, ix = divmod(cell, 14)
        for c in range(64):
            h1[8 * h1_cell(iy, ix) + 8 * (c // 8) * k["H1_CHUNK"] + c % 8] = (
                1 + cell * 64 + c)
    dz2 = torch.full((k["SCR_BYTES"] // 2,), -7, dtype=torch.long)
    for i in range(16 * k["BORDER"]):
        cell = border_cell(i % k["BORDER"]) + i // k["BORDER"] * k["DZ2_CHUNK"]
        dz2[8 * cell:8 * cell + 8] = 0
    for m in range(64):
        if not real_row(m):
            continue
        for co in range(128):
            dz2[8 * (k["LEAD"] + m + (co // 8) * k["DZ2_CHUNK"]) + co % 8] = (
                1 + ((m // 8) * 7 + m % 8) * 128 + co)
    return k, h1, dz2


def test_plane_constants(planes):
    """The planes as the kernel's note states them, and its layout fits
    shared memory."""
    k = planes[0]
    assert (k["PITCH"], k["LEAD"], k["PLANE"], k["REGION"]) == (8, 9, 73, 76)
    assert k["H1_CHUNK"] == 4 * k["REGION"] and k["DZ2_CHUNK"] == k["REGION"]
    assert k["BORDER"] == k["PLANE"] - 49 == 24
    assert k["SMEM_BYTES"] == 214248 and k["SMEM_ALLOC"] <= 232448
    # 16 * 76 = 64 bytes mod 128: the x parities in opposite bank halves.
    assert (16 * k["REGION"]) % 128 == 64


def test_plane_writes_hit_only_real_cells(planes):
    """conv0's 196 cells land on the 4 x 49 real cells of h1's planes, one
    to one; real_row selects exactly the rows whose plane cell LEAD + m is
    real, so no epilogue writes a junk row onto a border cell; the border
    loop zeroes every other cell of a plane; dz1 of class c lands on h1's
    cell of that class."""
    k = planes[0]
    h1_cell, real_row = kernel_fn("h1_cell"), kernel_fn("real_row")
    border = {kernel_fn("border_cell")(i) for i in range(k["BORDER"])}
    real = {k["LEAD"] + jy * k["PITCH"] + jx for jy in range(7)
            for jx in range(7)}
    assert len(border) == k["BORDER"] and not border & real
    assert border | real == set(range(k["PLANE"]))
    for m in range(64):
        assert real_row(m) == (k["LEAD"] + m in real)
    got = sorted(h1_cell(iy, ix) for iy in range(14) for ix in range(14))
    want = sorted(p * k["REGION"] + cell for p in range(4) for cell in real)
    assert got == want
    for c, (py, px) in enumerate(VJP_CLASSES):
        for m in range(64):
            if real_row(m):
                jy, jx = divmod(m, 8)
                assert (c * k["REGION"] + k["LEAD"] + m
                        == h1_cell(2 * jy + py, 2 * jx + px))


@pytest.mark.parametrize("tap", range(25))
def test_forward_tap_reads_its_cells(planes, tap):
    """Forward tap t, k-step s: plane_desc(16 fwd_run(t), 16 H1_CHUNK) + 2 s
    H1_CHUNK, as conv1_fwd issues it, reads h1 at _conv1_rows(t) on the
    real rows (channels 16 s .. 16 s + 15), zeros on the border; junk rows
    stay inside the h1 area."""
    k, h1, _ = planes
    desc = kernel_fn("plane_desc")(16 * kernel_fn("fwd_run")(tap),
                                   16 * k["H1_CHUNK"])
    a = torch.cat([desc_operand(h1, desc + 2 * s * k["H1_CHUNK"])
                   for s in range(4)], 1)
    want = _tagged(_conv1_rows(tap), 64)
    assert torch.equal(a[_out_rows()], want)
    assert int((want == 0).any(1).sum()) == int((_conv1_rows(tap) < 0).sum())


VJP_PAIRS = [(c, tap) for c, (py, px) in enumerate(VJP_CLASSES)
             for tap in range(25)
             if (py + 1 - tap // 5) % 2 == 0 and (px + 1 - tap % 5) % 2 == 0]


@pytest.mark.parametrize("c, tap", VJP_PAIRS)
def test_vjp_tap_reads_its_cells(planes, c, tap):
    """The VJP's class c at tap t, k-step s: plane_desc(16 vjp_run(py, px,
    t), 16 DZ2_CHUNK) + 2 s DZ2_CHUNK reads dz2 at _vjp_rows(py, px, t) on
    the real rows (channels 16 s .. 16 s + 15), zeros on the border; junk
    rows read inside the scratch area."""
    k, _, dz2 = planes
    py, px = VJP_CLASSES[c]
    desc = kernel_fn("plane_desc")(16 * kernel_fn("vjp_run")(py, px, tap),
                                   16 * k["DZ2_CHUNK"])
    a = torch.cat([desc_operand(dz2, desc + 2 * s * k["DZ2_CHUNK"])
                   for s in range(8)], 1)
    assert torch.equal(a[_out_rows()], _tagged(_vjp_rows(py, px, tap), 128))


def test_vjp_pairs_are_the_schedule():
    sched = vjp_schedule()
    assert sorted(VJP_PAIRS) == sorted(
        (c, tap) for c in range(4)
        for tap in sched[sched[25 + c]:sched[26 + c]])
    assert [sum(1 for cc, _ in VJP_PAIRS if cc == c) for c in range(4)] == [
        4, 6, 6, 9]
