"""Fused K-step refinement under the 28x28 DCGAN D: the CUDA kernels' wrappers.

Two kernels replace the TPU kernels of
``collaborative_gan_sampling_tpu/ops/conv_refine_pallas.py``:

* ``csrc/conv_refine28.cu`` (``fused_refine_conv28``): ``fused_refine_conv28``
  and ``fused_refine_conv28_v2`` at f32 operands, all f32 on the CUDA cores;
  plain version ``ops/conv_refine_ref.py::refine_conv28_plain``. Two
  samples per block; conv1 and its input-VJP as register-tiled f32 GEMMs
  with conv1's weights streamed through shared memory by bulk async copies.
  The wrapper packs the weights once per call (``pack_f32_refine_weights``):
  w1 as 200 tiles of a quarter tap in the order the kernel takes them
  (``pack_conv1_f32``, ``vjp_schedule``);
* ``csrc/conv_refine28_bf16.cu`` (``fused_refine_conv28_bf16``):
  ``fused_refine_conv28_v2`` with ``bf16=True``, bf16 matmul operands with
  f32 sums on the tensor cores; plain version ``refine_conv28_plain_bf16``.
  Two samples per block; conv1 and its input-VJP on ``wgmma`` with conv1's
  weights streamed through shared memory by bulk async copies. The wrapper
  packs the weights once per call (``pack_bf16_refine_weights``): w1 as 50
  tiles in the shared-memory image that ``wgmma``'s B descriptor reads
  (``pack_conv1_bf16``), in the order the kernel takes them
  (``vjp_schedule``).

Each kernel is a ``torch.library`` custom op, ``cgs::conv_refine28`` and
``cgs::conv_refine28_bf16`` (``ops/registry.py``), over x0, the folded
weights as a ``Tensor[]`` (``FoldedConvD``'s order), the step count and the
run-time rate: its CUDA implementation packs the weights and launches the
kernel, counting on the wrapper's ``launches`` (a launch from a reloaded
``torch.export`` artifact counts too); its CPU implementation is the plain
version; its fake implementation gives the shapes. The wrappers call the
op, so a tensor on the CPU takes the plain version and a tensor on the card
launches the kernel or raises: nothing falls back from the card to the
plain version. ``supports_conv_refine_kernel`` is the gate that
``sampling/refine.py`` dispatches on; the model's compute dtype picks the
kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from collaborative_gan_sampling_torch.ops import _build
from collaborative_gan_sampling_torch.ops.conv_refine_ref import (
    FoldedConvD,
    refine_conv28_plain,
    refine_conv28_plain_bf16,
)
from collaborative_gan_sampling_torch.utils.profiling import span


def _taps_in_range(n_in: int, n_out: int) -> int:
    """(output, tap) pairs along one axis of a 5-tap stride-2 SAME conv
    whose input index 2*o + d - 1 lies inside the image; the others read
    the zero border, and the kernel skips them."""
    return sum(0 <= 2 * o + d - 1 < n_in for o in range(n_out)
               for d in range(5))


# One D forward of the 28x28 / 64-filter D, per sample: conv0 + conv1 +
# dense head, two FLOPs per multiply-add, in-range taps only (67 of 70 per
# axis for conv0, 32 of 35 for conv1). The input-VJPs touch the same pairs.
D_FORWARD_FLOPS = 2 * (_taps_in_range(28, 14) ** 2 * 64
                       + _taps_in_range(14, 7) ** 2 * 64 * 128 + 6272)


def refine_flops_per_sample(steps: int) -> int:
    """K steps (forward + input-VJP, equal cost) plus the final forward."""
    return (2 * steps + 1) * D_FORWARD_FLOPS


def supports_conv_refine_kernel(bundle, cfg, labels=None,
                                return_trajectory: bool = False) -> bool:
    """Gate: unconditional DCGAN D at 28x28x1 with 64 base filters, plain
    ``ns`` descent (no clip, noise, stop_score or proximal term), x-space,
    no trajectory, and ``use_pallas`` on."""
    m = bundle.cfg
    return (m.kind == "dcgan" and m.image_size == 28 and m.channels == 1
            and m.d_base_filters == 64 and m.num_classes == 0
            and labels is None and not return_trajectory
            and cfg.use_pallas and cfg.clip_norm == 0 and cfg.noise == 0
            and cfg.objective == "ns" and cfg.stop_score == 0
            and cfg.proximal == 0 and cfg.space == "x")


def _check_x0(x0: torch.Tensor, what: str) -> None:
    if x0.device.type != "cuda":
        raise ValueError(f"no {what} kernel for device {x0.device}")
    if x0.dtype != torch.float32 or tuple(x0.shape[1:]) != (28, 28, 1):
        raise ValueError(f"{what} kernel takes (B, 28, 28, 1) float32, "
                         f"got {tuple(x0.shape)} {x0.dtype}")


def _f32_params(params: FoldedConvD, dev) -> list[torch.Tensor]:
    """b0, b1, wd (flat, NHWC order) and bd as float32 on ``dev``."""
    out = [params.b0.to(dev).contiguous(), params.b1.to(dev).contiguous(),
           params.wd.to(dev).reshape(-1).contiguous(),
           params.bd.to(dev).reshape(1).contiguous()]
    if any(t.dtype != torch.float32 for t in out):
        raise ValueError("conv refine kernels take float32 weights")
    return out


# Both entries' arguments before the stream: x0, x_out, logits, the seven
# weight arguments, batch, steps, rate (csrc/conv_refine28*.cu).
_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_int,
                                      ctypes.c_float]


def _launch(name: str, x0: torch.Tensor, weights: list[torch.Tensor],
            steps: int, rate, lib: ctypes.CDLL | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel ``name`` on x0 with its seven weight arguments (w0,
    b0, conv1's two weight arguments, b1, wd, bd), from ``lib`` if given
    (another build of the same source, ``_build.open_lib``), else from
    ``_build.load(name)``."""
    x0 = x0.contiguous()
    x_out = torch.empty_like(x0)
    logits = torch.empty(x0.shape[0], device=x0.device, dtype=torch.float32)
    _build.launch(lib or _build.load(name), name, _ARGTYPES, x0, x_out,
                  logits, *weights, x0.shape[0], int(steps), float(rate))
    return x_out, logits


def fused_refine_conv28(params: FoldedConvD, x0: torch.Tensor, steps: int,
                        rate) -> tuple[torch.Tensor, torch.Tensor]:
    """K refinement steps under the folded D, float32 throughout.
    x0: (B, 28, 28, 1) float32.

    Returns (x_K, logits (B,)). ``rate`` is a float or a 0-d tensor, passed
    to the kernel at run time; the weights are packed on the device by
    ``pack_f32_refine_weights``."""
    _build.check_device(x0, "conv refine")
    return torch.ops.cgs.conv_refine28(x0, list(params), int(steps),
                                       float(rate))


def fused_refine_conv28_bf16(params: FoldedConvD, x0: torch.Tensor,
                             steps: int, rate
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """K refinement steps under the folded D with bf16 matmul operands and
    float32 sums (the TPU kernel's ``bf16=True`` mode). The same contract as
    ``fused_refine_conv28``; the weights are rounded to bf16 and packed on
    the device by ``pack_bf16_refine_weights``."""
    _build.check_device(x0, "bf16 conv refine")
    return torch.ops.cgs.conv_refine28_bf16(x0, list(params), int(steps),
                                            float(rate))


# The VJP's parity classes: (iy % 2, ix % 2) of the h1 cells.
VJP_CLASSES = ((0, 0), (0, 1), (1, 0), (1, 1))


def vjp_schedule() -> list[int]:
    """The order of conv1's VJP taps (dy * 5 + dx): class by class in
    ``VJP_CLASSES`` order, each class's taps (those with py + 1 - dy and
    px + 1 - dx even: 4, 6, 6 and 9 of them) in row-major order; then the
    5 class starts. The kernel reads this table for its VJP loop, and
    ``pack_conv1_f32`` and ``pack_conv1_bf16`` lay the VJP tiles out in the
    same order."""
    taps, starts = [], [0]
    for py, px in VJP_CLASSES:
        taps += [dy * 5 + dx for dy in range(1 - py, 5, 2)
                 for dx in range(1 - px, 5, 2)]
        starts.append(len(taps))
    return taps + starts


@functools.cache
def _schedule_tensor(device: torch.device) -> torch.Tensor:
    """``vjp_schedule()`` as int32 on ``device``, made once per device (a
    copy from the host would wait for the work queued before it)."""
    return torch.tensor(vjp_schedule(), dtype=torch.int32, device=device)


# conv1's weights as the f32 kernel streams them: four 8 KB tiles per tap and
# direction. A forward tile holds 16 input channels x 128 output channels
# ([ci][co]), a VJP tile 32 output channels x 64 input channels ([co][ci]).
F32_TILE_ELEMS = 2048
F32_TAP_TILES = 4


def pack_conv1_f32(w1: torch.Tensor) -> torch.Tensor:
    """w1 (5, 5, 64, 128) f32 -> (200, 2048) f32: the 25 forward taps in
    order, each as 4 tiles w1[tap][16 q : 16 q + 16][:], then the 25 VJP
    taps in ``vjp_schedule`` order, each as 4 tiles w1[tap][:][32 q : 32 q +
    32] transposed to [co][ci]."""
    w = w1.reshape(25, 64, 128)
    fwd = w.reshape(25 * F32_TAP_TILES, F32_TILE_ELEMS)
    taps = _schedule_tensor(w.device)[:25].long()
    vjp = (w[taps].view(25, 64, F32_TAP_TILES, 32).permute(0, 2, 3, 1)
           .reshape(25 * F32_TAP_TILES, F32_TILE_ELEMS))
    return torch.cat([fwd, vjp]).contiguous()


def pack_f32_refine_weights(params: FoldedConvD, dev) -> list[torch.Tensor]:
    """The f32 kernel's weights on ``dev``, in its argument order: w0 as
    (25, 64), b0, w1 as ``pack_conv1_f32`` tiles, the ``vjp_schedule``
    table (int32), b1, wd and bd."""
    b0, b1, wd, bd = _f32_params(params, dev)
    w0 = params.w0.to(dev).reshape(25, 64).contiguous()
    if w0.dtype != torch.float32 or params.w1.dtype != torch.float32:
        raise ValueError("conv refine kernels take float32 weights")
    return [w0, b0, pack_conv1_f32(params.w1.to(dev)), _schedule_tensor(dev),
            b1, wd, bd]


# conv1's weights as the bf16 kernel streams them: one 16 KB tile per tap
# and direction, each the shared-memory image of a K-major wgmma B operand
# in the 128-byte swizzle. A swizzle atom is 8 rows of 128 bytes (64 bf16 of
# K); in row n, the 16-byte chunk j of the K atom sits at chunk j ^ (n % 8).
TILE_ELEMS = 64 * 128
def _sw128(n: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Element offset of B[k][n] (k < 64) within one 64-wide K atom of a
    K-major tile in the 128-byte swizzle: row n holds 64 bf16 of K."""
    return n * 64 + ((k % 64 // 8) ^ (n % 8)) * 8 + k % 8


@functools.cache
def _conv1_tile_index(device: torch.device = torch.device("cpu")
                      ) -> torch.Tensor:
    """index[p] = the flat (tap, ci, co) index of w1 (Flax layout, 25 x 64 x
    128) that goes to element p of the 50 packed tiles; kept on each device
    it was asked for."""
    if device.type != "cpu":
        return _conv1_tile_index().to(device)
    index = torch.empty(50 * TILE_ELEMS, dtype=torch.long)
    ci = torch.arange(64).view(64, 1)
    co = torch.arange(128).view(1, 128)
    for tap in range(25):  # forward: B[k = ci][n = co], one 64-wide atom
        index[tap * TILE_ELEMS + _sw128(co, ci)] = (
            tap * TILE_ELEMS + ci * 128 + co)
    for j, tap in enumerate(vjp_schedule()[:25]):
        # VJP: B[k = co][n = ci], K = 128 in two atoms of 64 rows x 64.
        dest = (25 + j) * TILE_ELEMS + (co // 64) * 4096 + _sw128(ci, co)
        index[dest] = tap * TILE_ELEMS + ci * 128 + co
    return index


def pack_conv1_bf16(w1: torch.Tensor) -> torch.Tensor:
    """w1 (5, 5, 64, 128) -> (50, 8192) bf16: the kernel's 50 tiles, the 25
    forward taps in order, then the 25 VJP taps in ``vjp_schedule`` order.
    w1 is rounded to bf16 (to nearest, ties to even) first."""
    flat = w1.reshape(-1).to(torch.bfloat16)
    return flat[_conv1_tile_index(flat.device)].view(50, TILE_ELEMS)


def pack_bf16_refine_weights(params: FoldedConvD, dev) -> list[torch.Tensor]:
    """The bf16 kernel's weights on ``dev``, in its argument order: w0 as
    (32, 64) bf16 (conv0's 25 taps padded to K = 32 with zeros), b0, w1 as
    ``pack_conv1_bf16`` tiles, the ``vjp_schedule`` table (int32), b1, wd
    and bd."""
    b0, b1, wd, bd = _f32_params(params, dev)
    w0 = F.pad(params.w0.to(dev).reshape(25, 64), (0, 0, 0, 7))
    if w0.dtype != torch.float32 or params.w1.dtype != torch.float32:
        raise ValueError("conv refine kernels take float32 weights")
    return [w0.to(torch.bfloat16).contiguous(), b0,
            pack_conv1_bf16(params.w1.to(dev)), _schedule_tensor(dev), b1,
            wd, bd]


def _refine_plain_f32(params, x0, steps, rate):
    """``refine_conv28_plain``, which refines by autograd, inside an op."""
    with _build.autograd_inside_op():
        return refine_conv28_plain(params, x0, steps, rate)


def _define_conv_refine(entry: str, what: str, plain, pack, wrapper) -> None:
    """The op ``cgs::<entry>``: its CPU implementation is ``plain``, its
    CUDA implementation packs the weights with ``pack`` and launches
    ``entry``, counted on ``wrapper``."""

    def cpu(x0, weights, steps, rate):
        return _build.unaliased(x0, plain(FoldedConvD(*weights), x0, steps,
                                          rate))

    def cuda(x0, weights, steps, rate):
        _check_x0(x0, what)
        with span("cgs.refine.prepare"):
            packed = pack(FoldedConvD(*weights), x0.device)
        return _launch(entry, x0, packed, steps, rate)

    def fake(x0, weights, steps, rate):
        return torch.empty_like(x0), x0.new_empty(x0.shape[0])

    _build.define_op(entry + "(Tensor x0, Tensor[] weights, int steps, "
                     "float rate) -> (Tensor, Tensor)", cpu, cuda, fake,
                     wrapper)


_define_conv_refine("conv_refine28", "conv refine", _refine_plain_f32,
                    pack_f32_refine_weights, fused_refine_conv28)
_define_conv_refine("conv_refine28_bf16", "bf16 conv refine",
                    refine_conv28_plain_bf16, pack_bf16_refine_weights,
                    fused_refine_conv28_bf16)
