"""Fused K-step refinement under the 28x28 DCGAN D: the CUDA kernels' wrappers.

Two kernels replace the TPU kernels of
``collaborative_gan_sampling_tpu/ops/conv_refine_pallas.py``:

* ``csrc/conv_refine28.cu`` (``fused_refine_conv28``): ``fused_refine_conv28``
  and ``fused_refine_conv28_v2`` at f32 operands, all f32 on the CUDA cores;
  plain version ``ops/conv_refine_ref.py::refine_conv28_plain``;
* ``csrc/conv_refine28_bf16.cu`` (``fused_refine_conv28_bf16``):
  ``fused_refine_conv28_v2`` with ``bf16=True``, bf16 matmul operands with
  f32 sums on the tensor cores; plain version ``refine_conv28_plain_bf16``.

Each wrapper takes its plain version for a tensor on the CPU and launches
its kernel for a tensor on the card; it never falls back from the card to
the plain version. ``supports_conv_refine_kernel`` is the gate that
``sampling/refine.py`` dispatches on; the model's compute dtype picks the
kernel.
"""

from __future__ import annotations

import ctypes

import torch

from collaborative_gan_sampling_torch.ops import _build
from collaborative_gan_sampling_torch.ops.conv_refine_ref import (
    FoldedConvD,
    refine_conv28_plain,
    refine_conv28_plain_bf16,
)


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


def _launch(name: str, x0: torch.Tensor, weights: list[torch.Tensor],
            steps: int, rate) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel ``name`` on x0. ``weights``: w0, b0, conv1's weights
    in the layout its forward reads and in the layout its VJP reads, b1, wd,
    bd."""
    x0 = x0.contiguous()
    x_out = torch.empty_like(x0)
    logits = torch.empty(x0.shape[0], device=x0.device, dtype=torch.float32)
    lib = _build.load(name)
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_int,
                                            ctypes.c_float, ctypes.c_void_p]
    err = fn(_build.ptr(x0), _build.ptr(x_out), _build.ptr(logits),
             *(_build.ptr(w) for w in weights), x0.shape[0], int(steps),
             float(rate), _build.stream_of(x0))
    _build.check(lib, err, name)
    return x_out, logits


def fused_refine_conv28(params: FoldedConvD, x0: torch.Tensor, steps: int,
                        rate) -> tuple[torch.Tensor, torch.Tensor]:
    """K refinement steps under the folded D, float32 throughout.
    x0: (B, 28, 28, 1) float32.

    Returns (x_K, logits (B,)). ``rate`` is a float or a 0-d tensor, passed
    to the kernel at run time."""
    if x0.device.type == "cpu":
        return refine_conv28_plain(params, x0, steps, rate)
    _check_x0(x0, "conv refine")
    dev = x0.device
    w1 = params.w1.to(dev).reshape(25, 64, 128).contiguous()
    b0, b1, wd, bd = _f32_params(params, dev)
    w0 = params.w0.to(dev).reshape(25, 64).contiguous()
    if w0.dtype != torch.float32 or w1.dtype != torch.float32:
        raise ValueError("conv refine kernels take float32 weights")
    out = _launch("conv_refine28", x0,
                  [w0, b0, w1, w1.transpose(1, 2).contiguous(), b1, wd, bd],
                  steps, rate)
    fused_refine_conv28.launches += 1
    return out


fused_refine_conv28.launches = 0


def fused_refine_conv28_bf16(params: FoldedConvD, x0: torch.Tensor,
                             steps: int, rate
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """K refinement steps under the folded D with bf16 matmul operands and
    float32 sums (the TPU kernel's ``bf16=True`` mode). The same contract as
    ``fused_refine_conv28``; the wrapper rounds w0 and w1 to bf16 on the
    device after the fold, in the layouts the kernel reads: w1 as
    [tap][co][ci] for conv1's forward and [tap][ci][co] for its VJP."""
    if x0.device.type == "cpu":
        return refine_conv28_plain_bf16(params, x0, steps, rate)
    _check_x0(x0, "bf16 conv refine")
    dev = x0.device
    b0, b1, wd, bd = _f32_params(params, dev)
    bf16 = torch.bfloat16
    w0 = params.w0.to(dev).reshape(25, 64).to(bf16).contiguous()
    w1 = params.w1.to(dev).reshape(25, 64, 128).to(bf16)
    out = _launch("conv_refine28_bf16", x0,
                  [w0, b0, w1.transpose(1, 2).contiguous(), w1.contiguous(),
                   b1, wd, bd], steps, rate)
    fused_refine_conv28_bf16.launches += 1
    return out


fused_refine_conv28_bf16.launches = 0
