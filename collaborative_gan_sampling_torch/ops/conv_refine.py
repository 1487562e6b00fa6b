"""Fused K-step refinement under the 28x28 DCGAN D: the CUDA kernel's wrapper.

The kernel (``csrc/conv_refine28.cu``) replaces the TPU kernels
``collaborative_gan_sampling_tpu/ops/conv_refine_pallas.py``:
``fused_refine_conv28`` and, at f32 operands, ``fused_refine_conv28_v2``.
Its plain version is ``ops/conv_refine_ref.py::refine_conv28_plain``.

``fused_refine_conv28`` takes the plain version for a tensor on the CPU and
launches the kernel for a tensor on the card; it never falls back from the
card to the plain version. ``supports_conv_refine_kernel`` is the gate that
``sampling/refine.py`` dispatches on.
"""

from __future__ import annotations

import ctypes

import torch

from collaborative_gan_sampling_torch.ops import _build
from collaborative_gan_sampling_torch.ops.conv_refine_ref import (
    FoldedConvD,
    refine_conv28_plain,
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


def fused_refine_conv28(params: FoldedConvD, x0: torch.Tensor, steps: int,
                        rate) -> tuple[torch.Tensor, torch.Tensor]:
    """K refinement steps under the folded D. x0: (B, 28, 28, 1) float32.

    Returns (x_K, logits (B,)). ``rate`` is a float or a 0-d tensor, passed
    to the kernel at run time."""
    if x0.device.type == "cpu":
        return refine_conv28_plain(params, x0, steps, rate)
    if x0.device.type != "cuda":
        raise ValueError(f"no conv refine kernel for device {x0.device}")
    if x0.dtype != torch.float32 or tuple(x0.shape[1:]) != (28, 28, 1):
        raise ValueError("conv refine kernel takes (B, 28, 28, 1) float32, "
                         f"got {tuple(x0.shape)} {x0.dtype}")
    dev = x0.device
    x0 = x0.contiguous()
    w0 = params.w0.to(dev).reshape(25, 64).contiguous()
    w1 = params.w1.to(dev).reshape(25, 64, 128).contiguous()
    w1t = w1.transpose(1, 2).contiguous()
    b0 = params.b0.to(dev).contiguous()
    b1 = params.b1.to(dev).contiguous()
    wd = params.wd.to(dev).reshape(-1).contiguous()
    bd = params.bd.to(dev).reshape(1).contiguous()
    for t in (w0, w1, b0, b1, wd, bd):
        if t.dtype != torch.float32:
            raise ValueError("conv refine kernel takes float32 weights")
    x_out = torch.empty_like(x0)
    logits = torch.empty(x0.shape[0], device=dev, dtype=torch.float32)
    lib = _build.load("conv_refine28")
    fn = lib.conv_refine28
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_int,
                                            ctypes.c_float, ctypes.c_void_p]
    err = fn(_build.ptr(x0), _build.ptr(x_out), _build.ptr(logits),
             _build.ptr(w0), _build.ptr(b0), _build.ptr(w1), _build.ptr(w1t),
             _build.ptr(b1), _build.ptr(wd), _build.ptr(bd),
             x0.shape[0], int(steps), float(rate), _build.stream_of(x0))
    _build.check(lib, err, "conv_refine28")
    fused_refine_conv28.launches += 1
    return x_out, logits


fused_refine_conv28.launches = 0
