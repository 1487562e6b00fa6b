"""Plain DCGAN generator and discriminator, written from the layer semantics
of the reference repository's TF1 / Flax model (arXiv:1511.06434 as that
repository builds it). Imports nothing of the program.

Weights are a dict of tensors under the names ``cardbench/inputs.py`` gives
them, in torch layouts: conv (out, in, 5, 5), transposed conv (in, out, 5,
5) as ``conv_transpose2d`` takes it, dense (out, in). Tensors are NHWC at
the boundary and NCHW inside.

Layer semantics:

* conv 5x5 stride 2 SAME: XLA's padding, ``out = ceil(in / 2)``, the pad
  total ``(out - 1) * 2 + 5 - in`` split low ``total // 2``, high the rest;
* transposed conv 5x5 stride 2 SAME: ``out = 2 * in``; torch's
  ``conv_transpose2d`` at padding 1 gives ``2 * in + 1`` rows and columns,
  and the last of each is dropped;
* BatchNorm, eps 1e-5: in train mode the batch mean and the biased
  variance ``E[x^2] - E[x]^2`` (clipped at 0) over N, H and W, with the
  running averages moved in place as ``r <- 0.9 r + 0.1 batch``; in eval
  mode the running averages;
* G: dense to ``s0 x s0 x ch0`` read as NHWC, BN, relu, then per stage a
  transposed conv, BN and relu, and a last transposed conv with tanh;
* D: conv and lrelu (slope 0.2), then per stage conv, BN and lrelu, and a
  dense head over the features flattened in NHWC order.

Every operand of a matmul or convolution passes through ``q`` (a
``Precision``): unchanged in float32, or rounded to fp8 for the control.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BN_EPS = 1e-5
BN_MOMENTUM = 0.9
LRELU_SLOPE = 0.2
FP8_FORWARD_MAX = 448.0  # largest finite float8_e4m3fn
FP8_BACKWARD_MAX = 57344.0  # largest finite float8_e5m2


def num_stages(size: int) -> int:
    """The stride-2 stages of the DCGAN stack: the largest n <= 4 with
    ``size % 2**n == 0`` and ``size / 2**n >= 4``."""
    n = 0
    while n < 4 and size % 2 == 0 and size // 2 >= 4:
        size //= 2
        n += 1
    return n


def _round_scaled(t: torch.Tensor, dtype: torch.dtype,
                  top: float) -> torch.Tensor:
    """t rounded to ``dtype`` under one scale per tensor (amax to the
    format's largest finite value), carried back as float32."""
    amax = t.detach().abs().amax().float().clamp_min(1e-30)
    scale = top / amax
    return (t.float() * scale).to(dtype).float() / scale


class _Fp8(torch.autograd.Function):
    """Forward operand in e4m3, its gradient in e5m2, each under one scale
    per tensor: the usual split of an fp8 path."""

    @staticmethod
    def forward(ctx, t):
        return _round_scaled(t, torch.float8_e4m3fn, FP8_FORWARD_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round_scaled(g, torch.float8_e5m2, FP8_BACKWARD_MAX)


class Precision:
    """What a matmul or conv operand is rounded to: ``float32`` (nothing)
    or ``fp8`` (the control)."""

    def __init__(self, name: str):
        if name not in ("float32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.name == "float32" else _Fp8.apply(t)


F32 = Precision("float32")


def same_pads(size: int, kernel: int = 5, stride: int = 2) -> tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv_same(x, w, b, q):
    py, px = same_pads(x.shape[2]), same_pads(x.shape[3])
    x = F.pad(x, (px[0], px[1], py[0], py[1]))
    return F.conv2d(q(x), q(w), b, stride=2)


def deconv_same(x, w, b, q):
    h, wd = x.shape[2], x.shape[3]
    y = F.conv_transpose2d(q(x), q(w), b, stride=2, padding=1)
    return y[:, :, :2 * h, :2 * wd]


def batch_norm(x, w: dict, name: str, train: bool):
    """BN over axis 1; in train mode the running averages in ``w`` move."""
    axes = [0] + list(range(2, x.ndim))
    shape = (1, -1) + (1,) * (x.ndim - 2)
    if train:
        mean = x.mean(dim=axes)
        var = (x.square().mean(dim=axes) - mean.square()).clamp_min(0.0)
        with torch.no_grad():
            for key, val in (("running_mean", mean), ("running_var", var)):
                r = w[f"{name}.{key}"]
                r.mul_(BN_MOMENTUM).add_(val.detach(), alpha=1 - BN_MOMENTUM)
    else:
        mean, var = w[f"{name}.running_mean"], w[f"{name}.running_var"]
    mul = torch.rsqrt(var + BN_EPS) * w[f"{name}.weight"]
    return (x - mean.view(shape)) * mul.view(shape) + w[f"{name}.bias"].view(
        shape)


def generate(w: dict, z: torch.Tensor, image_size: int, channels: int,
             base: int, q: Precision = F32) -> torch.Tensor:
    """G in eval mode: z (B, z_dim) -> images (B, H, W, C) in [-1, 1]."""
    n = num_stages(image_size)
    s0, ch0 = image_size // 2 ** n, base * 2 ** (n - 1)
    h = F.linear(q(z), q(w["project.weight"]), w["project.bias"])
    h = h.view(z.shape[0], s0, s0, ch0).permute(0, 3, 1, 2)
    h = torch.relu(batch_norm(h, w, "bn_project", False))
    for i in range(n - 1):
        h = deconv_same(h, w[f"deconv{i}.weight"], w[f"deconv{i}.bias"], q)
        h = torch.relu(batch_norm(h, w, f"bn{i}", False))
    h = deconv_same(h, w["deconv_out.weight"], w["deconv_out.bias"], q)
    return torch.tanh(h).permute(0, 2, 3, 1)


def discriminate(w: dict, x: torch.Tensor, image_size: int,
                 q: Precision = F32, train: bool = False) -> torch.Tensor:
    """D: x (B, H, W, C) -> logits (B,); ``train`` uses batch statistics and
    moves the running averages in ``w``."""
    n = num_stages(image_size)
    h = F.leaky_relu(conv_same(x.permute(0, 3, 1, 2), w["conv0.weight"],
                               w["conv0.bias"], q), LRELU_SLOPE)
    for i in range(1, n):
        h = conv_same(h, w[f"conv{i}.weight"], w[f"conv{i}.bias"], q)
        h = F.leaky_relu(batch_norm(h, w, f"bn{i}", train), LRELU_SLOPE)
    feat = h.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    return F.linear(q(feat), q(w["out.weight"]), w["out.bias"])[:, 0]
