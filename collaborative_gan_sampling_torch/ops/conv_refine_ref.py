"""BatchNorm folding and the plain PyTorch version of the fused conv-D refine.

Counterpart of ``collaborative_gan_sampling_tpu/ops/conv_refine_ref.py``:
``fold_dcgan_d`` turns the 28x28 / 64-filter DCGAN discriminator in eval mode
into pure conv / dense parameters (BN1 folded into conv1), in the Flax
layouts, and ``refine_conv28_plain`` runs the K refinement steps through the
folded D with autograd in float32. It is the kernel's plain version: the CPU
path of ``ops/conv_refine.py`` and what the kernel is held against on the
card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from collaborative_gan_sampling_torch.ops.nn import conv2d_same, lrelu


class FoldedConvD(NamedTuple):
    """The 28x28 D with BN folded (eval mode), float32, Flax layouts.

    w0: (5, 5, 1, 64)   conv0
    b0: (64,)
    w1: (5, 5, 64, 128) conv1 with BN1's scale folded in
    b1: (128,)          conv1 bias + BN1 shift
    wd: (6272, 1)       dense head over NHWC-flattened features
    bd: (1,)
    """

    w0: torch.Tensor
    b0: torch.Tensor
    w1: torch.Tensor
    b1: torch.Tensor
    wd: torch.Tensor
    bd: torch.Tensor


@torch.no_grad()
def fold_dcgan_d(d) -> FoldedConvD:
    """Extract and BN-fold the eval-mode params of a two-stage DCGAN D."""
    f32 = torch.float32
    w0 = d.conv0.weight.detach().to(f32).permute(2, 3, 1, 0)
    w1 = d.conv1.weight.detach().to(f32).permute(2, 3, 1, 0)
    bn = d.bn1
    scale = bn.weight.to(f32) / torch.sqrt(bn.running_var.to(f32) + bn.eps)
    shift = bn.bias.to(f32) - bn.running_mean.to(f32) * scale
    return FoldedConvD(
        w0=w0.contiguous(), b0=d.conv0.bias.detach().to(f32),
        w1=(w1 * scale).contiguous(),
        b1=d.conv1.bias.detach().to(f32) * scale + shift,
        wd=d.out.weight.detach().to(f32).t().contiguous(),
        bd=d.out.bias.detach().to(f32))


def d_forward_folded(params: FoldedConvD, x: torch.Tensor) -> torch.Tensor:
    """Logits (B,) of the folded D on x (B, 28, 28, 1)."""
    h = lrelu(conv2d_same(x.permute(0, 3, 1, 2), params.w0.permute(3, 2, 0, 1),
                          params.b0))
    h = lrelu(conv2d_same(h, params.w1.permute(3, 2, 0, 1), params.b1))
    flat = h.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    return (flat @ params.wd + params.bd)[:, 0]


def refine_conv28_plain(params: FoldedConvD, x0: torch.Tensor, steps: int,
                        rate) -> tuple[torch.Tensor, torch.Tensor]:
    """K steps of x <- x - rate * grad_x softplus(-D(x)), then D(x_K).

    Returns (x_K (B, 28, 28, 1), logits (B,)). D in eval mode is per-sample
    decoupled, so the gradient of the summed loss is each sample's own."""
    x = x0.detach().float()
    with torch.enable_grad():
        for _ in range(steps):
            xg = x.requires_grad_(True)
            loss = F.softplus(-d_forward_folded(params, xg)).sum()
            (g,) = torch.autograd.grad(loss, xg)
            x = (xg - rate * g).detach()
    with torch.no_grad():
        logits = d_forward_folded(params, x)
    return x, logits
