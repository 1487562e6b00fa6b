"""BatchNorm folding and the plain PyTorch version of the fused conv-D refine.

Counterpart of ``collaborative_gan_sampling_tpu/ops/conv_refine_ref.py``:
``fold_dcgan_d`` turns the 28x28 / 64-filter DCGAN discriminator in eval mode
into pure conv / dense parameters (BN1 folded into conv1), in the Flax
layouts, and ``refine_conv28_plain`` runs the K refinement steps through the
folded D with autograd in float32. ``refine_conv28_plain_bf16`` runs them
with bf16 matmul operands and float32 sums, as the TPU kernel's bf16 mode
does. They are the two kernels' plain versions: the CPU paths of
``ops/conv_refine.py`` and what the kernels are held against on the card.
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


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16 (to nearest, ties to even) and carry as float32."""
    return t.to(torch.bfloat16).float()


def _pad_same(x: torch.Tensor) -> torch.Tensor:
    """XLA's SAME padding of a stride-2 5x5 conv on an even input: low 1,
    high 2 on both spatial axes of NCHW."""
    return F.pad(x, (1, 2, 1, 2))


def preactivations_bf16(params: FoldedConvD, x: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """conv0's and conv1's pre-activations, (B, 64, 14, 14) and
    (B, 128, 7, 7), of the folded D on x (B, 1, 28, 28) with bf16 matmul
    operands (x, the post-lrelu h1, w0, w1) and float32 sums."""
    a0 = F.conv2d(_pad_same(_bf16(x)), _bf16(params.w0).permute(3, 2, 0, 1),
                  params.b0.float(), stride=2)
    a1 = F.conv2d(_pad_same(_bf16(lrelu(a0))),
                  _bf16(params.w1).permute(3, 2, 0, 1), params.b1.float(),
                  stride=2)
    return a0, a1


def refine_conv28_plain_bf16(params: FoldedConvD, x0: torch.Tensor,
                             steps: int, rate
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The bf16-operand refinement: what ``fused_refine_conv28_v2`` computes
    with ``bf16=True`` (``_refine_kernel_v2`` with ``mm_dtype`` bfloat16).

    Every matmul operand is rounded to bf16 and the products are summed in
    float32: x for conv0, the post-lrelu h1 for conv1, dz2 = lrelu'(h2) *
    dlogit * wd for conv1's input-VJP, dz1 for conv0's input-VJP, and the
    weights w0 and w1 (BN folded in float32 first). Biases, lrelu, the dense
    head, the sigmoid, the update x - rate * dx and x itself stay float32.
    The forward and the input-VJP are written out (no autograd through the
    casts, whose backward would round at other points). A product of two
    bf16 values is exact in float32, so this is v2's function up to the
    order of the sums.

    x0: (B, 28, 28, 1). Returns (x_K (B, 28, 28, 1) float32, logits (B,))."""
    w0 = _bf16(params.w0).permute(3, 2, 0, 1)  # (64, 1, 5, 5)
    w1 = _bf16(params.w1).permute(3, 2, 0, 1)  # (128, 64, 5, 5)
    wd = params.wd.float().reshape(7, 7, 128).permute(2, 0, 1)  # (128, 7, 7)
    bd = params.bd.float()

    def forward(x):
        a0, a1 = preactivations_bf16(params, x)
        h1, h2 = lrelu(a0), lrelu(a1)
        return h1, h2, (h2 * wd).sum((1, 2, 3)) + bd

    x = x0.detach().float().permute(0, 3, 1, 2)
    with torch.no_grad():
        for _ in range(steps):
            h1, h2, logit = forward(x)
            # d softplus(-l) / dl = -sigmoid(-l)
            dh2 = -torch.sigmoid(-logit)[:, None, None, None] * wd
            dz2 = _bf16(torch.where(h2 > 0, dh2, 0.2 * dh2))
            dh1 = F.conv_transpose2d(dz2, w1, stride=2)[:, :, 1:15, 1:15]
            dz1 = _bf16(torch.where(h1 > 0, dh1, 0.2 * dh1))
            dx = F.conv_transpose2d(dz1, w0, stride=2)[:, :, 1:29, 1:29]
            x = x - rate * dx
        logits = forward(x)[2]
    return x.permute(0, 2, 3, 1).contiguous(), logits


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
