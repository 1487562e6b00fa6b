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


def _bf16(t: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Round to bfloat16 (to nearest, ties to even) and carry as ``dtype``."""
    return t.to(torch.bfloat16).to(dtype)


def _pad_same(x: torch.Tensor) -> torch.Tensor:
    """XLA's SAME padding of a stride-2 5x5 conv on an even input: low 1,
    high 2 on both spatial axes of NCHW."""
    return F.pad(x, (1, 2, 1, 2))


def preactivations_bf16(params: FoldedConvD, x: torch.Tensor,
                        dtype=torch.float32
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """conv0's and conv1's pre-activations, (B, 64, 14, 14) and
    (B, 128, 7, 7), of the folded D on x (B, 1, 28, 28) with bf16 matmul
    operands (x, the post-lrelu h1, w0, w1) and sums in ``dtype``."""
    a0 = F.conv2d(_pad_same(_bf16(x, dtype)),
                  _bf16(params.w0, dtype).permute(3, 2, 0, 1),
                  params.b0.to(dtype), stride=2)
    a1 = F.conv2d(_pad_same(_bf16(lrelu(a0), dtype)),
                  _bf16(params.w1, dtype).permute(3, 2, 0, 1),
                  params.b1.to(dtype), stride=2)
    return a0, a1


def refine_conv28_plain_bf16(params: FoldedConvD, x0: torch.Tensor,
                             steps: int, rate, dtype=torch.float32
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
    order of the sums. With ``dtype`` float64 the same operands are
    rounded to bf16 and everything else is float64: the yardstick that
    the float32 versions are held to on trained weights.

    x0: (B, 28, 28, 1). Returns (x_K (B, 28, 28, 1), logits (B,)) in
    ``dtype``."""
    w0 = _bf16(params.w0, dtype).permute(3, 2, 0, 1)  # (64, 1, 5, 5)
    w1 = _bf16(params.w1, dtype).permute(3, 2, 0, 1)  # (128, 64, 5, 5)
    wd = params.wd.to(dtype).reshape(7, 7, 128).permute(2, 0, 1)
    bd = params.bd.to(dtype)

    def forward(x):
        a0, a1 = preactivations_bf16(params, x, dtype)
        h1, h2 = lrelu(a0), lrelu(a1)
        return h1, h2, (h2 * wd).sum((1, 2, 3)) + bd

    x = x0.detach().to(dtype).permute(0, 3, 1, 2)
    with torch.no_grad():
        for _ in range(steps):
            h1, h2, logit = forward(x)
            # d softplus(-l) / dl = -sigmoid(-l)
            dh2 = -torch.sigmoid(-logit)[:, None, None, None] * wd
            dz2 = _bf16(torch.where(h2 > 0, dh2, 0.2 * dh2), dtype)
            dh1 = F.conv_transpose2d(dz2, w1, stride=2)[:, :, 1:15, 1:15]
            dz1 = _bf16(torch.where(h1 > 0, dh1, 0.2 * dh1), dtype)
            dx = F.conv_transpose2d(dz1, w0, stride=2)[:, :, 1:29, 1:29]
            x = x - rate * dx
        logits = forward(x)[2]
    return x.permute(0, 2, 3, 1).contiguous(), logits


def refine_conv28_plain(params: FoldedConvD, x0: torch.Tensor, steps: int,
                        rate, dtype=torch.float32
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """K steps of x <- x - rate * grad_x softplus(-D(x)), then D(x_K), in
    ``dtype`` (float64: the yardstick on trained weights).

    Returns (x_K (B, 28, 28, 1), logits (B,)). D in eval mode is per-sample
    decoupled, so the gradient of the summed loss is each sample's own."""
    params = FoldedConvD(*(t.to(dtype) for t in params))
    x = x0.detach().to(dtype)
    with torch.enable_grad():
        for _ in range(steps):
            xg = x.requires_grad_(True)
            loss = F.softplus(-d_forward_folded(params, xg)).sum()
            (g,) = torch.autograd.grad(loss, xg)
            x = (xg - rate * g).detach()
    with torch.no_grad():
        logits = d_forward_folded(params, x)
    return x, logits


# -- the criterion on trained weights -----------------------------------------
#
# On trained weights an absolute bound on a kernel's distance from its plain
# version does not hold: bn1's running variance falls to ~1e-4 .. 1e-3 and,
# folded into conv1, amplifies every rounding difference up to ~90 times. So
# each float32 version is held to a float64 evaluation of the same function
# (the same bf16-rounded operands, for the bf16 versions), one step at a
# time, by two statistics over the batch of the per-sample |error| on x and
# on the logit: the median and the 90th percentile. Not the max, nor the
# 99th percentile: a pre-activation within rounding of 0 flips lrelu' (slope
# 1 against 0.2) in one version and not in the other, and on trained weights
# a few samples of a batch of 256 flip at a step, so the tail is a draw of
# which version flipped where (the JAX package's f32 kernel reached 3,410
# times the plain version's max x error on one sample; the port's f32
# kernel on an NVIDIA H100, 130 times its 99th percentile at a step where
# it flipped three samples and the plain version one).
#
# f32: each statistic at most F32_FACTOR times the plain version's.
# Versions that differ only in the order of their float32 sums part by a
# few times on these statistics: on the CPU the JAX package's f32 kernel
# (``fused_refine_conv28_v2``, interpret mode) reaches 1.02 times the port's
# plain version, and the plain version 3.5 times the JAX kernel's median
# logit error (tests/test_torch_trained_refine.py).
#
# bf16: each statistic at most the plain version's plus BF16_FRACTION of
# the same statistic of what bf16 rounding itself does to the step (the
# float64 bf16-operand step against the float64 float32 one). A ratio to
# the plain version cannot serve here: where the plain version's error is
# the float32 rounding of x itself, any other summation order is many times
# that (the JAX kernel reached 21 times on the median; a tensor core's
# float32 accumulation of bf16 products more). On the CPU the JAX kernel
# takes at most 0.15 of this allowance where x moves (on a saturated D x
# does not move, and every version sits at the float32 rounding of x); a
# version that did not round its operands would take about 10 times it.
F32_FACTOR = 4.0
BF16_FRACTION = 0.1
GATED = ("x_median", "x_q90", "logit_median", "logit_q90")


def step_errors(out: tuple[torch.Tensor, torch.Tensor],
                yardstick: tuple[torch.Tensor, torch.Tensor]
                ) -> dict[str, float]:
    """Median, 90th and 99th percentiles and max over the batch of each
    sample's |error| against the float64 yardstick: on x (the sample's
    largest pixel error) and on the logit. ``out`` and ``yardstick`` are (x
    (B, 28, 28, 1), logits (B,))."""
    ex = (out[0].double() - yardstick[0]).abs().flatten(1).amax(1)
    el = (out[1].double() - yardstick[1]).abs()
    q = torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64, device=ex.device)
    out = {}
    for name, e in (("x", ex), ("logit", el)):
        med, q90, q99 = torch.quantile(e, q).tolist()
        out.update({f"{name}_median": med, f"{name}_q90": q90,
                    f"{name}_q99": q99, f"{name}_max": float(e.max())})
    return out


def beyond_criterion(errs: dict[str, float], plain: dict[str, float],
                     bf16_effect: dict[str, float] | None = None
                     ) -> list[str]:
    """The gated statistics of ``errs`` beyond the criterion (empty: it
    holds): ``plain[k] + BF16_FRACTION * bf16_effect[k]`` for a bf16
    version, ``F32_FACTOR * plain[k]`` for an f32 one."""
    if bf16_effect is None:
        return [k for k in GATED if errs[k] > F32_FACTOR * plain[k]]
    return [k for k in GATED
            if errs[k] > plain[k] + BF16_FRACTION * bf16_effect[k]]
