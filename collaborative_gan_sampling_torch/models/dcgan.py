"""DCGAN generator / discriminator in PyTorch, unconditional or
class-conditional.

Counterpart of ``collaborative_gan_sampling_tpu/models/dcgan.py``: the same
layers, names and init, computing in ``dtype`` with float32 params. The
modules take and return the JAX package's NHWC layout and run NCHW inside.
The discriminator's dense head reads the features flattened in NHWC order,
as the Flax model does, so its weight converts without a permutation.

With ``num_classes`` > 0, G concatenates a 64-wide label embedding
(``label_embed``) to z before ``project``, and D is a projection
discriminator: logit = out(feat) + <proj_embed(y), feat>, with ``feat`` in
the same NHWC order, so ``proj_embed``'s table converts as it is.
"""

from __future__ import annotations

import torch
from torch import nn

from collaborative_gan_sampling_torch.ops.d_epilogue import (
    NO_AFFINE,
    d_epilogue,
    routes,
)
from collaborative_gan_sampling_torch.ops.nn import (
    Dense,
    Embed,
    FlaxBatchNorm,
    SameConv2d,
    SameConvTranspose2d,
    lrelu,
)


LABEL_EMBED_DIM = 64  # the width of G's label embedding, as in JAX's


def num_stages(size: int) -> int:
    """Number of stride-2 stages: the largest n <= 4 with size % 2^n == 0
    and size / 2^n >= 4."""
    n = 0
    while n < 4 and size % 2 == 0 and size // 2 >= 4:
        size //= 2
        n += 1
    return n


class DCGANGenerator(nn.Module):
    def __init__(self, image_size: int = 32, channels: int = 3,
                 base_filters: int = 64, z_dim: int = 100,
                 dtype: torch.dtype = torch.bfloat16, num_classes: int = 0):
        super().__init__()
        self.image_size, self.channels = image_size, channels
        self.base_filters, self.z_dim, self.dtype = base_filters, z_dim, dtype
        self.num_classes = num_classes
        n = self.n = num_stages(image_size)
        self.s0 = image_size // 2 ** n
        self.ch0 = base_filters * 2 ** (n - 1)
        fan_in = z_dim
        if num_classes > 0:
            self.label_embed = Embed(num_classes, LABEL_EMBED_DIM, dtype)
            fan_in += LABEL_EMBED_DIM
        self.project = Dense(fan_in, self.s0 * self.s0 * self.ch0)
        self.bn_project = FlaxBatchNorm(self.ch0)
        ch_in = self.ch0
        for i in range(n - 1):
            ch = base_filters * 2 ** (n - 2 - i)
            setattr(self, f"deconv{i}", SameConvTranspose2d(ch_in, ch))
            setattr(self, f"bn{i}", FlaxBatchNorm(ch))
            ch_in = ch
        self.deconv_out = SameConvTranspose2d(ch_in, channels)

    def forward(self, z: torch.Tensor,
                labels: torch.Tensor | None = None) -> torch.Tensor:
        """z (B, z_dim) [, labels (B,)] -> images (B, H, W, C) float32 in
        [-1, 1]."""
        h = z.to(self.dtype)
        if self.num_classes > 0:
            h = torch.cat([h, self.label_embed(labels)], dim=-1)
        h = self.project(h)
        # Flax reshapes the dense output as NHWC.
        h = h.view(h.shape[0], self.s0, self.s0, self.ch0).permute(0, 3, 1, 2)
        h = torch.relu(self.bn_project(h))
        for i in range(self.n - 1):
            h = getattr(self, f"deconv{i}")(h)
            h = torch.relu(getattr(self, f"bn{i}")(h))
        h = torch.tanh(self.deconv_out(h))
        return h.permute(0, 2, 3, 1).float()


class DCGANDiscriminator(nn.Module):
    def __init__(self, image_size: int = 32, channels: int = 3,
                 base_filters: int = 64, dtype: torch.dtype = torch.bfloat16,
                 num_classes: int = 0):
        super().__init__()
        self.image_size, self.channels = image_size, channels
        self.base_filters, self.dtype = base_filters, dtype
        self.num_classes = num_classes
        n = self.n = num_stages(image_size)
        self.conv0 = SameConv2d(channels, base_filters)
        for i in range(1, n):
            setattr(self, f"conv{i}", SameConv2d(base_filters * 2 ** (i - 1),
                                                 base_filters * 2 ** i))
            setattr(self, f"bn{i}", FlaxBatchNorm(base_filters * 2 ** i))
        side = image_size // 2 ** n
        feat = side * side * base_filters * 2 ** (n - 1)
        self.out = Dense(feat, 1)
        if num_classes > 0:
            self.proj_embed = Embed(num_classes, feat, dtype)

    def forward(self, x: torch.Tensor,
                labels: torch.Tensor | None = None) -> torch.Tensor:
        """x (B, H, W, C) [, labels (B,)] -> logits (B,) float32.

        In eval mode each conv's epilogue (BN but after conv0, leaky ReLU,
        the next conv's SAME pad) is one ``cgs::d_epilogue_bf16`` where
        ``ops/d_epilogue.py::routes`` takes the conv's output, and the next
        conv reads the padded buffer it writes; elsewhere it is the
        modules' composition."""
        h = x.to(self.dtype).permute(0, 3, 1, 2)
        padded = False
        for i in range(self.n):
            h = getattr(self, f"conv{i}")(h, padded=padded)
            bn = getattr(self, f"bn{i}", None)
            nxt = getattr(self, f"conv{i + 1}", None)
            padded = not self.training and routes(h, bn)
            if padded:
                affine = NO_AFFINE if bn is None else bn.eval_affine()
                pads = (0, 0) if nxt is None else nxt.pads(h.shape[-1])
                h = d_epilogue(h, affine, *pads)
            else:
                h = lrelu(h if bn is None else bn(h))
        feat = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        logit = self.out(feat)[:, 0]
        if self.num_classes > 0:
            logit = logit + torch.sum(self.proj_embed(labels) * feat, dim=-1)
        return logit.float()


def reset_parameters(module: nn.Module, generator=None) -> None:
    """DCGAN init of every layer: N(0, 0.02) kernels, zero biases, unit BN
    scale; draws in module order from ``generator``."""
    for m in module.modules():
        if m is not module and hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)
