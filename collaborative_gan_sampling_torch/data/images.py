"""Image helpers of ``collaborative_gan_sampling_tpu/data/images.py`` that
the port needs. The dataset loaders and the procedural MNIST stream are not
ported yet."""

from __future__ import annotations

import torch


def denormalize_images(x: torch.Tensor) -> torch.Tensor:
    """float [-1, 1] -> uint8 [0, 255]: round (half to even, as jnp.round),
    then clip, so 0.0 maps to 128."""
    return torch.clamp(torch.round((x + 1.0) * 127.5), 0, 255).to(torch.uint8)
