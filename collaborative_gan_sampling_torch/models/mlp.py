"""MLP generator / discriminator for the 2D synthetic mixtures, in PyTorch.

Counterpart of ``collaborative_gan_sampling_tpu/models/mlp.py``: relu hidden
layers ``fc0 .. fc{L-1}`` and a linear ``out`` layer, computing in ``dtype``
with float32 params and Flax's default (lecun-normal) init. The layer names
match the Flax module's, so ``utils/weights.py`` carries the variables
across. D has no normalisation layers, so each sample's refinement gradient
is its own; ``ops/refine_mlp.py`` runs the K-step refinement under it as
one kernel.
"""

from __future__ import annotations

import torch
from torch import nn

from collaborative_gan_sampling_torch.ops.nn import LecunDense


def _relu_stack(module: nn.Module, fin: int, hidden: int,
                layers: int) -> None:
    for i in range(layers):
        module.add_module(f"fc{i}", LecunDense(fin if i == 0 else hidden,
                                               hidden))


def _hidden(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    h = x.to(module.dtype)
    for i in range(module.layers):
        h = torch.relu(getattr(module, f"fc{i}")(h))
    return h


class MLPGenerator(nn.Module):
    """z (B, z_dim) -> points (B, out_dim) float32, linear output."""

    def __init__(self, z_dim: int = 4, hidden: int = 128, layers: int = 3,
                 out_dim: int = 2, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layers, self.dtype = layers, dtype
        _relu_stack(self, z_dim, hidden, layers)
        self.out = LecunDense(hidden if layers else z_dim, out_dim)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.out(_hidden(self, z)).float()


class MLPDiscriminator(nn.Module):
    """x (B, data_dim) -> logits (B,) float32."""

    def __init__(self, data_dim: int = 2, hidden: int = 128, layers: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layers, self.dtype = layers, dtype
        _relu_stack(self, data_dim, hidden, layers)
        self.out = LecunDense(hidden if layers else data_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(_hidden(self, x))[:, 0].float()
