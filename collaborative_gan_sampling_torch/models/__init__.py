"""Model factory: the PyTorch counterpart of the JAX package's ``GANBundle``.

In the JAX package the bundle is stateless and variables travel beside it; in
the port the (G, D) state lives in ``nn.Module``s that ``init`` creates, and
the bundle's methods take those modules where the JAX methods take variables:

* ``bundle.generate(g, z, train=False)`` -> samples (B, data_dim) for the
  MLP pair, (B, H, W, C) for the DCGAN pair,
* ``bundle.discriminate(d, x, train=False)`` -> logits (B,); with
  ``train=True`` BatchNorm uses batch statistics and updates its running
  averages in place,
* ``bundle.sample_z(generator, n)``, ``bundle.sample_labels(generator,
  n)`` (int64 labels in [0, num_classes), or None for an unconditional
  pair), ``bundle.init(generator)``.

Class-conditional DCGANs (``num_classes`` > 0) take the labels in
``generate`` and ``discriminate``; the MLP pair is unconditional, as in the
JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from collaborative_gan_sampling_torch.config import ModelConfig
from collaborative_gan_sampling_torch.models.dcgan import (
    DCGANDiscriminator,
    DCGANGenerator,
    num_stages,
    reset_parameters,
)
from collaborative_gan_sampling_torch.models.mlp import (
    MLPDiscriminator,
    MLPGenerator,
)


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The port runs on the card unless the caller asks for the CPU; with no
    card it raises instead of carrying on quietly on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port "
            "on the CPU")
    return device


@dataclass(frozen=True)
class GANBundle:
    """A (G, D) architecture plus the static facts the pipelines need."""

    cfg: ModelConfig
    device: torch.device
    z_dim: int
    data_shape: tuple[int, ...]  # per-sample shape: (2,) or (H, W, C)
    num_classes: int = 0

    @property
    def conditional(self) -> bool:
        return self.num_classes > 0

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.compute_dtype)

    def sample_z(self, generator: torch.Generator, n: int) -> torch.Tensor:
        """z ~ N(0, I), (n, z_dim) float32."""
        return torch.randn((n, self.z_dim), generator=generator,
                           device=self.device)

    def sample_labels(self, generator: torch.Generator | None, n: int
                      ) -> torch.Tensor | None:
        """Uniform class labels, (n,) int64, or None when unconditional."""
        if not self.conditional:
            return None
        return torch.randint(0, self.num_classes, (n,), generator=generator,
                             device=self.device)

    def init(self, generator: torch.Generator
             ) -> tuple[torch.nn.Module, torch.nn.Module]:
        """Fresh (G, D) modules on the bundle's device, initialised from
        ``generator`` (G first, then D): lecun-normal for the MLP pair, the
        DCGAN init for the DCGAN pair."""
        c = self.cfg
        if c.kind == "mlp":
            g = MLPGenerator(c.z_dim, c.g_hidden, c.g_layers, c.data_dim,
                             self.dtype)
            d = MLPDiscriminator(c.data_dim, c.d_hidden, c.d_layers,
                                 self.dtype)
        else:
            g = DCGANGenerator(c.image_size, c.channels, c.g_base_filters,
                               c.z_dim, self.dtype, self.num_classes)
            d = DCGANDiscriminator(c.image_size, c.channels,
                                   c.d_base_filters, self.dtype,
                                   self.num_classes)
        g, d = g.to(self.device), d.to(self.device)
        reset_parameters(g, generator)
        reset_parameters(d, generator)
        return g.eval(), d.eval()

    def generate(self, g: torch.nn.Module, z: torch.Tensor,
                 labels: torch.Tensor | None = None,
                 train: bool = False) -> torch.Tensor:
        return g.train(train)(z, *self._labels(labels))

    def discriminate(self, d: torch.nn.Module, x: torch.Tensor,
                     labels: torch.Tensor | None = None,
                     train: bool = False) -> torch.Tensor:
        return d.train(train)(x, *self._labels(labels))

    def _labels(self, labels) -> tuple:
        """The labels argument of a forward: needed by a conditional pair,
        refused by an unconditional one."""
        if self.conditional != (labels is not None):
            raise ValueError(
                "a conditional model needs labels" if self.conditional
                else "an unconditional model takes no labels")
        return (labels,) if self.conditional else ()


def make_bundle(cfg: ModelConfig, device: str | torch.device | None = None
                ) -> GANBundle:
    device = resolve_device(device)
    if cfg.kind == "mlp":  # the 2D synthetic models are unconditional
        return GANBundle(cfg=cfg, device=device, z_dim=cfg.z_dim,
                         data_shape=(cfg.data_dim,), num_classes=0)
    if cfg.kind != "dcgan":
        raise ValueError(f"unknown model kind {cfg.kind!r}")
    if num_stages(cfg.image_size) == 0:
        raise ValueError(
            f"model.image_size={cfg.image_size} is not supported by the "
            "DCGAN stack: it must halve at least once to a spatial size >= 4")
    shape = (cfg.image_size, cfg.image_size, cfg.channels)
    return GANBundle(cfg=cfg, device=device, z_dim=cfg.z_dim,
                     data_shape=shape, num_classes=cfg.num_classes)
