"""Feature networks for FID, KID and precision/recall.

Counterpart of ``collaborative_gan_sampling_tpu/evals/features.py``. A
feature function maps images (B, H, W, C) in [-1, 1], NHWC as
``SampleResult.samples`` holds them, to features (B, F); the nets run NCHW
inside, in float32 with TF32 off on the card (``utils/precision.py``).

* ``RandomConvFeatures``: a frozen random conv tower (4 stride-2 3x3
  conv + relu stages, global average pool, dense to 512);
* ``SmallClassifier``: 3 such stages, global average pool, dense 256 + relu
  (the features), dense to the classes; ``train_classifier_features``
  trains it on the dataset's labels, ``train_rotation_features`` on which
  of 4 right-angle rotations was applied (RotNet, for unlabelled data);
  both with Adam at optax's defaults on the mean softmax cross entropy;
* ``inception:<path>``: Inception-v3's pool3 (``evals/inception.py``).

The convs pad as Flax's SAME does, which is asymmetric at stride 2 (for
28 -> 14 -> 7 -> 4 -> 2 the (low, high) pads are (0, 1), (0, 1), (1, 1),
(0, 1)), and a stage keeps stride 2 only while ``min(H, W) >= 2``.

A net initialised by the port has other weights than the JAX package's at
the same seed, so the port labels its own nets ``torch/<name>``: a stats
file written under the other package's net is refused by
``Experiment.real_stats``. ``inception_v3`` keeps its label, its weights
coming from a file.
"""

from __future__ import annotations

import functools
import os
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from collaborative_gan_sampling_torch.models import resolve_device
from collaborative_gan_sampling_torch.ops.nn import FlaxConv, LecunDense
from collaborative_gan_sampling_torch.utils.precision import full_f32, no_tf32

FeatureFn = Callable[[torch.Tensor], torch.Tensor]  # (B,H,W,C) -> (B,F)


def _stride(h: torch.Tensor) -> int:
    return 2 if min(h.shape[-2], h.shape[-1]) >= 2 else 1


class _ConvTower(nn.Module):
    """3x3 SAME conv + relu stages (``conv0`` ..) and a global average pool:
    NHWC images -> (B, last width)."""

    def __init__(self, channels: int, widths: tuple[int, ...]):
        super().__init__()
        self.num_convs = len(widths)
        cin = channels
        for i, w in enumerate(widths):
            setattr(self, f"conv{i}", FlaxConv(cin, w, (3, 3)))
            cin = w

    def pooled(self, x: torch.Tensor) -> torch.Tensor:
        h = x.float().permute(0, 3, 1, 2)
        for i in range(self.num_convs):
            h = torch.relu(getattr(self, f"conv{i}")(h, stride=_stride(h)))
        return h.mean((2, 3))

    def init(self, generator: torch.Generator | None) -> "_ConvTower":
        """Flax's default init (lecun-normal kernels, zero biases), drawn in
        module order from ``generator``."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)
        return self


class RandomConvFeatures(_ConvTower):
    """Frozen random conv tower: widths base * 2^i for 4 stages -> GAP ->
    dense ``proj`` to 512 (fewer than Inception's 2048, which keeps
    finite-sample covariances well conditioned)."""

    def __init__(self, channels: int, base: int = 32, feature_dim: int = 512):
        super().__init__(channels, tuple(base * 2 ** i for i in range(4)))
        self.proj = LecunDense(base * 8, feature_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with no_tf32():
            return self.proj(self.pooled(x))


class SmallClassifier(_ConvTower):
    """Conv classifier whose penultimate layer (``feat``, 256 + relu) is the
    feature: 3 stages of 32, 64, 128, GAP, ``feat``, ``logits``."""

    def __init__(self, channels: int, num_classes: int = 10,
                 feature_dim: int = 256):
        super().__init__(channels, (32, 64, 128))
        self.feat = LecunDense(128, feature_dim)
        self.logits = LecunDense(feature_dim, num_classes)

    def forward(self, x: torch.Tensor, return_features: bool = False
                ) -> torch.Tensor:
        with no_tf32():
            feats = torch.relu(self.feat(self.pooled(x)))
            return feats if return_features else self.logits(feats)


def rotate_batch(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Rotate sample i of NHWC ``x`` by k[i] * 90 degrees (``jnp.rot90``
    over axes (1, 2))."""
    rots = torch.stack([torch.rot90(x, r, dims=(1, 2)) for r in range(4)])
    return rots[k.long(), torch.arange(x.shape[0], device=x.device)]


def draw_rotations(generator: torch.Generator, n: int) -> torch.Tensor:
    """RotNet's labels: n rotations in {0, 1, 2, 3}."""
    return torch.randint(0, 4, (n,), generator=generator,
                         device=generator.device)


@full_f32
def fit_classifier(module: SmallClassifier, batch_fn: Callable, steps: int,
                   lr: float = 1e-3) -> float:
    """``steps`` Adam steps (optax's defaults) on the mean softmax cross
    entropy of ``batch_fn(i) -> (x, labels)``; returns the last loss."""
    opt = torch.optim.Adam(module.parameters(), lr=lr)
    module.train()
    loss = torch.zeros(())
    for i in range(steps):
        x, y = batch_fn(i)
        loss = F.cross_entropy(module(x), y.long())
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    module.eval().requires_grad_(False)
    return float(loss.detach())


def _features(module: SmallClassifier) -> FeatureFn:
    """The penultimate-feature function; its ``func`` is the module."""
    return functools.partial(module, return_features=True)


def _new_classifier(num_classes, image_shape, seed, device, init):
    """``init`` (its weights are taken as they are) or a fresh classifier
    from ``seed``."""
    if init is not None:
        return init.to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return SmallClassifier(image_shape[-1], num_classes).to(device).init(gen)


def train_classifier_features(data_fn: Callable, num_classes: int,
                              image_shape: tuple[int, int, int],
                              steps: int = 1500, batch: int = 256,
                              lr: float = 1e-3, seed: int = 0,
                              device: str | torch.device | None = None,
                              init: SmallClassifier | None = None
                              ) -> tuple[FeatureFn, dict]:
    """Train ``SmallClassifier`` on ``data_fn(generator, n) -> (x,
    labels)``; returns its penultimate-feature function and
    ``{"module", "final_loss"}``. Batches draw in turn from one generator
    seeded from ``seed`` on ``device`` (default: the card)."""
    device = resolve_device(device)
    module = _new_classifier(num_classes, image_shape, seed, device, init)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    loss = fit_classifier(module, lambda i: data_fn(gen, batch), steps, lr)
    return _features(module), {"module": module, "final_loss": loss}


def train_rotation_features(data_fn: Callable,
                            image_shape: tuple[int, int, int],
                            steps: int = 1500, batch: int = 256,
                            lr: float = 1e-3, seed: int = 0,
                            device: str | torch.device | None = None,
                            init: SmallClassifier | None = None
                            ) -> tuple[FeatureFn, dict]:
    """Self-supervised features for unlabelled data (RotNet, Gidaris et al.
    2018): ``SmallClassifier`` with 4 classes learns which rotation
    (``draw_rotations``) was applied to ``data_fn(generator, n) -> x``."""
    device = resolve_device(device)
    module = _new_classifier(4, image_shape, seed, device, init)
    gen = torch.Generator(device=device).manual_seed(seed + 1)

    def batch_fn(i):
        x = data_fn(gen, batch)
        rot = draw_rotations(gen, batch)
        return rotate_batch(x, rot), rot

    loss = fit_classifier(module, batch_fn, steps, lr)
    return _features(module), {"module": module, "final_loss": loss}


def make_feature_fn(spec: str, image_shape: tuple[int, int, int],
                    seed: int = 0, device: str | torch.device | None = None
                    ) -> tuple[FeatureFn, str]:
    """(feature_fn, label) for ``spec``: 'auto' or 'random_conv' (the frozen
    random tower; the pipeline upgrades 'auto' to a trained net), or
    'inception:<path>' (Inception-v3 variables saved by either package)."""
    device = resolve_device(device)
    if spec in ("auto", "random_conv"):
        gen = torch.Generator(device=device).manual_seed(seed)
        module = RandomConvFeatures(image_shape[-1]).to(device).init(gen)
        return module.eval().requires_grad_(False), "torch/random_conv"
    if spec.startswith("inception:"):
        from collaborative_gan_sampling_torch.evals.inception import (
            make_inception_feature_fn,
        )

        path = spec.split(":", 1)[1]
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"Inception weight file {path!r} not found; write one with "
                "evals.inception.save_inception_params (from "
                "variables_from_torch_state_dict for pretrained torchvision/"
                "pytorch-fid weights, or init_inception for random-init "
                "smoke runs)")
        return make_inception_feature_fn(path, device), "inception_v3"
    raise ValueError(f"unknown feature spec {spec!r}")
