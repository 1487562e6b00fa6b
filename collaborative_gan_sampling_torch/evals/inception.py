"""Inception-v3 through pool3 (2048 features), the FID network.

Counterpart of ``collaborative_gan_sampling_tpu/evals/inception.py``: the
architecture (stem, Mixed_5b .. Mixed_7c, global average pool), its input
preprocessing, its variables in the JAX package's msgpack format (Flax
``params`` and ``batch_stats``, read and written by ``utils/msgpack.py``),
and a loader for a torchvision / pytorch-fid state dict, whose names the
modules mirror (``Mixed_5b.branch5x5_1.conv.weight`` ...).

As in the FID graph that pytorch-fid reproduces:

* every conv is bias-free conv + BatchNorm (eps 1e-3, running statistics)
  + relu;
* stride-1 convs pad SAME, which is symmetric for their odd kernels (1x7,
  7x1, 3x3, 5x5, ...); the stride-2 convs are VALID;
* the 3x3 / stride-1 average pools divide by the number of real elements
  in the window (``count_include_pad=False``), and Mixed_7c's pool branch is
  a max pool;
* inputs in [-1, 1], grey tiled to 3 channels, bilinear resize to 299x299
  with half-pixel centres (``align_corners=False``; only upsampling, where
  ``jax.image.resize``'s antialiasing does nothing and its edge taps
  reduce to the clamped edge pixel).

Modules take NHWC images as the JAX package's do and run NCHW inside,
float32 with TF32 off on the card.
"""

from __future__ import annotations

import os
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from collaborative_gan_sampling_torch.models import resolve_device
from collaborative_gan_sampling_torch.ops.nn import FlaxBatchNorm, FlaxConv
from collaborative_gan_sampling_torch.utils import msgpack
from collaborative_gan_sampling_torch.utils.precision import no_tf32
from collaborative_gan_sampling_torch.utils.weights import (
    load_jax_variables,
    to_jax_variables,
)

POOL3_DIM = 2048
INPUT_SIZE = 299


class BasicConv(nn.Module):
    """conv (no bias) -> BatchNorm(eps 1e-3, running statistics) -> relu."""

    def __init__(self, cin: int, cout: int, kernel: tuple[int, int],
                 stride: int = 1, padding: str = "SAME"):
        super().__init__()
        self.conv = FlaxConv(cin, cout, kernel, stride, padding, bias=False)
        self.bn = FlaxBatchNorm(cout, eps=1e-3)

    def forward(self, x):
        return torch.relu(self.bn(self.conv(x)))


def _avg_pool_3x3_same(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def _max_pool_3x3_same(x):
    return F.max_pool2d(x, 3, stride=1, padding=1)


def _max_pool_3x3_s2(x):
    return F.max_pool2d(x, 3, stride=2)


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv(cin, 64, (1, 1))
        self.branch5x5_1 = BasicConv(cin, 48, (1, 1))
        self.branch5x5_2 = BasicConv(48, 64, (5, 5))
        self.branch3x3dbl_1 = BasicConv(cin, 64, (1, 1))
        self.branch3x3dbl_2 = BasicConv(64, 96, (3, 3))
        self.branch3x3dbl_3 = BasicConv(96, 96, (3, 3))
        self.branch_pool = BasicConv(cin, pool_features, (1, 1))

    def forward(self, x):
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_3x3_same(x))
        return torch.cat([self.branch1x1(x), b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv(cin, 384, (3, 3), 2, "VALID")
        self.branch3x3dbl_1 = BasicConv(cin, 64, (1, 1))
        self.branch3x3dbl_2 = BasicConv(64, 96, (3, 3))
        self.branch3x3dbl_3 = BasicConv(96, 96, (3, 3), 2, "VALID")

    def forward(self, x):
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([self.branch3x3(x), bd, _max_pool_3x3_s2(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, c7: int):
        super().__init__()
        self.branch1x1 = BasicConv(cin, 192, (1, 1))
        self.branch7x7_1 = BasicConv(cin, c7, (1, 1))
        self.branch7x7_2 = BasicConv(c7, c7, (1, 7))
        self.branch7x7_3 = BasicConv(c7, 192, (7, 1))
        self.branch7x7dbl_1 = BasicConv(cin, c7, (1, 1))
        self.branch7x7dbl_2 = BasicConv(c7, c7, (7, 1))
        self.branch7x7dbl_3 = BasicConv(c7, c7, (1, 7))
        self.branch7x7dbl_4 = BasicConv(c7, c7, (7, 1))
        self.branch7x7dbl_5 = BasicConv(c7, 192, (1, 7))
        self.branch_pool = BasicConv(cin, 192, (1, 1))

    def forward(self, x):
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg_pool_3x3_same(x))
        return torch.cat([self.branch1x1(x), b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv(cin, 192, (1, 1))
        self.branch3x3_2 = BasicConv(192, 320, (3, 3), 2, "VALID")
        self.branch7x7x3_1 = BasicConv(cin, 192, (1, 1))
        self.branch7x7x3_2 = BasicConv(192, 192, (1, 7))
        self.branch7x7x3_3 = BasicConv(192, 192, (7, 1))
        self.branch7x7x3_4 = BasicConv(192, 192, (3, 3), 2, "VALID")

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _max_pool_3x3_s2(x)], 1)


class InceptionE(nn.Module):
    """``pool_branch`` 'avg' is Mixed_7b, 'max' Mixed_7c."""

    def __init__(self, cin: int, pool_branch: str = "avg"):
        super().__init__()
        self.pool = (_max_pool_3x3_same if pool_branch == "max"
                     else _avg_pool_3x3_same)
        self.branch1x1 = BasicConv(cin, 320, (1, 1))
        self.branch3x3_1 = BasicConv(cin, 384, (1, 1))
        self.branch3x3_2a = BasicConv(384, 384, (1, 3))
        self.branch3x3_2b = BasicConv(384, 384, (3, 1))
        self.branch3x3dbl_1 = BasicConv(cin, 448, (1, 1))
        self.branch3x3dbl_2 = BasicConv(448, 384, (3, 3))
        self.branch3x3dbl_3a = BasicConv(384, 384, (1, 3))
        self.branch3x3dbl_3b = BasicConv(384, 384, (3, 1))
        self.branch_pool = BasicConv(cin, 192, (1, 1))

    def forward(self, x):
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       1)
        bp = self.branch_pool(self.pool(x))
        return torch.cat([self.branch1x1(x), b3, bd, bp], 1)


class InceptionV3Features(nn.Module):
    """(B, 299, 299, 3) NHWC -> (B, 2048) pool3 features."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv(3, 32, (3, 3), 2, "VALID")
        self.Conv2d_2a_3x3 = BasicConv(32, 32, (3, 3), 1, "VALID")
        self.Conv2d_2b_3x3 = BasicConv(32, 64, (3, 3))
        self.Conv2d_3b_1x1 = BasicConv(64, 80, (1, 1), 1, "VALID")
        self.Conv2d_4a_3x3 = BasicConv(80, 192, (3, 3), 1, "VALID")
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg")
        self.Mixed_7c = InceptionE(2048, "max")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with no_tf32():
            h = x.float().permute(0, 3, 1, 2)
            h = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(h)))
            h = _max_pool_3x3_s2(h)
            h = _max_pool_3x3_s2(self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(h)))
            for name in ("5b", "5c", "5d", "6a", "6b", "6c", "6d", "6e",
                         "7a", "7b", "7c"):
                h = getattr(self, f"Mixed_{name}")(h)
            return h.mean((2, 3))


def preprocess_for_inception(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] images (B, H, W, C) -> (B, 299, 299, 3): grey tiled to 3
    channels, bilinear resize (half-pixel centres, no antialiasing)."""
    if x.ndim != 4:
        raise ValueError(f"expected (B,H,W,C) images, got {tuple(x.shape)}")
    if x.shape[-1] == 1:
        x = x.expand(-1, -1, -1, 3)
    if x.shape[1] != INPUT_SIZE or x.shape[2] != INPUT_SIZE:
        x = F.interpolate(x.float().permute(0, 3, 1, 2),
                          size=(INPUT_SIZE, INPUT_SIZE), mode="bilinear",
                          align_corners=False, antialias=False)
        x = x.permute(0, 2, 3, 1)
    return x


def init_inception(generator: torch.Generator | None = None,
                   device: str | torch.device | None = None
                   ) -> InceptionV3Features:
    """Randomly initialised Inception-v3 (lecun-normal kernels as Flax's
    default, unit BatchNorm) on ``device`` (default: the card), for tests
    and smoke runs; eval mode."""
    module = InceptionV3Features().to(resolve_device(device))
    for m in module.modules():
        if isinstance(m, FlaxConv):
            m.reset_parameters(generator)
    return module.eval().requires_grad_(False)


def save_inception_params(path: str, module: InceptionV3Features) -> str:
    """Write the module's variables as the JAX package's
    ``save_inception_params`` does (Flax msgpack), atomically."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(msgpack.packb(to_jax_variables(module)))
    os.replace(tmp, path)
    return path


def _validate_tree(template: Any, got: Any, path: str, prefix: str = ""):
    if isinstance(template, Mapping):
        if not isinstance(got, Mapping):
            raise ValueError(
                f"{path}: expected a dict at {prefix or '<root>'}, got "
                f"{type(got).__name__}")
        missing = sorted(set(template) - set(got))
        extra = sorted(set(got) - set(template))
        if missing or extra:
            raise ValueError(
                f"{path}: parameter tree mismatch at {prefix or '<root>'} — "
                f"missing {missing[:4]}, unexpected {extra[:4]}")
        for k in template:
            _validate_tree(template[k], got[k], path, f"{prefix}{k}/")
    elif tuple(np.shape(template)) != tuple(np.shape(got)):
        raise ValueError(
            f"{path}: shape mismatch at {prefix[:-1]}: expected "
            f"{tuple(np.shape(template))}, got {tuple(np.shape(got))}")


def load_inception_from_variables(variables: Mapping,
                                  device: str | torch.device | None = None,
                                  source: str = "variables"
                                  ) -> InceptionV3Features:
    """Inception-v3 from Flax variables (nested dicts of arrays), the tree
    checked against the architecture first (a clear error on mismatch)."""
    module = InceptionV3Features()
    _validate_tree(to_jax_variables(module), variables, source)
    load_jax_variables(module, variables)
    return module.to(resolve_device(device)).eval().requires_grad_(False)


def load_inception(path: str, device: str | torch.device | None = None
                   ) -> InceptionV3Features:
    """Inception-v3 from a variables file of either package."""
    with open(path, "rb") as fh:
        raw = msgpack.unpackb(fh.read())
    return load_inception_from_variables(raw, device, source=path)


def inception_from_torch_state_dict(sd: Mapping[str, Any],
                                    device: str | torch.device | None = None
                                    ) -> InceptionV3Features:
    """Inception-v3 from a torchvision / pytorch-fid state dict (name ->
    tensor or array); ``fc``, ``AuxLogits`` and ``num_batches_tracked``
    entries are not used."""
    module = InceptionV3Features()
    own = module.state_dict()
    missing = sorted(set(own) - set(sd))
    if missing:
        raise ValueError(f"state dict lacks {missing[:4]} "
                         f"({len(missing)} entries)")
    module.load_state_dict({k: torch.as_tensor(sd[k]) for k in own})
    return module.to(resolve_device(device)).eval().requires_grad_(False)


def make_inception_feature_fn(path: str,
                              device: str | torch.device | None = None):
    """feature_fn(x in [-1, 1], (B, H, W, C)) -> (B, 2048) pool3."""
    module = load_inception(path, device)

    def feature_fn(x: torch.Tensor) -> torch.Tensor:
        return module(preprocess_for_inception(x))

    return feature_fn
