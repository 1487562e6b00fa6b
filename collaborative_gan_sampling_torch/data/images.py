"""Image data: a device-resident uint8 store with on-device batch draws.

Counterpart of ``collaborative_gan_sampling_tpu/data/images.py``. The whole
dataset lives on the device as uint8 and each batch is a gather plus
normalisation there. ``load_image_dataset`` reads MNIST / Fashion-MNIST idx
files from ``cfg.path`` when they are there and otherwise builds the same
deterministic procedural image distribution as the JAX package, so every
path stays runnable offline.

``ImageDataset.batch_by_labels`` draws one real image of each requested
class (class-balanced shaping of a conditional D) through a per-class index
table on the device.

Not ported yet: the CIFAR-10 and image-folder loaders (their presets are not
ported either) and resizing file datasets to another ``image_size``.
"""

from __future__ import annotations

import gzip
import math
import os
import struct
import zlib
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from collaborative_gan_sampling_torch.config import DataConfig
from collaborative_gan_sampling_torch.models import resolve_device


@dataclass
class ImageDataset:
    """Device-resident uint8 image store."""

    images: torch.Tensor  # (N, H, W, C) uint8, on the device
    labels: torch.Tensor | None  # (N,) int32, or None for unlabelled data
    name: str = "unknown"
    procedural: bool = False
    # (per-class index table, per-class counts), built at the first
    # batch_by_labels
    _class_table: tuple | None = field(default=None, repr=False)

    @property
    def n(self) -> int:
        return self.images.shape[0]

    @property
    def num_classes(self) -> int:
        """max label + 1 (1 for an empty label set), 0 for unlabelled data."""
        if self.labels is None:
            return 0
        return int(self.labels.max()) + 1 if self.labels.numel() else 1

    @property
    def image_shape(self) -> tuple[int, int, int]:
        return tuple(self.images.shape[1:])

    def batch(self, generator: torch.Generator | None, batch_size: int):
        """(images in [-1, 1] float32 (B, H, W, C), labels or None), drawn
        uniformly with replacement, on the dataset's device."""
        idx = torch.randint(0, self.n, (batch_size,), generator=generator,
                            device=self.images.device)
        labels = self.labels[idx] if self.labels is not None else None
        return normalize_images(self.images[idx]), labels

    def batch_by_labels(self, generator: torch.Generator | None,
                        labels: torch.Tensor):
        """(one image of class ``labels[i]`` per row, in [-1, 1], labels):
        a uniform draw r in [0, 2^30) per row picks entry r % count of the
        class's row of the index table (``batch_by_labels_from``)."""
        r = torch.randint(0, 1 << 30, labels.shape, generator=generator,
                          device=self.images.device)
        return self.batch_by_labels_from(r, labels)

    def batch_by_labels_from(self, r: torch.Tensor, labels: torch.Tensor):
        """``batch_by_labels`` with its draws ``r`` given (the parity
        entry): image ``table[labels, r % counts[labels]]``."""
        table, counts = self.class_table()
        want = labels.to(self.images.device)
        idx = table[want, r.to(self.images.device) % counts[want]]
        return normalize_images(self.images[idx]), labels

    def class_table(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(table (C, cap) int64, counts (C,) int64): row c lists the
        indices of class c, tiled cyclically to the largest class count
        ``cap``; a class with no image has the one entry 0 (count 1)."""
        if self.labels is None:
            raise ValueError(f"dataset {self.name!r} has no labels")
        if self._class_table is None:
            labs = self.labels.cpu().numpy()
            per_class = [np.flatnonzero(labs == c)
                         for c in range(self.num_classes)]
            cap = max(1, max(len(p) for p in per_class))
            table = np.stack([np.resize(p if len(p) else np.zeros(1, int),
                                        cap) for p in per_class])
            counts = np.array([max(len(p), 1) for p in per_class])
            dev = self.images.device
            self._class_table = (torch.from_numpy(table).long().to(dev),
                                 torch.from_numpy(counts).long().to(dev))
        return self._class_table


def normalize_images(u8: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] -> float32 [-1, 1]."""
    return u8.float() / 127.5 - 1.0


def denormalize_images(x: torch.Tensor) -> torch.Tensor:
    """float [-1, 1] -> uint8 [0, 255]: round (half to even, as jnp.round),
    then clip, so 0.0 maps to 128."""
    return torch.clamp(torch.round((x + 1.0) * 127.5), 0, 255).to(torch.uint8)


# ---------------------------------------------------------------------------
# File-format loaders (used when cfg.path exists)
# ---------------------------------------------------------------------------


def _load_idx(path: str) -> np.ndarray:
    """MNIST idx format (idx3-ubyte / idx1-ubyte), optionally gzipped."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as fh:
        magic = struct.unpack(">I", fh.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, fh.read(4 * ndim))
        return np.frombuffer(fh.read(), np.uint8).reshape(dims)


def _find(root: str, names: list[str]) -> str | None:
    for name in names:
        for cand in (os.path.join(root, name),
                     os.path.join(root, name + ".gz")):
            if os.path.exists(cand):
                return cand
    return None


def _load_mnist_like(root: str
                     ) -> tuple[np.ndarray, np.ndarray | None] | None:
    imgs_p = _find(root, ["train-images-idx3-ubyte",
                          "train-images.idx3-ubyte"])
    labs_p = _find(root, ["train-labels-idx1-ubyte",
                          "train-labels.idx1-ubyte"])
    if imgs_p is None:
        return None
    images = _load_idx(imgs_p)[..., None]  # (N, 28, 28, 1)
    # No labels file: the data is unlabelled (None), never all class 0.
    labels = _load_idx(labs_p).astype(np.int32) if labs_p else None
    return images, labels


# ---------------------------------------------------------------------------
# Procedural fallback: a deterministic structured image distribution
# ---------------------------------------------------------------------------


class ProceduralDraws(NamedTuple):
    """The random draws of one chunk of ``m`` procedural images: uniforms
    (u) and standard normals (n), each (m,) except ``noise``
    (m, size, size, channels). ``hue`` is used only for channels > 1."""

    bg_theta: torch.Tensor  # u
    bg_amp: torch.Tensor  # u
    ang: torch.Tensor  # n
    r0: torch.Tensor  # u
    sc: torch.Tensor  # n
    aspect: torch.Tensor  # n
    rot: torch.Tensor  # u
    rad: torch.Tensor  # u
    thick: torch.Tensor  # u
    hue: torch.Tensor  # n
    noise: torch.Tensor  # n


_UNIFORM_DRAWS = ("bg_theta", "bg_amp", "r0", "rot", "rad", "thick")


def procedural_draws(generator: torch.Generator | None, m: int, size: int,
                     channels: int, device) -> ProceduralDraws:
    """The draws of one chunk, in the field order of ``ProceduralDraws``."""
    def draw(name):
        if name == "noise":
            return torch.randn((m, size, size, channels),
                               generator=generator, device=device)
        fn = torch.rand if name in _UNIFORM_DRAWS else torch.randn
        return fn((m,), generator=generator, device=device)

    return ProceduralDraws(*(draw(f) for f in ProceduralDraws._fields))


def build_procedural(labels: torch.Tensor, draws: ProceduralDraws, size: int,
                     channels: int, classes: int) -> torch.Tensor:
    """Images (m, size, size, channels) uint8 from labels (m,) and the
    chunk's draws. Each image composes a smooth background gradient of
    random direction and amplitude, a rotated anisotropic Gaussian body at a
    class-anchored ring position (angle jitter, log-normal scale, aspect,
    orientation), a ring satellite opposite it whose radius and thickness
    vary, a class-keyed hue for colour images, and pixel noise."""
    dev = labels.device
    yy = torch.arange(size, dtype=torch.float32, device=dev)[None, :, None]
    xx = torch.arange(size, dtype=torch.float32, device=dev)[None, None, :]

    def col(t):  # (m,) -> (m, 1, 1)
        return t.reshape(-1, 1, 1)

    d = draws
    bg_theta = col(d.bg_theta) * (2 * math.pi)
    bg_amp = 0.15 * col(d.bg_amp)
    bg = bg_amp * ((xx - size / 2) * torch.cos(bg_theta)
                   + (yy - size / 2) * torch.sin(bg_theta)) / size + 0.2

    angle0 = labels.float() / classes * (2 * math.pi)
    ang = col(angle0 + 0.35 * d.ang)
    r0 = size * col(0.22 + 0.08 * d.r0)
    cx = size / 2 + r0 * torch.cos(ang)
    cy = size / 2 + r0 * torch.sin(ang)
    sc = size / 8 * torch.exp(0.5 * col(d.sc))
    aspect = torch.exp(0.6 * col(d.aspect))
    rot = col(d.rot) * math.pi
    dx, dy = xx - cx, yy - cy
    u = dx * torch.cos(rot) + dy * torch.sin(rot)
    v = -dx * torch.sin(rot) + dy * torch.cos(rot)
    body = 0.9 * torch.exp(-(u ** 2 * aspect + v ** 2 / aspect)
                           / (2 * sc ** 2))

    cx2 = size / 2 - (r0 * 0.8) * torch.cos(ang)
    cy2 = size / 2 - (r0 * 0.8) * torch.sin(ang)
    rad = size * (0.06 + 0.06 * col(d.rad))
    thick = size * 0.02 * (1 + col(d.thick))
    d2 = torch.sqrt((xx - cx2) ** 2 + (yy - cy2) ** 2)
    ring = 0.8 * torch.exp(-((d2 - rad) ** 2) / (2 * thick ** 2))

    lum = torch.clamp(bg + body + ring, 0.0, 1.5)
    if channels == 1:
        img = lum[..., None]
    else:
        hue = col((labels.float() + 1.0) / classes + 0.1 * d.hue)
        mix = torch.stack(
            [0.55 + 0.45 * torch.cos(2 * math.pi * (hue + c / 3.0))
             for c in range(channels)], dim=-1)
        img = lum[..., None] * mix
    img = img + 0.04 * d.noise
    return torch.clamp(torch.round(img * 170), 0, 255).to(torch.uint8)


def procedural_images(name: str, n: int, size: int, channels: int,
                      num_classes: int, seed: int = 0, chunk: int = 4096,
                      device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Deterministic class-conditional structured images, built on the
    device in chunks: (images (n, size, size, channels) uint8, labels (n,)
    int32). The same distribution as the JAX package's, from a
    ``torch.Generator`` seeded by (name, seed), so not the same images."""
    device = resolve_device(device)
    classes = max(num_classes, 1)
    # Keyed by crc32: stable across processes, where Python's str hash is
    # randomized per run.
    name_tag = zlib.crc32(name.encode()) & 0x7FFFFFFF
    gen = torch.Generator(device=device).manual_seed(seed * 2 ** 31
                                                     + name_tag)
    labels = torch.randint(0, classes, (n,), generator=gen, device=device)
    parts = []
    for start in range(0, n, chunk):
        m = min(chunk, n - start)
        draws = procedural_draws(gen, m, size, channels, device)
        parts.append(build_procedural(labels[start:start + m], draws, size,
                                      channels, classes))
    return torch.cat(parts), labels.to(torch.int32)


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

_DATASET_SHAPES = {
    # name: (size, channels, num_classes_for_procedural)
    "mnist": (28, 1, 10),
    "fmnist": (28, 1, 10),
    "cifar10": (32, 3, 10),
    "celeba": (64, 3, 0),
    "imagenet64": (64, 3, 1000),
}


def load_image_dataset(cfg: DataConfig, image_size: int | None = None,
                       max_items: int = 200_000, procedural_n: int = 20_000,
                       device=None) -> ImageDataset:
    """Load ``cfg.dataset`` from ``cfg.path`` if it is there, else build the
    procedural stand-in, on ``device`` (the card unless the caller asks for
    the CPU)."""
    name = cfg.dataset
    if name not in _DATASET_SHAPES:
        raise ValueError(f"unknown image dataset {name!r}")
    device = resolve_device(device)
    size, channels, classes = _DATASET_SHAPES[name]
    if image_size:
        size = image_size

    loaded = None
    if cfg.path and os.path.isdir(cfg.path):
        if name not in ("mnist", "fmnist"):
            raise NotImplementedError(
                f"the {name} file loader is not ported yet")
        loaded = _load_mnist_like(cfg.path)
    if loaded is not None:
        images, labels = loaded
        images = images[:max_items]
        if images.shape[1] != size or images.shape[2] != size:
            raise NotImplementedError(
                f"resizing {name} files to {size}x{size} is not ported yet")
        if labels is not None:
            labels = torch.from_numpy(labels[:max_items]).to(device)
        return ImageDataset(images=torch.from_numpy(images.copy()).to(device),
                            labels=labels, name=name, procedural=False)

    images, labels = procedural_images(name, procedural_n, size, channels,
                                       classes, seed=0, device=device)
    return ImageDataset(images=images,
                        labels=labels if classes > 0 else None,
                        name=name + "(procedural)", procedural=True)
