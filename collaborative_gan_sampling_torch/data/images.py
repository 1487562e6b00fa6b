"""Image data: a device-resident uint8 store with on-device batch draws.

Counterpart of ``collaborative_gan_sampling_tpu/data/images.py``. The whole
dataset lives on the device as uint8 and each batch is a gather plus
normalisation there. ``load_image_dataset`` reads the dataset's files from
``cfg.path`` when they are there (MNIST / Fashion-MNIST idx files, the
CIFAR-10 python pickles, or a folder of CelebA / ImageNet-64 jpg and png
files) and otherwise builds the same deterministic procedural image
distribution as the JAX package, so every path stays runnable offline.
File images of another size than the model's are centre-cropped (folders)
and resized on the device by ``center_crop_resize``: JAX's bilinear resize,
which antialiases when it shrinks, summed in a fixed order so that the
card and the CPU give the same bits, in chunks of images so that a large
folder never needs the whole float32 set on the card at once. Held to the
JAX package's ``_center_crop_resize`` in ``tests/test_torch_files.py``:
float32 within 1e-4 before rounding, uint8 at most one level apart on at
most 0.1% of the values.

``ImageDataset.batch_by_labels`` draws one real image of each requested
class (class-balanced shaping of a conditional D) through a per-class index
table on the device.
"""

from __future__ import annotations

import gzip
import math
import os
import pickle
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


def _load_cifar10(root: str) -> tuple[np.ndarray, np.ndarray] | None:
    """The five CIFAR-10 python pickles ``data_batch_1`` .. ``_5``, in
    ``root`` or in ``root/cifar-10-batches-py``: (images (N, 32, 32, 3)
    uint8, labels (N,) int32), or None when they are not there. Each
    pickle's ``b"data"`` is (n, 3072) uint8 in CHW order. The pickles are
    the dataset's own files, read from the path the user configured."""
    batches = [os.path.join(root, f"data_batch_{i}") for i in range(1, 6)]
    sub = os.path.join(root, "cifar-10-batches-py")
    if not os.path.exists(batches[0]) and os.path.isdir(sub):
        batches = [os.path.join(sub, f"data_batch_{i}")
                   for i in range(1, 6)]
    if not os.path.exists(batches[0]):
        return None
    xs, ys = [], []
    for b in batches:
        with open(b, "rb") as fh:
            d = pickle.load(fh, encoding="bytes")
        xs.append(np.asarray(d[b"data"], np.uint8).reshape(-1, 3, 32, 32)
                  .transpose(0, 2, 3, 1))
        ys.append(np.asarray(d[b"labels"], np.int32))
    return np.concatenate(xs), np.concatenate(ys)


def _on_device(u8, device) -> torch.Tensor:
    """A contiguous copy of numpy or torch ``u8`` on ``device``."""
    if isinstance(u8, torch.Tensor):
        return u8.contiguous().to(device)
    return torch.tensor(u8, device=device)


def _resize_taps(n_in: int, n_out: int) -> tuple[np.ndarray, np.ndarray]:
    """The weights of ``jax.image.resize(..., "bilinear")`` along one axis
    of ``n_in`` -> ``n_out`` samples (JAX's ``compute_weight_mat``: a
    triangle kernel at half-pixel centres, widened by the scale when
    shrinking, each output's weights normalised to sum to 1), computed in
    float32, as (index (T, n_out) int64, weight (T, n_out) float32): each
    output's nonzero taps in input order, padded with weight 0."""
    f32 = np.float32
    # As JAX: the scale and its inverse in double precision, then float32.
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    dist = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None])
    w = np.maximum(f32(0), f32(1) - dist / kernel_scale)
    total = w.sum(0, keepdims=True)
    w = np.where(np.abs(total) > 1000 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1)), f32(0))
    w = np.where(((sample >= -0.5) & (sample <= n_in - 0.5))[None, :], w,
                 f32(0)).astype(f32)
    nz = w != 0
    taps = max(1, int(nz.sum(0).max()))
    index = np.zeros((taps, n_out), np.int64)
    weight = np.zeros((taps, n_out), f32)
    for o in range(n_out):
        rows = np.flatnonzero(nz[:, o])
        index[:len(rows), o] = rows
        weight[:len(rows), o] = w[rows, o]
    return index, weight


def _resize_axis(x: torch.Tensor, axis: int, size: int) -> torch.Tensor:
    """``x`` resized along ``axis``: out = sum_t w_t * x[index_t], the taps
    in input order, each product and sum a separate float32 op, so that
    every device rounds the same way and gives the same bits."""
    index, weight = _resize_taps(x.shape[axis], size)
    shape = [1] * x.ndim
    shape[axis] = size
    out = None
    for i, w in zip(index, weight):
        term = (x.index_select(axis, torch.from_numpy(i).to(x.device))
                * torch.from_numpy(w).to(x.device).reshape(shape))
        out = term if out is None else out + term
    return out


def resize_bilinear(x: torch.Tensor, size: int) -> torch.Tensor:
    """float (N, H, W, C) -> float32 (N, size, size, C): the bilinear resize
    of ``jax.image.resize(..., "bilinear")``, which antialiases when it
    shrinks (``_resize_taps``), height then width as JAX contracts them.
    The card and the CPU give the same bits: an output within rounding of
    a half (about 1.5% of them lie within 1e-4 of one at 32 -> 28) rounds
    alike on both, where two summation orders would part on up to 0.3% of
    the uint8 values."""
    x = x.float()
    for axis in (1, 2):
        if x.shape[axis] != size:
            x = _resize_axis(x, axis, size)
    return x.contiguous()


# Images resized at a time: 2,048 crops of 108 x 108 x 3 are 287 MB of
# float32 on the device, where CelebA's 200,000 would be 28 GB.
RESIZE_CHUNK = 2048


def center_crop_resize(u8, crop: int, size: int,
                       device=None) -> torch.Tensor:
    """uint8 images (N, H, W, C), numpy or torch, -> uint8 (N, size, size,
    C) on ``device``: a centred ``crop`` x ``crop`` window where ``crop``
    is set and smaller than both sides, then, where the height is not
    ``size``, ``resize_bilinear`` rounded half to even and clipped to
    [0, 255]. ``RESIZE_CHUNK`` images at a time go to the device; each
    image is independent, so the chunks do not change the result."""
    device = resolve_device(device)
    x = u8
    h, w = x.shape[1:3]
    if crop and crop < min(h, w):
        top, left = (h - crop) // 2, (w - crop) // 2
        x = x[:, top:top + crop, left:left + crop]
    if x.shape[1] == size:
        return _on_device(x, device)
    parts = []
    for start in range(0, x.shape[0], RESIZE_CHUNK):
        part = resize_bilinear(
            _on_device(x[start:start + RESIZE_CHUNK], device), size)
        parts.append(torch.clamp(torch.round(part), 0, 255)
                     .to(torch.uint8))
    return torch.cat(parts)


def _load_image_folder(root: str, crop: int, size: int, max_items: int,
                       device=None) -> tuple[torch.Tensor, None] | None:
    """A CelebA-style folder: the sorted ``.jpg`` / ``.jpeg`` / ``.png``
    files of ``root`` (up to ``max_items``), each read through PIL as RGB,
    then ``center_crop_resize``d on ``device`` ``RESIZE_CHUNK`` files at a
    time, so that the host never holds the whole folder's raw pixels:
    (images (N, size, size, 3) uint8, None). None when PIL is not
    installed or the folder holds no such file."""
    try:
        from PIL import Image
    except ImportError:
        return None
    files = sorted(
        os.path.join(root, f) for f in os.listdir(root)
        if f.lower().endswith((".jpg", ".jpeg", ".png")))[:max_items]
    if not files:
        return None
    parts = []
    for start in range(0, len(files), RESIZE_CHUNK):
        raw = []
        for f in files[start:start + RESIZE_CHUNK]:
            with Image.open(f) as im:
                raw.append(np.asarray(im.convert("RGB"), np.uint8))
        parts.append(center_crop_resize(np.stack(raw), crop, size, device))
    return torch.cat(parts), None


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
        if name in ("mnist", "fmnist"):
            loaded = _load_mnist_like(cfg.path)
        elif name == "cifar10":
            loaded = _load_cifar10(cfg.path)
        else:  # celeba, imagenet64: a folder of image files
            loaded = _load_image_folder(cfg.path, cfg.crop_size, size,
                                        max_items, device)
    if loaded is not None:
        images, labels = loaded
        images = images[:max_items]
        # idx and CIFAR files come at their own resolution: a
        # model.image_size override resizes them on the device (the folder
        # loader has resized already).
        if images.shape[1] != size or images.shape[2] != size:
            images = center_crop_resize(images, 0, size, device)
        if labels is not None:
            labels = torch.from_numpy(labels[:max_items]).to(device)
        return ImageDataset(images=_on_device(images, device),
                            labels=labels, name=name, procedural=False)

    images, labels = procedural_images(name, procedural_n, size, channels,
                                       classes, seed=0, device=device)
    return ImageDataset(images=images,
                        labels=labels if classes > 0 else None,
                        name=name + "(procedural)", procedural=True)
