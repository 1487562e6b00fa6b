"""The port's file datasets (``data/images.py``) against the JAX package's:
the CIFAR-10 pickles, the image folder, and the centre crop and resize that
fit file images to a model's ``image_size``.

Files are written here from a seeded numpy generator, in each dataset's own
format. The loaders must give the same uint8 images and int32 labels bit for
bit. The resize is ``jax.image.resize(..., "bilinear")`` on one side and
the port's ``resize_bilinear`` on the other: JAX's weights summed in
another order, so float32 within 1e-4 (of values up to 255) and, after
rounding, uint8 at most one level apart on at most 0.1% of the values (a
value within rounding of a half). Every resize case that shrinks also
checks that a resize without antialiasing would fail that bound.
"""

import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from collaborative_gan_sampling_torch.config import DataConfig as TDataConfig
from collaborative_gan_sampling_torch.data import images as t_images
from collaborative_gan_sampling_tpu.config import DataConfig
from collaborative_gan_sampling_tpu.data import images as j_images

FLOAT_ATOL = 1e-4
U8_SHARE = 1e-3  # of the values that may sit one level apart


def write_cifar10(root, n_per_batch=6, seed=0):
    """The five ``data_batch_i`` pickles of CIFAR-10's python format in
    ``root``: (images (5n, 32, 32, 3) uint8, labels (5n,)) as written."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    xs, ys = [], []
    for i in range(1, 6):
        x = rng.integers(0, 256, (n_per_batch, 32, 32, 3), dtype=np.uint8)
        y = rng.integers(0, 10, n_per_batch).tolist()
        with open(root / f"data_batch_{i}", "wb") as fh:
            pickle.dump({b"batch_label": f"training batch {i} of 5".encode(),
                         b"labels": y,
                         b"data": x.transpose(0, 3, 1, 2).reshape(-1, 3072),
                         b"filenames": [b"f.png"] * n_per_batch}, fh)
        xs.append(x)
        ys.append(y)
    return np.concatenate(xs), np.concatenate(ys)


def assert_u8_close(got, want):
    got = np.asarray(got).astype(np.int16)
    want = np.asarray(want).astype(np.int16)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert diff.max() <= 1
    assert (diff > 0).mean() <= U8_SHARE


def assert_needs_antialias(x, size, want):
    """Without antialiasing, the resize of float ``x`` (N, H, W, C) misses
    JAX's by far more than the float bound."""
    plain = F.interpolate(torch.from_numpy(np.ascontiguousarray(x)).float()
                          .permute(0, 3, 1, 2), size=(size, size),
                          mode="bilinear", align_corners=False)
    err = np.abs(plain.permute(0, 2, 3, 1).numpy() - np.asarray(want)).max()
    assert err > 100 * FLOAT_ATOL


@pytest.mark.parametrize("sub", ["", "cifar-10-batches-py"])
def test_cifar10_pickles_match_jax(tmp_path, sub):
    images, labels = write_cifar10(tmp_path / sub if sub else tmp_path)
    got = t_images._load_cifar10(str(tmp_path))
    want = j_images._load_cifar10(str(tmp_path))
    for g, w, mine in zip(got, want, (images, labels)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, mine)
    ds = t_images.load_image_dataset(
        TDataConfig(dataset="cifar10", path=str(tmp_path)), device="cpu")
    assert not ds.procedural and ds.name == "cifar10"
    assert ds.labels.dtype == torch.int32
    np.testing.assert_array_equal(ds.images.numpy(), images)
    np.testing.assert_array_equal(ds.labels.numpy(), labels)
    assert t_images._load_cifar10(str(tmp_path / "none")) is None


@pytest.mark.parametrize("case", ["celeba", "cifar_28", "mnist_32",
                                  "odd_16", "no_crop"])
def test_center_crop_resize_matches_jax(case, monkeypatch):
    """Shrinking (CelebA's aligned 218x178, crop 108 -> 64; 32 -> 28; a
    non-square 40x30 -> 16, uncropped), growing (28 -> 32), and a crop as
    large as the image, which is no crop."""
    n, h, w, c, crop, size = {
        "celeba": (4, 218, 178, 3, 108, 64),
        "cifar_28": (16, 32, 32, 3, 0, 28),
        "mnist_32": (4, 28, 28, 1, 0, 32),
        "odd_16": (8, 40, 30, 3, 0, 16),
        "no_crop": (64, 20, 20, 3, 20, 10),
    }[case]
    u8 = np.random.default_rng(len(case)).integers(0, 256, (n, h, w, c),
                                                   dtype=np.uint8)
    x = u8
    if crop and crop < min(h, w):
        top, left = (h - crop) // 2, (w - crop) // 2
        x = u8[:, top:top + crop, left:left + crop]
    want_f = jax.image.resize(jnp.asarray(x, jnp.float32),
                              (n, size, size, c), "bilinear")
    got_f = t_images.resize_bilinear(torch.from_numpy(
        np.ascontiguousarray(x)), size)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f),
                               atol=FLOAT_ATOL, rtol=0)
    if size < x.shape[1]:
        assert_needs_antialias(x, size, want_f)
    got = t_images.center_crop_resize(u8, crop, size, device="cpu")
    assert got.dtype == torch.uint8 and got.shape == (n, size, size, c)
    assert_u8_close(got.numpy(), j_images._center_crop_resize(u8, crop, size))
    # Chunks of the batch give the same images.
    monkeypatch.setattr(t_images, "RESIZE_CHUNK", 3)
    chunked = t_images.center_crop_resize(torch.from_numpy(u8), crop, size,
                                          device="cpu")
    assert torch.equal(chunked, got)


@pytest.mark.parametrize("dataset,size", [("mnist", 32), ("mnist", 20),
                                          ("cifar10", 28)])
def test_file_image_size_override_matches_jax(tmp_path, dataset, size):
    """idx and CIFAR files resized to an overriding model.image_size."""
    if dataset == "cifar10":
        write_cifar10(tmp_path, n_per_batch=4)
    else:
        from tests.test_torch_images import _write_idx

        imgs = np.random.default_rng(3).integers(0, 256, (16, 28, 28),
                                                 dtype=np.uint8)
        _write_idx(tmp_path / "train-images-idx3-ubyte", imgs)
    got = t_images.load_image_dataset(
        TDataConfig(dataset=dataset, path=str(tmp_path)), image_size=size,
        device="cpu")
    want = j_images.load_image_dataset(
        DataConfig(dataset=dataset, path=str(tmp_path)), image_size=size)
    assert not got.procedural and not want.procedural
    assert got.image_shape == tuple(want.images.shape[1:])
    assert got.image_shape[:2] == (size, size)
    assert_u8_close(got.images.numpy(), want.images)
    if want.labels is not None:
        np.testing.assert_array_equal(got.labels.numpy(), want.labels)


def _write_pngs(root, n=8, hw=(60, 50), seed=0):
    from PIL import Image

    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    for i in range(n):
        arr = rng.integers(0, 256, (*hw, 3), dtype=np.uint8)
        Image.fromarray(arr).save(root / f"{i:06d}.png")
    (root / "list_attr.txt").write_text("not an image\n")


def test_image_folder_matches_jax(tmp_path, monkeypatch):
    """8 PNGs of 60x50, crop 40 -> 16, read in chunks of 3, then at most 6
    files; the celeba and imagenet64 datasets read the folder."""
    _write_pngs(tmp_path)
    want, _ = j_images._load_image_folder(str(tmp_path), 40, 16, 100)
    monkeypatch.setattr(t_images, "RESIZE_CHUNK", 3)
    got, labels = t_images._load_image_folder(str(tmp_path), 40, 16, 100,
                                              device="cpu")
    assert labels is None and got.shape == (8, 16, 16, 3)
    assert_u8_close(got.numpy(), want)
    first, _ = t_images._load_image_folder(str(tmp_path), 40, 16, 6,
                                           device="cpu")
    assert torch.equal(first, got[:6])
    for name in ("celeba", "imagenet64"):
        ds = t_images.load_image_dataset(
            TDataConfig(dataset=name, path=str(tmp_path), crop_size=40),
            image_size=16, device="cpu")
        j = j_images.load_image_dataset(
            DataConfig(dataset=name, path=str(tmp_path), crop_size=40),
            image_size=16)
        assert not ds.procedural and ds.name == j.name == name
        assert ds.labels is None and j.labels is None
        assert_u8_close(ds.images.numpy(), j.images)
    empty = tmp_path / "empty"
    empty.mkdir()
    assert t_images._load_image_folder(str(empty), 40, 16, 100,
                                       device="cpu") is None


def test_image_folder_without_pil(tmp_path, monkeypatch):
    """With PIL unimportable the folder loader returns None, as JAX's does,
    and the dataset falls back to the procedural stand-in."""
    _write_pngs(tmp_path, n=2)
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert j_images._load_image_folder(str(tmp_path), 40, 16, 100) is None
    assert t_images._load_image_folder(str(tmp_path), 40, 16, 100,
                                       device="cpu") is None
    ds = t_images.load_image_dataset(
        TDataConfig(dataset="celeba", path=str(tmp_path)), image_size=16,
        procedural_n=8, device="cpu")
    assert ds.procedural and ds.name == "celeba(procedural)"
    assert ds.image_shape == (16, 16, 3)
