"""Parity of the port's image stream (``data/images.py``) with the JAX
package's: the idx reader, the procedural images with JAX's draws injected,
``ImageDataset.batch`` and the procedural fallback of
``load_image_dataset``.

``procedural_images`` draws with ``jax.random`` on one side and a
``torch.Generator`` on the other, so the test rebuilds JAX's key splits,
draws there and hands the draws to the port's ``build_procedural``. The two
sides then compute the same float32 arithmetic (sin, cos, exp, sqrt) with
their own libraries before rounding to uint8: equal except at most one
level on at most 0.1% of the pixels, where a value lay within rounding of a
half.
"""

import gzip
import struct
import zlib

import jax
import numpy as np
import pytest
import torch

from collaborative_gan_sampling_torch.config import DataConfig as TDataConfig
from collaborative_gan_sampling_torch.data import images as t_images
from collaborative_gan_sampling_torch.data.images import (
    ImageDataset,
    ProceduralDraws,
    build_procedural,
    load_image_dataset as t_load_image_dataset,
    normalize_images as t_normalize_images,
    procedural_images as t_procedural_images,
)
from collaborative_gan_sampling_tpu.config import DataConfig
from collaborative_gan_sampling_tpu.data import images as j_images


def _write_idx(path, arr):
    """An idx file (``.gz`` when the name says so) holding uint8 ``arr``."""
    head = struct.pack(">I", 0x0800 | arr.ndim)
    head += struct.pack(">" + "I" * arr.ndim, *arr.shape)
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wb") as fh:
        fh.write(head + arr.astype(np.uint8).tobytes())


@pytest.fixture
def idx_dir(tmp_path):
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 256, (6, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, (6,), dtype=np.uint8)
    _write_idx(tmp_path / "train-images-idx3-ubyte.gz", imgs)
    _write_idx(tmp_path / "train-labels-idx1-ubyte", labels)
    return tmp_path, imgs, labels


def test_idx_reader_matches_jax(idx_dir):
    root, imgs, labels = idx_dir
    for name, want in (("train-images-idx3-ubyte.gz", imgs),
                       ("train-labels-idx1-ubyte", labels)):
        got = t_images._load_idx(str(root / name))
        np.testing.assert_array_equal(got, j_images._load_idx(str(root / name)))
        np.testing.assert_array_equal(got, want)
    t_imgs, t_labs = t_images._load_mnist_like(str(root))
    j_imgs, j_labs = j_images._load_mnist_like(str(root))
    assert t_imgs.shape == (6, 28, 28, 1) and t_labs.dtype == np.int32
    np.testing.assert_array_equal(t_imgs, j_imgs)
    np.testing.assert_array_equal(t_labs, j_labs)
    assert t_images._find(str(root), ["nothing"]) is None


def test_load_image_dataset_reads_idx_files(idx_dir):
    root, imgs, labels = idx_dir
    ds = t_load_image_dataset(TDataConfig(dataset="mnist", path=str(root)),
                              device="cpu")
    assert not ds.procedural and ds.name == "mnist" and ds.n == 6
    np.testing.assert_array_equal(ds.images.numpy()[..., 0], imgs)
    np.testing.assert_array_equal(ds.labels.numpy(), labels)
    # Unlabelled when the labels file is missing.
    (root / "train-labels-idx1-ubyte").unlink()
    ds = t_load_image_dataset(TDataConfig(dataset="fmnist", path=str(root)),
                              device="cpu")
    assert ds.labels is None and ds.image_shape == (28, 28, 1)


def _jax_draws(name, n, size, channels, classes, seed=0):
    """The labels and the first chunk's draws of JAX's procedural_images."""
    tag = zlib.crc32(name.encode()) & 0x7FFFFFFF
    base = jax.random.fold_in(jax.random.PRNGKey(seed), tag)
    labels = jax.random.randint(jax.random.fold_in(base, 0), (n,), 0, classes)
    ks = jax.random.split(jax.random.fold_in(base, 1), 12)

    def u(k):
        return torch.from_numpy(np.array(jax.random.uniform(k, (n,))))

    def nrm(k, shape=(n,)):
        return torch.from_numpy(np.array(jax.random.normal(k, shape)))

    draws = ProceduralDraws(
        bg_theta=u(ks[0]), bg_amp=u(ks[1]), ang=nrm(ks[2]), r0=u(ks[3]),
        sc=nrm(ks[4]), aspect=nrm(ks[5]), rot=u(ks[6]), rad=u(ks[7]),
        thick=u(ks[8]), hue=nrm(ks[9]),
        noise=nrm(ks[10], (n, size, size, channels)))
    return torch.from_numpy(np.array(labels)), draws


@pytest.mark.parametrize("name,size,channels,classes",
                         [("mnist", 28, 1, 10), ("cifar10", 32, 3, 10)])
def test_build_procedural_matches_jax(name, size, channels, classes):
    n = 64
    want, want_labels = j_images.procedural_images(name, n, size, channels,
                                                   classes, chunk=n)
    labels, draws = _jax_draws(name, n, size, channels, classes)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want_labels))
    got = build_procedural(labels, draws, size, channels, classes)
    assert got.dtype == torch.uint8 and got.shape == (n, size, size,
                                                      channels)
    diff = np.abs(got.numpy().astype(np.int32)
                  - np.asarray(want).astype(np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3
    assert np.asarray(want).std() > 10  # the images are not flat


def test_procedural_images_deterministic_and_alike():
    """The port's own draws: deterministic per (name, seed), other names and
    seeds differ, and the distribution matches JAX's in its first moments."""
    a, la = t_procedural_images("mnist", 512, 28, 1, 10, device="cpu",
                                chunk=200)
    b, lb = t_procedural_images("mnist", 512, 28, 1, 10, device="cpu",
                                chunk=200)
    assert torch.equal(a, b) and torch.equal(la, lb)
    assert la.dtype == torch.int32 and 0 <= int(la.min()) <= int(la.max()) < 10
    c, _ = t_procedural_images("fmnist", 512, 28, 1, 10, device="cpu")
    d, _ = t_procedural_images("mnist", 512, 28, 1, 10, seed=1, device="cpu")
    assert not torch.equal(a, c) and not torch.equal(a, d)
    j, _ = j_images.procedural_images("mnist", 512, 28, 1, 10)
    j = np.asarray(j, np.float64)
    t = a.numpy().astype(np.float64)
    assert abs(t.mean() - j.mean()) < 0.03 * j.mean()
    assert abs(t.std() - j.std()) < 0.03 * j.std()


def test_dataset_batch_shapes_and_range():
    ds = t_load_image_dataset(TDataConfig(dataset="mnist"), procedural_n=256,
                              device="cpu")
    x, labels = ds.batch(torch.Generator().manual_seed(0), 32)
    assert x.shape == (32, 28, 28, 1) and x.dtype == torch.float32
    assert float(x.min()) >= -1.0 and float(x.max()) <= 1.0
    assert labels.shape == (32,) and labels.dtype == torch.int32
    x2, labels2 = ds.batch(torch.Generator().manual_seed(0), 32)
    assert torch.equal(x, x2) and torch.equal(labels, labels2)
    # Each drawn image is one of the dataset's, normalized.
    flat = t_normalize_images(ds.images).reshape(ds.n, -1)
    hits = (x.reshape(32, 1, -1) == flat[None]).all(-1)
    assert bool(hits.any(1).all())
    unlabelled = ImageDataset(images=ds.images, labels=None)
    assert unlabelled.batch(None, 4)[1] is None


def test_normalize_matches_jax():
    u8 = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)
    np.testing.assert_array_equal(
        t_normalize_images(torch.from_numpy(u8)).numpy(),
        np.asarray(j_images.normalize_images(u8)))


def test_procedural_fallback_without_path(tmp_path):
    for path in ("", str(tmp_path / "missing")):
        ds = t_load_image_dataset(TDataConfig(dataset="mnist", path=path),
                                  procedural_n=64, device="cpu")
        j = j_images.load_image_dataset(DataConfig(dataset="mnist",
                                                   path=path),
                                        procedural_n=64)
        assert ds.procedural and j.procedural and ds.name == j.name
        assert ds.images.shape == tuple(j.images.shape) == (64, 28, 28, 1)
        assert ds.images.dtype == torch.uint8
        assert ds.labels.shape == (64,)
    celeba = t_load_image_dataset(TDataConfig(dataset="celeba"),
                                  image_size=16, procedural_n=8,
                                  device="cpu")
    assert celeba.labels is None and celeba.image_shape == (16, 16, 3)
    with pytest.raises(ValueError, match="unknown image dataset"):
        t_load_image_dataset(TDataConfig(dataset="ring8"), device="cpu")
    # A cifar10 path without the pickles falls back as JAX's does; one
    # with them loads (tests/test_torch_files.py holds the loader to JAX's).
    empty = t_load_image_dataset(TDataConfig(dataset="cifar10",
                                             path=str(tmp_path)),
                                 procedural_n=8, device="cpu")
    assert empty.procedural and empty.name == "cifar10(procedural)"
    from tests.test_torch_files import write_cifar10

    images, labels = write_cifar10(tmp_path / "cifar", n_per_batch=2)
    ds = t_load_image_dataset(TDataConfig(dataset="cifar10",
                                          path=str(tmp_path / "cifar")),
                              device="cpu")
    assert not ds.procedural and ds.name == "cifar10"
    np.testing.assert_array_equal(ds.images.numpy(), images)
    np.testing.assert_array_equal(ds.labels.numpy(), labels)
