"""The conditional path through the port's ``Experiment`` and CLI on the
CPU: ``intra_fid`` held to the JAX Experiment's on the same labelled pool,
the same real batch and the same feature net (the JAX classifier's weights
carried into the port), at rtol 1e-5 (each class's float64 host distance
of float32 features that differ by summation order); and the
``imagenet64`` preset cut to a tiny width (16x16, 8 filters, z = 16; its
1,000 classes kept) trained, sampled with every method, scored, served by
class and run from ``cli generate ... class=3``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collaborative_gan_sampling_torch import cli
from collaborative_gan_sampling_torch.config import (
    apply_overrides,
    get_preset,
)
from collaborative_gan_sampling_torch.evals import features as tfeat
from collaborative_gan_sampling_torch.pipeline import Experiment
from collaborative_gan_sampling_torch.sampling.collab import SampleResult
from collaborative_gan_sampling_torch.utils.weights import load_jax_params
from collaborative_gan_sampling_tpu import config as jconfig
from collaborative_gan_sampling_tpu.evals import features as jfeat
from collaborative_gan_sampling_tpu.pipeline import Experiment as JExperiment
from collaborative_gan_sampling_tpu.sampling.collab import (
    SampleResult as JSampleResult,
)
from tests.test_torch_conditional import (  # noqa: F401 (a fixture)
    one_torch_thread,
)
from tests.test_torch_models import to_numpy_tree
from tests.test_torch_pipeline import IMG

INTRA = ["model.compute_dtype=float32", "eval.fid_num_samples=96",
         "eval.fid_batch_size=16", "eval.intra_fid_classes=3",
         "eval.intra_fid_min_count=4"]
# imagenet64 at a tiny width: the DCGAN cut to 16x16 and 8 filters, the
# 1,000 classes and the procedural data's labels kept.
IN64 = ["model.image_size=16", "model.g_base_filters=8",
        "model.d_base_filters=8", "model.z_dim=16", "train.batch_size=16",
        "train.steps_per_call=2", "train.log_every=2", "refine.steps=2",
        "refine.num_batches=3", "refine.batch_size=16", "refine.burn_in=32",
        "refine.shape_every=1", "eval.fid_num_samples=48",
        "eval.fid_batch_size=16", "eval.feature_train_steps=2",
        "eval.intra_fid_classes=5", "eval.intra_fid_min_count=1"]


def test_intra_fid_matches_jax_experiment(tmp_path, monkeypatch):
    jexp = JExperiment(jconfig.apply_overrides(
        jconfig.get_preset("mnist"), IMG + INTRA).replace(
        workdir=str(tmp_path / "j")), echo_metrics=False)
    texp = Experiment(apply_overrides(get_preset("mnist"), IMG + INTRA)
                      .replace(workdir=str(tmp_path / "t")),
                      echo_metrics=False, device="cpu")
    jm = jfeat.SmallClassifier(num_classes=10)
    params = jm.init(jax.random.PRNGKey(2), jnp.zeros((1, 16, 16, 1)))
    tm = tfeat.SmallClassifier(1, 10)
    load_jax_params(tm, to_numpy_tree(params["params"]))
    tm.eval().requires_grad_(False)
    jexp._cached_feature_fn = lambda x: jm.apply(params, x,
                                                 return_features=True)
    texp._cached_feature_fn = lambda x: tm(x, return_features=True)
    jexp._feature_label = texp._feature_label = "carried"
    rng = np.random.default_rng(4)
    # A pool of 96 over 4 classes (class 3 rare), 80 accepted; real
    # images of the same classes, the rarest with 3 (< min_count).
    samples = rng.uniform(-1, 1, (96, 16, 16, 1)).astype(np.float32)
    labels = rng.choice(4, 96, p=[0.4, 0.3, 0.25, 0.05])
    accepted = np.ones(96, bool)
    accepted[rng.choice(96, 16, replace=False)] = False
    x_real = rng.uniform(-1, 1, (80, 16, 16, 1)).astype(np.float32)
    lab_real = np.concatenate([rng.choice(3, 77), [3, 3, 3]])
    calls = []

    def real_batch(xs, ls):
        def batch(key_or_gen, n):
            calls.append(n)
            return xs[:n], ls[:n]
        return batch

    monkeypatch.setattr(jexp.dataset, "batch",
                        real_batch(jnp.asarray(x_real), jnp.asarray(lab_real)))
    monkeypatch.setattr(texp.dataset, "batch",
                        real_batch(torch.from_numpy(x_real),
                                   torch.from_numpy(lab_real)))
    want = jexp.intra_fid(JSampleResult(
        jnp.asarray(samples), jnp.asarray(accepted), jnp.zeros(96),
        jnp.asarray(labels), {}))
    got = texp.intra_fid(SampleResult(
        torch.from_numpy(samples), torch.from_numpy(accepted),
        torch.zeros(96), torch.from_numpy(labels), {}))
    assert calls == [80, 80]  # each drew as many real images as accepted
    assert got["intra_fid_classes"] == want["intra_fid_classes"] == 3
    assert got["intra_fid"] == pytest.approx(want["intra_fid"], rel=1e-5)


@pytest.fixture(scope="module")
def in64(tmp_path_factory):
    cfg = apply_overrides(get_preset("imagenet64"), IN64)
    exp = Experiment(cfg.replace(workdir=str(
        tmp_path_factory.mktemp("in64"))), echo_metrics=False, device="cpu")
    return exp, exp.train(niters=2)


def test_imagenet64_experiment(in64, tmp_path):
    exp, state = in64
    assert exp.bundle.conditional and exp.dataset.num_classes == 1000
    assert state.step == 2
    res = exp.sample(state, method="collab")
    assert res.labels.shape == (48,) and res.labels.dtype == torch.int64
    assert bool(torch.isfinite(res.samples).all())
    out = exp.evaluate(res)
    assert {"fid", "intra_fid", "intra_fid_classes"} <= set(out)
    assert out["intra_fid_classes"] >= 0
    for method in ("standard", "reject", "refinement", "mhgan"):
        r = exp.sample(state, method=method)
        assert r.labels.shape == (48,) and int(r.labels.max()) < 1000
    fr = exp.fid_refine(state, steps=1)
    assert fr.labels.shape == (48,)
    out_path = str(tmp_path / "served.npz")
    x, labels, stats = exp.generate(state, 20, method="collab", class_id=3,
                                    out=out_path)
    assert x.shape == (20, 16, 16, 3) and labels.tolist() == [3] * 20
    with np.load(out_path) as npz:
        assert npz["labels"].tolist() == [3] * 20
        assert npz["samples"].shape == (20, 16, 16, 3)


def test_model_classes_must_cover_the_dataset(tmp_path):
    cfg = apply_overrides(get_preset("imagenet64"),
                          IN64 + ["model.num_classes=10"])
    with pytest.raises(ValueError, match="smaller than the dataset's 1000"):
        Experiment(cfg.replace(workdir=str(tmp_path)), device="cpu")


def test_cli_generate_class(in64, capsys):
    exp, _ = in64  # its workdir holds the trained checkpoint
    out = str(exp.workdir) + "/cli.npz"
    args = ["--config", "imagenet64", "--device", "cpu", "--workdir",
            exp.workdir, "train.niters=2", *IN64]
    assert cli.main(["generate", *args, "n=12", "class=3",
                     f"out={out}"]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["n"] == 12 and stats["out"] == out
    with np.load(out) as npz:
        assert npz["labels"].tolist() == [3] * 12
    with pytest.raises(KeyError, match="no field 'class'"):
        cli.main(["collab", *args, "class=3"])
