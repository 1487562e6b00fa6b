"""Evaluation through the port's ``Experiment`` and CLI on a tiny mnist
config on the CPU: ``evaluate`` (FID, KID, precision/recall), the real
stats' npz cache and its label and width checks, ``adopt_eval_caches``,
``fid_refine``, ``sweep`` / ``select_k``, and ``cli eval`` / ``collab`` /
``sweep``. FID is held to the JAX Experiment's ``fid_of_samples`` on the
same samples, the same real stats and the same feature net (the JAX
classifier's weights carried into the port), at rtol 1e-5 (the float64
host distance of float32 moments that differ by summation order).
"""

import json
import os

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
from collaborative_gan_sampling_torch.evals.fid import FIDStats
from collaborative_gan_sampling_torch.pipeline import Experiment
from collaborative_gan_sampling_torch.sampling.collab import SampleResult
from collaborative_gan_sampling_torch.utils.weights import load_jax_params
from collaborative_gan_sampling_tpu import config as jconfig
from collaborative_gan_sampling_tpu.evals import features as jfeat
from collaborative_gan_sampling_tpu.evals import fid as jfid
from collaborative_gan_sampling_tpu.pipeline import Experiment as JExperiment
from tests.test_torch_models import to_numpy_tree
from tests.test_torch_pipeline import IMG

EVAL = ["model.compute_dtype=float32", "eval.fid_num_samples=64",
        "eval.fid_batch_size=16", "eval.feature_train_steps=4",
        "eval.prd_samples=32", "eval.kid_subsets=3",
        "eval.kid_subset_size=8"]


def _cfg(tmp_path, extra=(), name="run"):
    cfg = apply_overrides(get_preset("mnist"), IMG + EVAL)
    return apply_overrides(cfg.replace(workdir=str(tmp_path / name)),
                           list(extra))


def _exp(cfg):
    return Experiment(cfg, echo_metrics=False, device="cpu")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    exp = _exp(_cfg(tmp_path_factory.mktemp("eval")))
    return exp, exp.train(niters=2)


def test_evaluate_images(trained):
    exp, state = trained
    res = exp.sample(state, method="collab")
    out = exp.evaluate(res)
    assert set(out) == {"fid", "accept_rate", "feature_net", "precision",
                        "recall", "kid", "kid_std"}
    assert out["feature_net"] == "torch/trained_classifier"
    assert np.isfinite(out["fid"]) and out["fid"] > 0
    assert 0 <= out["precision"] <= 1 and 0 <= out["recall"] <= 1
    assert np.isfinite(out["kid"]) and out["kid_std"] >= 0
    assert out["accept_rate"] == res.accept_rate
    # An empty pool: FID inf, KID inf, precision/recall 0.
    none = res._replace(accepted=torch.zeros_like(res.accepted))
    assert exp.fid_of_samples(none.samples, none.accepted) == float("inf")
    assert exp.kid(none) == {"kid": float("inf"), "kid_std": 0.0}
    assert exp.precision_recall(none) == {"precision": 0.0, "recall": 0.0}
    # Intra-FID of the pool with labels given: no class reaches the
    # preset's 32 samples on both sides, so none is scored (inf, 0), as
    # the JAX package's per_class_fid; an empty pool is inf likewise.
    labelled = res._replace(labels=torch.zeros_like(res.accepted,
                                                    dtype=torch.int64))
    assert exp.intra_fid(labelled) == {"intra_fid": float("inf"),
                                       "intra_fid_classes": 0}
    assert exp.intra_fid(none._replace(labels=labelled.labels)) == {
        "intra_fid": float("inf"), "intra_fid_classes": 0.0}


def test_fid_matches_jax_experiment(tmp_path):
    """The same samples, real stats and classifier weights in both
    Experiments give the same FID."""
    jcfg = jconfig.apply_overrides(jconfig.get_preset("mnist"), IMG + EVAL)
    jexp = JExperiment(jcfg.replace(workdir=str(tmp_path / "j")),
                       echo_metrics=False)
    texp = _exp(_cfg(tmp_path, name="t"))
    jm = jfeat.SmallClassifier(num_classes=10)
    params = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 16, 16, 1)))
    tm = tfeat.SmallClassifier(1, 10)
    load_jax_params(tm, to_numpy_tree(params["params"]))
    tm.eval().requires_grad_(False)
    jexp._cached_feature_fn = lambda x: jm.apply(params, x,
                                                 return_features=True)
    texp._cached_feature_fn = lambda x: tm(x, return_features=True)
    jexp._feature_label = texp._feature_label = "carried"
    real = jexp.real_stats()
    texp._real_stats = FIDStats(*(torch.from_numpy(np.array(t))
                                  for t in real))
    rng = np.random.default_rng(3)
    samples = rng.uniform(-1, 1, (40, 16, 16, 1)).astype(np.float32)
    accepted = rng.uniform(size=40) < 0.7
    want = jexp.fid_of_samples(jnp.asarray(samples), jnp.asarray(accepted))
    got = texp.fid_of_samples(torch.from_numpy(samples),
                              torch.from_numpy(accepted))
    assert got == pytest.approx(want, rel=1e-5)


def test_real_stats_cache_and_checks(trained, tmp_path, monkeypatch):
    exp, _ = trained
    path = str(tmp_path / "real.npz")
    cfg = apply_overrides(exp.cfg, [f"eval.real_stats_path={path}"])
    first = _exp(cfg)
    first.adopt_eval_caches(exp, include_real_stats=False)
    stats = first.real_stats()
    assert os.path.exists(path) and stats.mu.shape == (256,)
    assert first.real_stats() is stats  # cached in the process
    # A new process reads the file instead of streaming the real data.
    second = _exp(cfg)
    second.adopt_eval_caches(exp, include_real_stats=False)
    from collaborative_gan_sampling_torch import pipeline
    monkeypatch.setattr(pipeline, "streaming_stats", None)
    for got, want in zip(second.real_stats(), stats):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    # A file of another feature net, or of another width, is refused.
    third = _exp(cfg)
    third._cached_feature_fn = exp._feature_fn()
    third._feature_label = "trained_classifier"  # the JAX package's label
    with pytest.raises(ValueError, match="computed under feature net"):
        third.real_stats()
    jfid.save_stats(path, jfid.FIDStats(jnp.zeros(8), jnp.eye(8),
                                        jnp.float32(9)),
                    feature_net="torch/trained_classifier")
    with pytest.raises(ValueError, match="8-dim but the feature net emits"):
        second.__dict__.pop("_real_stats", None)
        second.real_stats()


def test_adopt_eval_caches_protocols(trained, tmp_path):
    exp, _ = trained
    exp.real_stats()
    same = _exp(_cfg(tmp_path, name="same"))
    same.adopt_eval_caches(exp)
    assert same._real_stats is exp._real_stats
    assert same._feature_fn() is exp._feature_fn()
    other = _exp(_cfg(tmp_path, ["eval.fid_num_samples=32"], "other"))
    other.adopt_eval_caches(exp)
    assert not hasattr(other, "_real_stats")
    with pytest.raises(ValueError, match="different eval protocols"):
        other.adopt_eval_caches(exp, include_real_stats=True)


def test_fid_refine_and_sweep(trained):
    exp, state = trained
    res = exp.fid_refine(state, steps=3)
    assert isinstance(res, SampleResult)
    assert res.samples.shape == (16, 16, 16, 1) and res.accept_rate == 1.0
    assert bool(torch.isfinite(res.samples).all())
    assert float(res.aux["batch_fid_end"]) < float(
        res.aux["batch_fid_start"])
    best, table = exp.select_k(state, [1, 2])
    assert best in (1, 2) and set(table) == {1, 2}
    assert all(np.isfinite(row["fid"]) for row in table.values())


def test_cli_eval_collab_sweep(tmp_path, capsys):
    work = str(tmp_path / "cli")
    args = ["--config", "mnist", "--device", "cpu", "--workdir", work,
            "train.niters=2", *IMG, *EVAL]
    assert cli.main(["train", *args]) == 0
    capsys.readouterr()
    for cmd in ("eval", "collab"):
        assert cli.main([cmd, *args]) == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["method"] == ("collab" if cmd == "collab"
                                 else get_preset("mnist").refine.method)
        assert np.isfinite(out["fid"]) and 0 <= out["recall"] <= 1
        assert out["feature_net"] == "torch/trained_classifier"
    assert cli.main(["sweep", *args, "sweep_steps=1,3"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["best_k"] in (1, 3) and set(out["sweep"]) == {"1", "3"}
    with pytest.raises(KeyError, match="no field 'sweep_steps'"):
        cli.main(["eval", *args, "sweep_steps=1"])
