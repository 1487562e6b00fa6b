"""The port's ``Experiment`` and CLI on the CPU at tiny widths: resume is
exact, the tail chunk stops at ``niters``, logs truncate on a fresh run,
``load_or_train`` resumes a run that is behind, ``generate("collab")``
persists and reuses the shaped D, and the CLI's ``train``, ``collab`` and
``generate`` run end to end; image sampling is scored by FID. Also the
config helpers against the JAX package's.

Resume is compared bit for bit: a checkpoint holds every float exactly and
each iteration's draws are keyed by (seed, index, role), so an interrupted
run continues as the uninterrupted one does.
"""

import json
import os

import numpy as np
import pytest
import torch

from collaborative_gan_sampling_torch import cli
from collaborative_gan_sampling_torch.config import (
    apply_overrides,
    get_preset,
)
from collaborative_gan_sampling_torch.pipeline import Experiment
from collaborative_gan_sampling_torch.sampling.export import load_sampler
from collaborative_gan_sampling_torch.training.gan import sampling_g
from collaborative_gan_sampling_torch.utils.checkpoint import state_dict
from collaborative_gan_sampling_tpu import config as jconfig
from tests.test_torch_checkpoint import assert_same_state

TOY = ["model.g_hidden=16", "model.d_hidden=16", "model.g_layers=2",
       "model.d_layers=2", "train.batch_size=16", "train.steps_per_call=2",
       "train.log_every=2", "train.ckpt_every=2", "refine.batch_size=32",
       "refine.num_batches=3", "refine.burn_in=64"]
IMG = ["model.image_size=16", "model.g_base_filters=8",
       "model.d_base_filters=8", "model.z_dim=8", "train.batch_size=8",
       "train.steps_per_call=2", "train.log_every=2", "train.ckpt_every=0",
       "refine.batch_size=8", "refine.num_batches=2", "refine.burn_in=8",
       "refine.shape_every=1"]


def _cfg(tmp_path, preset="toy2d", extra=(), name="run"):
    cfg = apply_overrides(get_preset(preset), TOY if preset == "toy2d"
                          else IMG)
    return apply_overrides(cfg.replace(workdir=str(tmp_path / name)),
                           list(extra))


def _exp(cfg):
    return Experiment(cfg, echo_metrics=False, device="cpu")


def _log_steps(cfg):
    with open(os.path.join(cfg.workdir, "train.jsonl")) as fh:
        return [json.loads(line)["step"] for line in fh]


@pytest.mark.parametrize("preset,extra", [
    ("toy2d", ()),
    ("toy2d", ("train.fused_prop=true", "train.g_ema_decay=0.9",
               "train.r1_gamma=1.0")),
    ("mnist", ("model.compute_dtype=float32",)),
], ids=["toy2d", "toy2d_options", "mnist_f32"])
def test_resume_is_exact(tmp_path, preset, extra):
    whole = _exp(_cfg(tmp_path, preset, extra, "whole")).train(niters=4)
    cfg = _cfg(tmp_path, preset, extra, "split")
    assert _exp(cfg).train(niters=2).step == 2  # and its final checkpoint
    resumed = _exp(cfg).train(niters=4)
    assert resumed.step == whole.step == 4
    assert_same_state(state_dict(resumed), state_dict(whole))
    assert _log_steps(cfg) == [2, 4]


def test_tail_chunk_stops_at_niters(tmp_path):
    cfg = _cfg(tmp_path, extra=("train.steps_per_call=3",))
    state = _exp(cfg).train(niters=7)
    assert state.step == 7
    assert _log_steps(cfg) == [3, 6, 7]
    assert sorted(os.listdir(os.path.join(cfg.workdir, "ckpts"))) == [
        "ckpt_00000003.msgpack", "ckpt_00000006.msgpack",
        "ckpt_00000007.msgpack", "config.json"]


def test_fresh_run_truncates_the_log(tmp_path):
    cfg = _cfg(tmp_path)
    _exp(cfg).train(niters=4)
    _exp(cfg).train(niters=2, resume=False)
    assert _log_steps(cfg) == [2]


def test_load_or_train_resumes_when_behind(tmp_path):
    cfg = _cfg(tmp_path)
    with pytest.raises(FileNotFoundError):
        _exp(cfg).load_state()
    _exp(cfg).train(niters=2)
    exp = _exp(apply_overrides(cfg, ["train.niters=4"]))
    assert exp.load_state().step == 2
    assert exp.load_or_train().step == 4
    assert exp.load_or_train().step == 4  # at target: restored as it is
    assert _log_steps(cfg) == [2, 4]


def test_generate_collab_persists_and_reuses_the_shaped_d(tmp_path):
    exp = _exp(_cfg(tmp_path, extra=("train.g_ema_decay=0.9",)))
    state = exp.train(niters=2)
    path = os.path.join(exp.workdir, "shaped_d.msgpack")
    assert not os.path.exists(path)
    out = str(tmp_path / "samples.npz")
    samples, labels, stats = exp.generate(state, 50, method="collab",
                                          out=out)
    assert samples.shape == (50, 2) and labels is None
    assert stats["out"] == out and np.load(out)["samples"].shape == (50, 2)
    assert os.path.exists(path)
    shaped = exp.load_shaped_d(template=state.d)
    moved = max(float((p - q).detach().abs().max()) for p, q in
                zip(shaped.parameters(), state.d.parameters()))
    assert moved > 0  # shaping changed D; the state's D is left as it was
    mtime = os.path.getmtime(path)
    again, _, _ = exp.generate(state, 50, method="collab",
                               generator=torch.Generator().manual_seed(1))
    assert os.path.getmtime(path) == mtime and again.shape == (50, 2)
    res = exp.sample(state, method="refinement", use_shaped_d=True)
    assert res.samples.shape == (3 * 32, 2)
    assert sampling_g(state) is state.g_ema


def test_image_experiment_samples_and_refuses_fid(tmp_path):
    """Image sampling is scored by FID; intra-FID of an unconditional
    model's pool, which has no labels, is refused with a clear error
    (tests/test_torch_conditional_pipeline.py scores labelled pools), and
    the collab serving round exports (the refinement by autograd, which no
    kernel serves at this width) and reloads."""
    exp = _exp(_cfg(tmp_path, "mnist", (
        "model.compute_dtype=float32", "eval.fid_num_samples=32",
        "eval.fid_batch_size=16", "eval.feature_train_steps=2")))
    state = exp.train(niters=2)
    res = exp.sample(state, method="collab")
    assert res.samples.shape == (16, 16, 16, 1)
    assert bool(torch.isfinite(res.samples).all())
    out = exp.evaluate(res)
    assert np.isfinite(out["fid"]) and out["fid"] > 0
    assert out["feature_net"] == "torch/trained_classifier"
    assert res.labels is None
    with pytest.raises(ValueError, match="intra_fid needs the pool's labels"):
        exp.intra_fid(res)
    meta = exp.export(state, str(tmp_path / "mnist.pt2"))
    assert meta["method"] == "collab" and meta["data_shape"] == [16, 16, 1]
    assert os.path.exists(os.path.join(exp.workdir, "shaped_d.msgpack"))
    fn, _ = load_sampler(str(tmp_path / "mnist.pt2"))
    x, labels, acc, logits = fn(0)
    assert x.shape == (16, 16, 16, 1) and labels is None
    assert bool(torch.isfinite(x).all() and torch.isfinite(logits).all())


def test_cli_train_collab_generate(tmp_path, capsys):
    work = str(tmp_path / "cli")
    args = ["--config", "toy2d", "--device", "cpu", "--workdir", work,
            "train.niters=4", *TOY]
    assert cli.main(["train", *args]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {
        "trained_steps": 4, "workdir": work}
    for extra in ([], ["--safe"]):
        assert cli.main(["collab", *args, *extra]) == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["method"] == "collab" and 0 <= out["pct_hq"] <= 1
        assert 0 < out["accept_rate"] <= 1
    assert cli.main(["generate", *args, "n=40", "--method",
                     "refinement"]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["accept_rate"] == 1.0
    assert cli.main(["presets"]) == 0
    assert "mnist" in json.loads(capsys.readouterr().out)
    with pytest.raises(KeyError, match="no field 'n'"):
        cli.main(["collab", *args, "n=40"])  # n= is generate's only


# -- the config helpers against the JAX package's ------------------------

OVERRIDES = ["train.niters=12", "refine.use_pallas=false", "--seed=3",
             "model.compute_dtype=float32", "refine.rate=0.5",
             "data.dataset=grid25"]


@pytest.mark.parametrize("preset", ["toy2d", "mnist", "celeba"])
def test_config_helpers_match_jax(preset):
    got = apply_overrides(get_preset(preset), OVERRIDES)
    want = jconfig.apply_overrides(jconfig.get_preset(preset), OVERRIDES)
    assert got.to_dict() == want.to_dict()
    assert type(got).from_dict(want.to_dict()) == got
    assert got.validate() is got


def test_config_validation_and_override_errors():
    cfg = get_preset("toy2d")
    with pytest.raises(ValueError, match="steps_per_call"):
        apply_overrides(cfg, ["train.steps_per_call=0"]).validate()
    with pytest.raises(KeyError, match="no field 'nope'"):
        apply_overrides(cfg, ["train.nope=1"])
    with pytest.raises(ValueError, match="key=value"):
        apply_overrides(cfg, ["train.niters"])
    with pytest.raises(ValueError, match="bool"):
        apply_overrides(cfg, ["refine.use_pallas=maybe"])
