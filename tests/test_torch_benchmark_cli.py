"""The port's one-shot refinement, benchmark matrix, checkpoint inspection
and profiler trace against the JAX package's.

* ``refine_samples`` against JAX's ``refine_samples`` on the same weights
  and x0, float32, atol 1e-5 on x and logits (K steps of the same
  gradients, summed in another order): ``toy2d`` through the MLP kernel's
  plain version, ``mnist`` through the f32 conv kernel's, each reached by
  the port's own gate, and a trajectory by autograd.
* ``Experiment.benchmark``: the ``benchmark.jsonl`` lines of both packages
  on the same sampled pools have the same keys, methods and order, and
  metrics within 1e-6.
* ``cli inspect`` on a checkpoint the JAX package wrote returns the JAX
  CLI's dict, with no device asked for.
* ``Experiment.profile`` writes a Chrome trace holding both annotations.
"""

import dataclasses
import glob
import json
import os
import shutil
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collaborative_gan_sampling_torch import cli as t_cli
from collaborative_gan_sampling_torch import pipeline as t_pipeline
from collaborative_gan_sampling_torch.config import (
    RefineConfig as TRefineConfig,
    apply_overrides,
    get_preset,
)
from collaborative_gan_sampling_torch.sampling import refine as t_refine
from collaborative_gan_sampling_torch.sampling.collab import (
    SampleResult as TSampleResult,
)
from collaborative_gan_sampling_torch.utils.checkpoint import state_dict
from collaborative_gan_sampling_tpu import cli as j_cli
from collaborative_gan_sampling_tpu import config as j_config
from collaborative_gan_sampling_tpu import pipeline as j_pipeline
from collaborative_gan_sampling_tpu.config import RefineConfig
from collaborative_gan_sampling_tpu.sampling.collab import (
    SampleResult as JSampleResult,
)
from collaborative_gan_sampling_tpu.sampling.refine import refine_samples
from collaborative_gan_sampling_tpu.utils.checkpoint import save_checkpoint
from tests.test_torch_conditional import port_pair
from tests.test_torch_mlp import MID
from tests.test_torch_models import MNIST

ATOL = 1e-5
TINY = ["model.g_hidden=8", "model.d_hidden=8", "model.g_layers=2",
        "model.d_layers=2", "model.z_dim=2", "data.dataset=ring8",
        "train.batch_size=16", "train.steps_per_call=2", "train.niters=2",
        "refine.batch_size=32", "refine.num_batches=2", "refine.burn_in=32"]


def _spy(monkeypatch, name):
    """Count the calls of ``sampling/refine.py``'s kernel wrapper
    ``name``."""
    calls = []
    fn = getattr(t_refine, name)

    def spy(*a, **k):
        calls.append(name)
        return fn(*a, **k)

    monkeypatch.setattr(t_refine, name, spy)
    return calls


@pytest.mark.parametrize("case", ["toy2d_mlp", "mnist_conv",
                                  "toy2d_trajectory"])
def test_refine_samples_matches_jax(monkeypatch, case):
    model, wrapper = {"toy2d_mlp": (MID, "fused_refine_mlp"),
                      "mnist_conv": (MNIST, "fused_refine_conv28"),
                      "toy2d_trajectory": (MID, None)}[case]
    jb, tb, _, d_vars, _, d = port_pair(model, seed=5)
    rng = np.random.default_rng(6)
    x0 = (rng.standard_normal((64, 2)) * 2 if model is MID
          else rng.uniform(-1, 1, (4, 28, 28, 1))).astype(np.float32)
    kw = dict(steps=3, rate=0.1 if model is MID else 0.02)
    traj = wrapper is None
    x_want, aux = refine_samples(jb, d_vars, jnp.asarray(x0),
                                 RefineConfig(**kw), return_trajectory=traj)
    calls = _spy(monkeypatch, wrapper) if wrapper else []
    x_got, aux_t = t_refine.refine_samples(
        tb, d, torch.from_numpy(x0), TRefineConfig(**kw),
        return_trajectory=traj)
    assert calls == ([wrapper] if wrapper else [])
    np.testing.assert_allclose(x_got.numpy(), np.asarray(x_want), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(aux_t["logits"].numpy(),
                               np.asarray(aux["logits"]), atol=ATOL, rtol=0)
    if traj:
        assert aux_t["traj"].shape == (kw["steps"] + 1, *x0.shape)
        np.testing.assert_allclose(aux_t["traj"].numpy(),
                                   np.asarray(aux["traj"]), atol=ATOL,
                                   rtol=0)
    assert np.abs(x_got.numpy() - x0).max() > 1e-4  # the steps moved x


def _tiny(tmp_path, name):
    cfg = apply_overrides(get_preset("toy2d"), TINY)
    return cfg.replace(workdir=str(tmp_path / name))


def _pools(methods, n=64, seed=0):
    """One fixed pool a method: samples (n, 2), accept mask, logits."""
    rng = np.random.default_rng(seed)
    return {m: (rng.standard_normal((n, 2)).astype(np.float32) * 2,
                rng.uniform(size=n) < 0.3 + 0.1 * i,
                rng.standard_normal(n).astype(np.float32))
            for i, m in enumerate(methods)}


def test_benchmark_lines_match_jax(tmp_path):
    methods = t_pipeline.METHODS
    pools = _pools(methods)
    texp = t_pipeline.Experiment(_tiny(tmp_path, "torch"),
                                 echo_metrics=False, device="cpu")
    texp.sample = lambda state, method=None: TSampleResult(
        *(torch.from_numpy(np.asarray(a)) for a in pools[method]), None, {})
    jcfg = j_config.apply_overrides(j_config.get_preset("toy2d"), TINY)
    jexp = j_pipeline.Experiment(jcfg.replace(workdir=str(tmp_path / "jax")),
                                 echo_metrics=False)
    jexp.sample = lambda state, method=None: JSampleResult(
        *(jnp.asarray(a) for a in pools[method]), None, {})
    state = types.SimpleNamespace(step=7)
    tables = [texp.benchmark(state), jexp.benchmark(state)]
    rows = []
    for exp in (texp, jexp):
        with open(os.path.join(exp.workdir, "benchmark.jsonl")) as fh:
            rows.append([json.loads(line) for line in fh])
    assert [list(r) for r in rows[0]] == [list(r) for r in rows[1]]
    assert [r["method"] for r in rows[0]] == list(methods)
    for got, want in zip(*rows):
        assert got["step"] == want["step"] == 7
        assert got["phase"] == want["phase"] == "benchmark"
        for k in got:
            if k not in ("t", "phase", "method"):
                assert got[k] == pytest.approx(want[k], abs=1e-6), k
    assert list(tables[0]) == list(tables[1]) == list(methods)
    assert t_pipeline._NOT_PORTED == ("export", "teaser")


def test_inspect_matches_jax_on_a_jax_checkpoint(tmp_path, capsys):
    cfg = _tiny(tmp_path, "run")
    jcfg = j_config.apply_overrides(j_config.get_preset("toy2d"),
                                    TINY).replace(workdir=cfg.workdir)
    assert t_cli._inspect(cfg) == j_cli._inspect(jcfg)  # no checkpoint
    exp = t_pipeline.Experiment(cfg.replace(train=dataclasses.replace(
        cfg.train, g_ema_decay=0.9)), echo_metrics=False, device="cpu")
    state = exp.train(niters=2)
    # The JAX package writes the checkpoint and its config sidecar.
    shutil.rmtree(exp.ckpt_dir)
    save_checkpoint(exp.ckpt_dir, 2, state_dict(state),
                    config=jcfg.to_dict())
    for shaped in (False, True):
        if shaped:
            open(t_pipeline.shaped_d_path(cfg.workdir), "wb").close()
        got = t_cli._inspect(cfg)
        assert got == j_cli._inspect(jcfg)
        assert got["step"] == 2 and got["g_ema_tracked"]
        assert got["shaped_d_saved"] is shaped
        assert got["g_params"] == sum(p.numel()
                                      for p in state.g.parameters())
    # The CLI asks for no device: this host has no card.
    assert t_cli.main(["inspect", "--config", "toy2d", "--workdir",
                       cfg.workdir, *TINY]) == 0
    assert json.loads(capsys.readouterr().out) == got


def test_profile_trace_holds_both_annotations(tmp_path):
    exp = t_pipeline.Experiment(_tiny(tmp_path, "run"), echo_metrics=False,
                                device="cpu")
    state = exp.train(niters=2)
    logdir = exp.profile(state, chunks=2)
    assert logdir == os.path.join(exp.workdir, "trace")
    assert state.step == 2 + 3 * 2  # the warm chunk and the traced two
    (path,) = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    with open(path) as fh:
        names = [e.get("name") for e in json.load(fh)["traceEvents"]]
    assert names.count("train_chunk") == 2
    assert names.count("refinement") == 1
