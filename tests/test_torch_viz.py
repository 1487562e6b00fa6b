"""The port's figures (``viz/plots.py``), its TensorBoard mirror
(``utils/logging.py::MetricsWriter(tensorboard_dir=)``) and the
``Experiment`` paths that draw them (``train.viz_every``,
``train.tensorboard``, ``teaser``).

* ``_grid_fields`` against JAX's on weights carried across by
  ``utils/weights.py``: logits within 1e-5 and the field -dl/dx within
  1e-4 relative (plus 1e-6 absolute where it nearly vanishes): float32
  forward and backward of a small MLP, sums in another order, and the grid
  from another ``linspace``;
* the teaser's trajectories (``make_refine_fn(..., return_trajectory=True)``
  with the kernels off) against JAX's within 1e-5;
* the TensorBoard events against JAX's, both read with tensorboard's
  ``EventAccumulator`` (JAX writes TF2 tensor events, the port
  ``simple_value`` scalars): the same tags, steps and float32 values;
* the files that ``Experiment.train`` at ``viz_every`` and ``teaser``
  write.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collaborative_gan_sampling_torch.config import (
    RefineConfig as TRefineConfig,
    apply_overrides,
    get_preset,
)
from collaborative_gan_sampling_torch.pipeline import Experiment
from collaborative_gan_sampling_torch.sampling.refine import (
    make_refine_fn as t_make_refine_fn,
)
from collaborative_gan_sampling_torch.utils import logging as t_logging
from collaborative_gan_sampling_torch.viz import plots as t_plots
from collaborative_gan_sampling_tpu.config import RefineConfig
from collaborative_gan_sampling_tpu.sampling.refine import make_refine_fn
from collaborative_gan_sampling_tpu.utils import logging as j_logging
from collaborative_gan_sampling_tpu.viz import plots as j_plots
from tests.test_torch_mlp import SMALL
from tests.test_torch_models import make_pair
from tests.test_torch_pipeline import IMG, TOY

LOGIT_ATOL = 1e-5
FIELD_RTOL, FIELD_ATOL = 1e-4, 1e-6
TRAJ_ATOL = 1e-5


@pytest.fixture(scope="module")
def pair():
    return make_pair(SMALL, seed=50)


@pytest.mark.parametrize("lim,n", [(3.0, 40), (2.0, 9)])
def test_grid_fields_match_jax(pair, lim, n):
    jb, tb, _, d_vars, _, d = pair
    got = t_plots._grid_fields(tb, d, lim, n)
    want = j_plots._grid_fields(jb, d_vars, lim, n)
    for g, w in zip(got[:2], want[:2]):  # the grid
        np.testing.assert_allclose(g, w, atol=1e-6)
    np.testing.assert_allclose(got[2], want[2], atol=LOGIT_ATOL)
    np.testing.assert_allclose(got[3], want[3], rtol=FIELD_RTOL,
                               atol=FIELD_ATOL)
    assert got[2].shape == (n, n) and got[3].shape == (n, n, 2)


def test_teaser_trajectories_match_jax(pair):
    jb, tb, _, d_vars, _, d = pair
    kw = dict(steps=4, rate=0.1, use_pallas=False)
    x0 = (np.random.default_rng(51).standard_normal((32, 2)) * 1.5
          ).astype(np.float32)
    _, aux_w = make_refine_fn(jb, RefineConfig(**kw), return_trajectory=True)(
        d_vars, jnp.asarray(x0))
    x_k, aux = t_make_refine_fn(tb, TRefineConfig(**kw),
                                return_trajectory=True)(
        d, torch.from_numpy(x0))
    assert aux["traj"].shape == (5, 32, 2)
    np.testing.assert_allclose(aux["traj"].numpy(), np.asarray(aux_w["traj"]),
                               atol=TRAJ_ATOL)
    assert torch.equal(aux["traj"][-1], x_k)


def _events(logdir):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    acc = EventAccumulator(logdir)
    acc.Reload()
    return acc


def test_tensorboard_mirror_matches_jax(tmp_path, monkeypatch):
    """The same events through both writers, on one fixed clock (so that
    the ``t`` key agrees too)."""
    from tensorboard.util.tensor_util import make_ndarray

    monkeypatch.setattr(t_logging.time, "time", lambda: 1000.0)
    events = [(2, dict(phase="train", d_loss=0.6931, g_loss=1.25,
                       iters_per_s=410.5)),
              (4, dict(phase="train", d_loss=0.5, g_loss=np.float32(2.5),
                       iters_per_s=399.0, accept=3)),
              (6, dict(phase="eval", fid=12.75, shaped=True))]
    dirs = {}
    for name, mod in (("torch", t_logging), ("jax", j_logging)):
        dirs[name] = str(tmp_path / name)
        with mod.MetricsWriter(str(tmp_path / f"{name}.jsonl"), echo=False,
                               tensorboard_dir=dirs[name]) as w:
            for step, metrics in events:
                w.write(step, **metrics)
    t_acc, j_acc = _events(dirs["torch"]), _events(dirs["jax"])
    tags = sorted(t_acc.Tags()["scalars"])
    assert tags == sorted(j_acc.Tags()["tensors"])
    assert tags == ["accept", "d_loss", "fid", "g_loss", "iters_per_s",
                    "shaped", "t"]
    for tag in tags:
        got = [(e.step, np.float32(e.value)) for e in t_acc.Scalars(tag)]
        want = [(e.step, np.float32(make_ndarray(e.tensor_proto)))
                for e in j_acc.Tensors(tag)]
        assert got == want, tag


def test_writer_without_tensorboard_dir_needs_no_tensorboard(tmp_path):
    with t_logging.MetricsWriter(str(tmp_path / "m.jsonl"), echo=False) as w:
        w.write(1, loss=0.5)
        assert w._tb is None
    assert not [p for p in os.listdir(tmp_path) if p.startswith("events")]


def _exp(tmp_path, preset, extra):
    cfg = apply_overrides(get_preset(preset), TOY if preset == "toy2d"
                          else IMG)
    cfg = apply_overrides(cfg.replace(workdir=str(tmp_path / preset)),
                          list(extra))
    return Experiment(cfg, echo_metrics=False, device="cpu")


@pytest.mark.parametrize("preset,extra,names", [
    ("toy2d", (), ["viz_00000002.png", "viz_00000004.png"]),
    ("mnist", ("model.compute_dtype=float32",),
     ["samples_00000002.png", "samples_00000004.png"]),
], ids=["toy2d", "dcgan"])
def test_train_draws_at_viz_every_and_mirrors_to_tensorboard(
        tmp_path, preset, extra, names):
    exp = _exp(tmp_path, preset, ("train.viz_every=2",
                                  "train.tensorboard=true", *extra))
    assert exp.train(niters=4).step == 4
    files = sorted(os.listdir(exp.workdir))
    assert [f for f in files if f.endswith(".png")] == names
    for f in names:
        assert os.path.getsize(os.path.join(exp.workdir, f)) > 1000
    acc = _events(os.path.join(exp.workdir, "tb"))
    assert {"d_loss", "g_loss", "iters_per_s", "t"} <= set(
        acc.Tags()["scalars"])
    assert [e.step for e in acc.Scalars("d_loss")] == [2, 4]


def test_teaser_writes_its_three_files(tmp_path):
    exp = _exp(tmp_path, "toy2d", ("refine.steps=3",))
    state = exp.train(niters=2)
    out = exp.teaser(state, n_points=32)
    assert sorted(out) == ["gif", "overview", "trajectories"]
    assert [os.path.basename(p) for p in (out["trajectories"],
                                          out["overview"], out["gif"])] == [
        "teaser_trajectories.png", "overview.png", "teaser.gif"]
    for p in out.values():
        assert os.path.getsize(p) > 1000
    with open(out["gif"], "rb") as fh:
        assert fh.read(6) in (b"GIF87a", b"GIF89a")
    img = _exp(tmp_path, "mnist", ("model.compute_dtype=float32",))
    with pytest.raises(ValueError, match="2D-stack"):
        img.teaser(state=None)


def test_image_grid_pins_the_intensity_scale(tmp_path):
    """Tiles on the absolute scale, as JAX's save_image_grid: a bf16 batch
    draws as its float32 values do."""
    import matplotlib.image as mpimg

    x = torch.linspace(-1, 1, 4 * 8 * 8).reshape(4, 8, 8, 1)
    p32 = t_plots.save_image_grid(str(tmp_path / "a.png"), x, nrow=2)
    pj = j_plots.save_image_grid(str(tmp_path / "j.png"), x.numpy(), nrow=2)
    p16 = t_plots.save_image_grid(str(tmp_path / "b.png"),
                                  x.to(torch.bfloat16), nrow=2)
    np.testing.assert_array_equal(mpimg.imread(p32), mpimg.imread(pj))
    assert mpimg.imread(p16).shape == mpimg.imread(p32).shape == (16, 16, 4)
