"""The port's per-checkpoint tuning against the JAX package's: the grid
helpers (``_grid_edges``, ``_extend_axis``), ``Experiment.select_hparams``
(cell order, best cell, boundary warning, geometric extension), its JSONL
cell cache read across the two packages, ``utils/retry.py`` and the output
of ``cli tune``.

Both packages' ``select_hparams`` run on a tiny ``toy2d`` Experiment whose
``sample`` and ``evaluate`` are replaced by one deterministic metric surface
with a known optimum: the control flow under test, no sampling. Everything
must be equal: cells, order, metrics, best, printed lines.
"""

import json
import math
import re

import pytest
import torch

from collaborative_gan_sampling_torch import cli as t_cli
from collaborative_gan_sampling_torch import pipeline as t_pipeline
from collaborative_gan_sampling_torch.config import (
    apply_overrides,
    get_preset,
)
from collaborative_gan_sampling_torch.utils import retry as t_retry
from collaborative_gan_sampling_tpu import cli as j_cli
from collaborative_gan_sampling_tpu import config as j_config
from collaborative_gan_sampling_tpu import pipeline as j_pipeline

TINY = ["model.g_hidden=8", "model.d_hidden=8", "model.g_layers=2",
        "model.d_layers=2", "model.z_dim=2", "data.dataset=ring8",
        "train.niters=0", "train.batch_size=32"]

# tests/test_hparam_grid.py's cases.
KS, RATES = [1, 5, 10, 20], [0.001, 0.01, 0.1]
EDGE_CASES = [
    ((5, 0.01), KS, RATES), ((20, 0.01), KS, RATES),
    ((5, 0.001), KS, RATES), ((20, 0.1), KS, RATES),
    ((1, 0.01), KS, RATES), ((2, 0.01), [2, 5, 10], RATES),
    ((5, 0.01), [5], RATES), ((5, 0.01), KS, [0.01]),
]
EXTEND_CASES = [
    ([2, 5, 10, 20], "low", True), ([10, 20, 50], "high", True),
    ([1, 2, 5], "low", True), ([0.001, 0.005, 0.01], "low", False),
    ([0.01, 0.03], "high", False), ([0.01], "low", False),
]


@pytest.mark.parametrize("best,ks,rates", EDGE_CASES)
def test_grid_edges_match_jax(best, ks, rates):
    assert (t_pipeline._grid_edges(best, ks, rates)
            == j_pipeline._grid_edges(best, ks, rates))


@pytest.mark.parametrize("vals,side,integer", EXTEND_CASES)
def test_extend_axis_matches_jax(vals, side, integer):
    got = t_pipeline._extend_axis(list(vals), side, integer)
    assert got == j_pipeline._extend_axis(list(vals), side, integer)
    assert type(got) is type(j_pipeline._extend_axis(vals, side, integer))


def surface(k_opt, rate_opt):
    """A metric of the refine config with its optimum at (k_opt, rate_opt),
    objective kl, space x, stop 0.5 and prox 0."""
    def evaluate(rcfg):
        kl = (math.log(rcfg.steps / k_opt) ** 2
              + math.log(rcfg.rate / rate_opt) ** 2
              + {"ns": 0.3, "kl": 0.0, "saturating": 0.7}[rcfg.objective]
              + (0.0 if rcfg.space == "x" else 0.2)
              + abs(rcfg.stop_score - 0.5) + rcfg.proximal)
        return {"kl": kl, "steps": rcfg.steps}
    return evaluate


def port_exp(tmp_path, k_opt, rate_opt):
    cfg = apply_overrides(get_preset("toy2d"), TINY).replace(
        workdir=str(tmp_path / "torch"))
    exp = t_pipeline.Experiment(cfg, echo_metrics=False, device="cpu")
    exp.sample = lambda state, method=None, refine_cfg=None: refine_cfg
    exp.evaluate = surface(k_opt, rate_opt)
    return exp


def jax_exp(tmp_path, k_opt, rate_opt):
    cfg = j_config.apply_overrides(j_config.get_preset("toy2d"), TINY)
    exp = j_pipeline.Experiment(cfg.replace(workdir=str(tmp_path / "jax")),
                                echo_metrics=False)
    exp.sample = lambda state, method=None, refine_cfg=None: refine_cfg
    exp.evaluate = surface(k_opt, rate_opt)
    return exp


SCENARIOS = {
    # The lowest corner, no extension: the warning.
    "boundary": (0.5, 1e-5, dict(ks=[2, 5, 10], rates=[0.001, 0.01, 0.1])),
    # One axis extends high, the other low, until the best is interior.
    "extend": (20.0, 2e-4, dict(ks=[2, 5, 10], rates=[0.001, 0.01, 0.1],
                                extend_grid=4)),
    # Extension stops at K's floor of 1.
    "k_floor": (0.1, 0.01, dict(ks=[2, 5, 10], rates=[0.001, 0.01, 0.1],
                                extend_grid=10)),
    # Every optional axis, with progress lines.
    "all_axes": (5.0, 0.01, dict(
        ks=[1, 5, 10], rates=[0.005, 0.01, 0.02],
        objectives=["ns", "kl", "saturating"], spaces=["x", "z"],
        stops=[0.0, 0.5], proxs=[0.0, 0.1], progress=True)),
    # The default K and rate grids.
    "defaults": (5.0, 0.1, dict()),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_select_hparams_matches_jax(tmp_path, capsys, name):
    k_opt, rate_opt, kw = SCENARIOS[name]
    runs = []
    for make in (port_exp, jax_exp):
        best, table = make(tmp_path, k_opt, rate_opt).select_hparams(
            None, **{k: list(v) if isinstance(v, list) else v
                     for k, v in kw.items()})
        # Cells' seconds differ between the two runs.
        lines = [re.sub(r" \(\d+s\)$", "", line) for line in
                 capsys.readouterr().out.splitlines()]
        runs.append((best, list(table.items()), lines))
    assert runs[0] == runs[1]
    best, table, lines = runs[0]
    if name == "boundary":
        assert best == (2, 0.001) and len(table) == 9
        assert "k:low/rate:low" in lines[-1] and "WARNING" in lines[-1]
    if name == "extend":
        ks = sorted({c[0] for c, _ in table})
        rates = sorted({c[1] for c, _ in table})
        assert t_pipeline._grid_edges(best, ks, rates) == []
        assert max(ks) > 10 and min(rates) < 0.001
    if name == "k_floor":
        assert best[0] == 1
    if name == "all_axes":
        assert best == (5, 0.01, "kl", "x", 0.5, 0.0)
        assert len(table) == 3 * 3 * 3 * 2 * 2 * 2


def test_cache_crosses_packages_and_skips_torn_lines(tmp_path, capsys):
    """A cache the port wrote serves JAX's grid and the other way round;
    a torn line is skipped; only new cells are computed and appended."""
    cache = str(tmp_path / "grid.jsonl")
    grid = dict(ks=[2, 5, 10], rates=[0.001, 0.01, 0.1], cache_path=cache)
    best, table = port_exp(tmp_path, 5.0, 0.01).select_hparams(None, **grid)
    with open(cache, "a") as fh:
        fh.write('{"cell": [10, 0.0\n')  # a torn line

    def poisoned(*a, **k):
        raise AssertionError("a cached cell was computed again")

    jexp = jax_exp(tmp_path, 5.0, 0.01)
    jexp.sample = poisoned
    assert jexp.select_hparams(None, **grid) == (best, table)
    # JAX computes one more K and appends it; the port reads both.
    jexp = jax_exp(tmp_path, 5.0, 0.01)
    _, jtable = jexp.select_hparams(None, ks=[2, 5, 10, 20],
                                    rates=grid["rates"], cache_path=cache)
    texp = port_exp(tmp_path, 5.0, 0.01)
    texp.sample = poisoned
    assert texp.select_hparams(None, ks=[2, 5, 10, 20], rates=grid["rates"],
                               cache_path=cache) == (best, jtable)
    with open(cache) as fh:
        lines = fh.readlines()
    assert len(lines) == 9 + 1 + 3  # the port's, the torn one, JAX's
    capsys.readouterr()


# -- retries ----------------------------------------------------------------


class DistNetworkError(RuntimeError):
    """Stand-in matched by name, as the filter matches."""


def test_with_retries_recovers_after_transient_errors():
    sleeps, calls = [], {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise DistNetworkError("Connection reset by peer")
        return "ok"

    assert t_retry.with_retries(flaky, retries=3, backoff_s=7.0,
                                _sleep=sleeps.append) == "ok"
    assert calls["n"] == 3 and sleeps == [7.0, 14.0]  # linear backoff


def test_with_retries_gives_up_after_budget():
    def always_down():
        raise DistNetworkError("Socket closed")

    with pytest.raises(DistNetworkError):
        t_retry.with_retries(always_down, retries=2, _sleep=lambda _: None)


def test_with_retries_propagates_non_transient_immediately():
    calls = {"n": 0}

    def broken():
        calls["n"] += 1
        raise ValueError("Connection reset on the wrong type")

    with pytest.raises(ValueError):
        t_retry.with_retries(broken, retries=5, _sleep=lambda _: None)
    assert calls["n"] == 1


def test_transient_filter_requires_marker_and_type():
    tr = t_retry.is_transient_backend_error
    assert tr(torch.distributed.DistNetworkError(
        "Connection reset by peer"))
    assert tr(torch.distributed.DistStoreError(
        "DEADLINE_EXCEEDED waiting for key"))
    assert not tr(torch.distributed.DistStoreError("key not found"))
    # A CUDA error is never transient, whatever its message.
    assert not tr(RuntimeError("CUDA error: an illegal memory access was "
                               "encountered (UNAVAILABLE)"))
    assert not tr(ValueError("Socket closed"))


def test_select_hparams_retries_transient_cell(tmp_path, capsys):
    exp = port_exp(tmp_path, 5.0, 0.01)
    fails = {"left": 1}
    real = exp.sample

    def flaky_sample(*a, **k):
        if fails["left"]:
            fails["left"] -= 1
            raise DistNetworkError("Connection reset by peer")
        return real(*a, **k)

    exp.sample = flaky_sample
    sleeps = []
    t_retry_sleep = t_retry.time.sleep
    try:
        t_retry.time.sleep = sleeps.append
        best, table = exp.select_hparams(None, ks=[5], rates=[0.01])
    finally:
        t_retry.time.sleep = t_retry_sleep
    assert best == (5, 0.01) and len(table) == 1 and sleeps == [30.0]
    assert "[retry]" in capsys.readouterr().out


# -- cli tune -----------------------------------------------------------------


@pytest.mark.parametrize("extra", [
    [],
    ["tune_objectives=ns,kl", "tune_spaces=x,z", "tune_stops=0,0.5",
     "tune_proxs=0,0.1"],
], ids=["k_rate", "all_axes"])
def test_cli_tune_output_matches_jax(tmp_path, capsys, monkeypatch, extra):
    for cls in (t_pipeline.Experiment, j_pipeline.Experiment):
        monkeypatch.setattr(cls, "load_or_train", lambda self: None)
        monkeypatch.setattr(cls, "sample", lambda self, state, method=None,
                            refine_cfg=None: refine_cfg)
        monkeypatch.setattr(cls, "evaluate",
                            lambda self, rcfg: surface(5.0, 0.01)(rcfg))
    argv = ["tune", "--config", "toy2d", "--workdir", str(tmp_path), *TINY,
            "sweep_steps=1,5,10", "tune_rates=0.005,0.01,0.02", *extra]
    outs = []
    for main, dev in ((t_cli.main, ["--device", "cpu"]), (j_cli.main, [])):
        assert main(argv + dev) == 0
        outs.append(capsys.readouterr().out.strip().splitlines()[-1])
    assert outs[0] == outs[1]
    out = json.loads(outs[0])
    assert out["best_k"] == 5 and out["best_rate"] == 0.01
    if extra:
        assert next(iter(out["grid"])) == "k=1,rate=0.005,obj=ns,space=x," \
                                          "stop=0.0,prox=0.0"
        assert out["best_objective"] == "kl" and out["best_proximal"] == 0.0
    else:
        assert next(iter(out["grid"])) == "k=1,rate=0.005"
