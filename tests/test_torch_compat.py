"""The port's reference-flag scripts (``compat/_shared.py``,
``compat/main_*.py``) against the JAX package's: each script's defaults and
flags give the same config dict, every reference mode maps to the same
method, and ``main_synthetic --mode benchmark --device cpu`` runs end to
end."""

import dataclasses
import json

import numpy as np
import pytest

from collaborative_gan_sampling_torch.compat import _shared
from collaborative_gan_sampling_torch.compat import (
    main_celeba,
    main_mnist,
    main_synthetic,
)
from collaborative_gan_sampling_tpu.compat import _shared as j_shared
from collaborative_gan_sampling_tpu.compat import main_celeba as j_celeba
from collaborative_gan_sampling_tpu.compat import main_mnist as j_mnist
from collaborative_gan_sampling_tpu.compat import (
    main_synthetic as j_synthetic,
)

SCRIPTS = [(main_synthetic, j_synthetic), (main_mnist, j_mnist),
           (main_celeba, j_celeba)]
FLAGS = ["--mode", "collab", "--niters", "100", "--batch_size", "64",
         "--z_dim", "16", "--lr", "0.0005", "--beta1", "0.3",
         "--rollout_steps", "25", "--rollout_rate", "0.07",
         "--rejection_gamma", "0.5", "--shaping_interval", "2",
         "--checkpoint_dir", "/tmp/x", "--seed", "3"]


def _captured(module, monkeypatch):
    """(preset, argv, defaults) that ``module.main`` hands to ``run``."""
    seen = {}
    monkeypatch.setattr(module, "run", lambda preset, argv, defaults:
                        seen.update(preset=preset, argv=argv,
                                    defaults=defaults) or 0)
    module.main(["--mode", "train"])
    return seen["preset"], seen["defaults"]


@pytest.mark.parametrize("argv", [[], FLAGS], ids=["defaults", "flags"])
@pytest.mark.parametrize("port,jax", SCRIPTS,
                         ids=["synthetic", "mnist", "celeba"])
def test_to_config_matches_jax(monkeypatch, port, jax, argv):
    preset, defaults = _captured(port, monkeypatch)
    assert (preset, defaults) == _captured(jax, monkeypatch)
    t_args = _shared.build_parser(defaults).parse_args(argv)
    j_args = j_shared.build_parser(defaults).parse_args(argv)
    assert t_args.device is None  # the one flag beyond the reference's
    assert {k: v for k, v in vars(t_args).items() if k != "device"} == \
        vars(j_args)
    assert dataclasses.asdict(_shared.to_config(preset, t_args)) == \
        dataclasses.asdict(j_shared.to_config(preset, j_args))


def test_every_reference_mode_maps_as_jax():
    assert _shared.MODE_TO_METHOD == j_shared.MODE_TO_METHOD
    for mode in ["standard", "rejection", "hastings", "refinement",
                 "collab"]:
        assert _shared.MODE_TO_METHOD[mode] in (
            "standard", "reject", "mhgan", "refinement", "collab")


def test_unknown_mode_exits():
    with pytest.raises(SystemExit, match="unknown --mode"):
        main_synthetic.main(["--mode", "gibbs", "--device", "cpu"])


def test_main_synthetic_end_to_end(tmp_path, capsys):
    common = ["--niters", "4", "--batch_size", "64", "--rollout_steps", "3",
              "--checkpoint_dir", str(tmp_path), "--device", "cpu"]
    assert main_synthetic.main(["--mode", "train", *common]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out == {"trained_steps": 4}
    assert main_synthetic.main(["--mode", "benchmark", *common]) == 0
    table = json.loads(capsys.readouterr().out)
    assert sorted(table) == sorted(["standard", "reject", "mhgan",
                                    "refinement", "collab"])
    assert all(np.isfinite(row["pct_hq"]) for row in table.values())
    assert main_synthetic.main(["--mode", "rejection", *common]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["mode"] == "rejection" and 0 < row["accept_rate"] <= 1
