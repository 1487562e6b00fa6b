"""``Config.to_json`` of the port against the JAX package's
(``collaborative_gan_sampling_tpu/config.py::Config.to_json``): the same
string, character for character, for every preset and for a preset with
overrides applied on both sides, and ``from_dict`` of that string gives the
config back."""

import json

import pytest

from collaborative_gan_sampling_torch.config import (
    Config,
    apply_overrides,
    get_preset,
    list_presets,
)
from collaborative_gan_sampling_tpu import config as jax_config

OVERRIDES = ["refine.steps=3", "train.niters=7"]
CASES = ([(name, []) for name in list_presets()]
         + [("mnist", OVERRIDES), ("toy2d", OVERRIDES)])


@pytest.mark.parametrize("preset,overrides", CASES,
                         ids=[f"{n}{'+overrides' if o else ''}"
                              for n, o in CASES])
def test_to_json_matches_jax(preset, overrides):
    cfg = apply_overrides(get_preset(preset), overrides)
    ref = jax_config.apply_overrides(jax_config.get_preset(preset), overrides)
    text = cfg.to_json()
    assert text == ref.to_json()
    assert Config.from_dict(json.loads(text)) == cfg
    if overrides:
        assert (cfg.refine.steps, cfg.train.niters) == (3, 7)


def test_preset_list_matches_jax():
    assert list_presets() == jax_config.list_presets()
