"""Checkpoints across the two packages: the port's msgpack codec
(``utils/msgpack.py``) against ``flax.serialization``, byte for byte both
ways; a checkpoint the JAX package writes restores in the port with the same
logits and the same next Adam step, and one the port writes restores in the
JAX package's ``TrainState``; the sidecar, its hash, pruning and the
optional EMA generator.

Exact where nothing is computed (bytes, restored arrays, the sidecar).
Logits after a restore: atol 1e-5 (tests/test_torch_models.py's forward
tolerance). The next Adam step from the same gradient: atol 3e-7 on params
and mu, 1e-9 on nu (one float32 update, in another order of operations,
of values up to ~1.3: two ulps).
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from collaborative_gan_sampling_torch import config as tconfig
from collaborative_gan_sampling_torch.training.gan import train_state_from
from collaborative_gan_sampling_torch.utils import msgpack
from collaborative_gan_sampling_torch.utils.checkpoint import (
    ConfigMismatchError,
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
    saved_config,
    state_dict,
)
from collaborative_gan_sampling_torch.utils.weights import (
    adam_to_optax,
    load_jax_params,
    load_optax_adam,
    params_to_flax,
    to_jax_variables,
)
from collaborative_gan_sampling_tpu import config as jconfig
from collaborative_gan_sampling_tpu.utils import checkpoint as jckpt
from tests.test_torch_models import TINY, assert_trees_close, make_pair
from tests.test_torch_train import BATCH, LR, MLP, jax_state, run_both


def _cfgs(model_kw, **train_kw):
    """The same Config in both packages."""
    kw = dict(batch_size=BATCH, d_lr=LR, g_lr=LR, beta1=0.5, **train_kw)
    return (jconfig.Config(model=jconfig.ModelConfig(**model_kw),
                           train=jconfig.TrainConfig(**kw)),
            tconfig.Config(model=tconfig.ModelConfig(**model_kw),
                           train=tconfig.TrainConfig(**kw)))


def _trained_pair(model_kw, **train_kw):
    """A JAX state and a port state after the same 2-iteration chunk."""
    j_state, _, t_state, _, _ = run_both(
        model_kw, dict(train_kw, steps_per_call=2))
    return j_state, t_state


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def assert_same_state(got, want):
    """Equal trees, bit for bit, None where the other has None."""
    if want is None or got is None:
        assert got is None and want is None
    elif isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            assert_same_state(got[k], want[k])
    else:
        assert np.asarray(got).dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# -- the codec ----------------------------------------------------------------

@pytest.mark.parametrize("ema", [False, True], ids=["no_ema", "ema"])
def test_codec_matches_flax_byte_for_byte(ema):
    j_state, _ = _trained_pair(TINY, g_ema_decay=0.999 if ema else 0.0)
    tree = serialization.to_state_dict(jax.device_get(j_state))
    blob = serialization.msgpack_serialize(tree)
    assert msgpack.packb(_np(tree)) == blob
    back = msgpack.unpackb(blob)
    want = serialization.msgpack_restore(blob)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # JAX writes the step as a 0-d int32 array, g_ema as nil when untracked.
    assert back["step"].shape == () and back["step"].dtype == np.int32
    assert (back["g_ema"] is None) == (not ema)
    assert back["g_opt"]["1"] == {}


def test_codec_scalars_both_ways():
    tree = {"nil": None, "t": True, "f": False, "ints": [0, 127, 128, 255,
                                                          256, 65536, 2 ** 40,
                                                          -1, -32, -33, -129,
                                                          -40000, -2 ** 40],
            "float": -1.25, "bin": b"\x00\x01", "long": "x" * 300,
            "npf": np.float32(2.5), "npi": np.int64(-3),
            "big": np.arange(70000, dtype=np.float32).reshape(7, 10000),
            "b16": np.zeros((2,), np.uint16), "many": {str(i): i
                                                      for i in range(20)}}
    blob = serialization.msgpack_serialize(tree)
    assert msgpack.packb(tree) == blob
    back = msgpack.unpackb(blob)
    want = serialization.msgpack_restore(blob)
    assert back.keys() == want.keys()
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert np.array_equal(back[k], want[k])
        else:
            assert back[k] == want[k] and type(back[k]) is type(want[k]), k


@pytest.mark.parametrize("blob,match", [
    (serialization.msgpack_serialize(
        {"a": np.zeros(2, np.float32)})[:-3], "truncated"),
    (b"\xc1", "not supported"),
    (b"\xd4\x02\x00", "ext type 2"),
    (serialization.msgpack_serialize(
        {"__msgpack_chunked_array__": True, "shape": {"0": 2}}), "chunked"),
    (b"\xc0\xc0", "trailing"),
])
def test_codec_rejects_what_flax_checkpoints_do_not_hold(blob, match):
    with pytest.raises(ValueError, match=match):
        msgpack.unpackb(blob)


# -- checkpoints across the packages ------------------------------------------

def _next_adam_step(j_state, t_state, seed=9):
    """One more Adam step of G from the same random gradient in both
    packages: (JAX params, mu, nu), (port's, in Flax layouts)."""
    rng = np.random.default_rng(seed)
    params = _np(j_state.g_vars["params"])
    grads = jax.tree.map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32), params)
    tx = optax.adam(LR, b1=0.5, b2=0.999, eps=1e-8)
    upd, opt = tx.update(jax.tree.map(jnp.asarray, grads), j_state.g_opt,
                         j_state.g_vars["params"])
    want = (_np(optax.apply_updates(j_state.g_vars["params"], upd)),
            _np(opt[0].mu), _np(opt[0].nu))
    grad_g = load_jax_params(copy.deepcopy(t_state.g), grads)
    for p, gp in zip(t_state.g.parameters(), grad_g.parameters()):
        p.grad = gp.detach().clone()
    t_state.g_opt.step()
    got_opt = adam_to_optax(t_state.g_opt, t_state.g)["0"]
    return want, (params_to_flax(t_state.g), got_opt["mu"], got_opt["nu"])


def _assert_same_model(j_state, t_state, jb, tb):
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (4, *jb.data_shape)).astype(np.float32)
    z = rng.standard_normal((4, jb.z_dim)).astype(np.float32)
    want_d = jb.discriminate(j_state.d_vars, jnp.asarray(x), train=False)
    want_g = jb.generate(j_state.g_vars, jnp.asarray(z), train=False)
    with torch.no_grad():
        got_d = tb.discriminate(t_state.d, torch.from_numpy(x), train=False)
        got_g = tb.generate(t_state.g, torch.from_numpy(z), train=False)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=1e-5)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), atol=1e-5)


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    jcfg, tcfg = _cfgs(TINY, g_ema_decay=0.999)
    j_state, _ = _trained_pair(TINY, g_ema_decay=0.999)
    path = jckpt.save_checkpoint(str(tmp_path), 2, j_state, config=jcfg)
    jb, tb, _, _, g, d = make_pair(TINY, seed=1)  # other weights
    t_state = restore_checkpoint(path, target=train_state_from(g, d,
                                                               tcfg.train),
                                 config=tcfg)
    assert t_state.step == 2
    assert_same_state(state_dict(t_state),
                      _np(serialization.to_state_dict(j_state)))
    _assert_same_model(j_state, t_state, jb, tb)
    (wp, wmu, wnu), (gp, gmu, gnu) = _next_adam_step(j_state, t_state)
    assert_trees_close(gp, wp, atol=3e-7)
    assert_trees_close(gmu, wmu, atol=3e-7)
    assert_trees_close(gnu, wnu, atol=1e-9)


def test_port_checkpoint_restores_in_jax(tmp_path):
    jcfg, tcfg = _cfgs(TINY, g_ema_decay=0.999)
    j_trained, t_state = _trained_pair(TINY, g_ema_decay=0.999)
    path = save_checkpoint(str(tmp_path), t_state.step, t_state,
                           config=tcfg)
    jb, _, g_vars, d_vars, _, _ = make_pair(TINY, seed=1)
    target = jax_state(g_vars, d_vars, jcfg.train)
    j_state = jckpt.restore_checkpoint(path, target=target, config=jcfg)
    assert int(j_state.step) == t_state.step == 2
    assert isinstance(j_state.g_opt[0], optax.ScaleByAdamState)
    assert_same_state(_np(serialization.to_state_dict(j_state)),
                      state_dict(t_state))
    # JAX's own restore of the port's file reads the same bytes back.
    with open(path, "rb") as fh:
        assert msgpack.packb(serialization.msgpack_restore(fh.read())) == \
            msgpack.packb(state_dict(t_state))
    (wp, wmu, wnu), (gp, gmu, gnu) = _next_adam_step(j_state, t_state)
    assert_trees_close(gp, wp, atol=3e-7)
    assert_trees_close(gmu, wmu, atol=3e-7)
    assert_trees_close(gnu, wnu, atol=1e-9)


def test_mlp_checkpoint_crosses_both_ways(tmp_path):
    jcfg, tcfg = _cfgs(MLP)
    j_state, t_state = _trained_pair(MLP)
    jb, tb, g_vars, d_vars, g, d = make_pair(MLP, seed=1)
    jpath = jckpt.save_checkpoint(str(tmp_path / "j"), 2, j_state,
                                  config=jcfg)
    restored = restore_checkpoint(jpath, target=train_state_from(
        g, d, tcfg.train), config=tcfg)
    _assert_same_model(j_state, restored, jb, tb)
    tpath = save_checkpoint(str(tmp_path / "t"), 2, t_state, config=tcfg)
    back = jckpt.restore_checkpoint(tpath, target=jax_state(
        g_vars, d_vars, jcfg.train), config=jcfg)
    assert_same_state(_np(serialization.to_state_dict(back)),
                      state_dict(t_state))


# -- the sidecar, pruning and the optional EMA generator ----------------------

@pytest.mark.parametrize("preset", ["toy2d", "mnist"])
def test_sidecar_is_the_same_in_both_packages(tmp_path, preset):
    jcfg, tcfg = jconfig.get_preset(preset), tconfig.get_preset(preset)
    _, t_state = _trained_pair(MLP)
    jckpt.save_checkpoint(str(tmp_path / "j"), 1, {"step": np.int32(1)},
                          config=jcfg)
    save_checkpoint(str(tmp_path / "t"), 1, t_state, config=tcfg)
    sides = [(tmp_path / d / "config.json").read_bytes() for d in "jt"]
    assert sides[0] == sides[1]
    assert saved_config(str(tmp_path / "t")) == jcfg.to_dict()
    assert tconfig.Config.from_dict(saved_config(str(tmp_path / "j"))) == tcfg


def test_config_mismatch_names_the_model_fields(tmp_path):
    _, tcfg = _cfgs(TINY)
    _, t_state = _trained_pair(TINY)
    path = save_checkpoint(str(tmp_path), 2, t_state, config=tcfg)
    other = tcfg.replace(model=tcfg.model.__class__(
        **dict(TINY, d_base_filters=16)))
    with pytest.raises(ConfigMismatchError, match="d_base_filters"):
        restore_checkpoint(path, target=t_state, config=other)
    # A train-section change restores.
    restore_checkpoint(path, target=t_state,
                       config=tcfg.replace(train=tcfg.train.__class__()))
    side = tmp_path / "config.json"
    data = json.loads(side.read_text())
    data["config"]["seed"] = 7
    side.write_text(json.dumps(data))
    with pytest.raises(ConfigMismatchError, match="edited by hand"):
        saved_config(str(tmp_path))


def test_pruning_and_latest(tmp_path):
    _, t_state = _trained_pair(MLP)
    assert latest_checkpoint(str(tmp_path / "none")) is None
    for step in (3, 10, 7, 12):
        save_checkpoint(str(tmp_path), step, t_state, keep=2)
    names = sorted(os.listdir(tmp_path))
    assert names == ["ckpt_00000010.msgpack", "ckpt_00000012.msgpack"]
    assert latest_checkpoint(str(tmp_path)).endswith("ckpt_00000012.msgpack")


def test_missing_ema_fills_only_an_untracked_target(tmp_path):
    _, tcfg = _cfgs(MLP)
    _, t_state = _trained_pair(MLP)
    tree = state_dict(t_state)
    del tree["g_ema"]  # a checkpoint from before the field existed
    path = save_checkpoint(str(tmp_path), 2, tree)
    restored = restore_checkpoint(path, target=t_state)
    assert restored.g_ema is None and restored.step == 2
    _, _, _, _, g, d = make_pair(MLP)
    tracked = train_state_from(g, d, tcfg.train.__class__(g_ema_decay=0.9))
    with pytest.raises(KeyError, match="g_ema"):
        restore_checkpoint(path, target=tracked)


def test_adam_state_round_trip_is_exact():
    _, t_state = _trained_pair(TINY)
    want = adam_to_optax(t_state.d_opt, t_state.d)
    _, _, _, _, _, d = make_pair(TINY, seed=2)
    opt = torch.optim.Adam(d.parameters())
    load_optax_adam(opt, d, want)
    load_jax_params(d, to_jax_variables(t_state.d)["params"])
    assert_same_state(adam_to_optax(opt, d), want)
    assert int(want["0"]["count"]) == 2


def test_unstepped_adam_state_is_optax_init():
    _, _, _, d_vars, _, d = make_pair(TINY)
    got = adam_to_optax(torch.optim.Adam(d.parameters()), d)
    want = optax.adam(LR).init(jax.tree.map(jnp.asarray, d_vars["params"]))
    assert_same_state(got, _np(serialization.to_state_dict(want)))
