"""Parity of the port's train chunk (``training/gan.py``) with the JAX
package's ``make_train_chunk``: the same weights, the same draws (the JAX
chunk's own, fed through the ``TrainDraws`` seam) and the same config, then
params, BatchNorm statistics, Adam's mu and nu and count, the step, the EMA
generator and the metrics compared after one chunk of 1 to 3 iterations.

float32 tolerances (CPU):

* params and EMA params: at least 99% of the entries within 1e-7 (float32
  rounding of values of order 0.1 to 1), all within 5% of one step of lr.
  Adam divides each gradient entry by its own magnitude plus eps = 1e-8,
  so an entry whose gradient lies near eps takes a step that depends on
  the gradient's last digits, where the two frameworks differ (measured:
  2.6e-6 at most);
* mu and nu: each array within 5e-4 of its largest entry (the gradients
  agree to ~1e-5 of their scale at the first iteration and drift apart
  with the params; measured 1.4e-4 at most, over 3 iterations);
* BN statistics and the metrics: atol 1e-5, as the forward passes.

One exception, as in tests/test_torch_shaping.py: the bias of a layer that
feeds a train-mode BatchNorm (D's ``conv{i}`` before ``bn{i}``, G's
``project`` and ``deconv{i}`` before ``bn_project`` / ``bn{i}``) has a
gradient of exactly zero, so each framework computes rounding noise there,
which Adam turns into steps of either sign. Those biases are held to Adam's
bound, lr * (1 - b1) / sqrt(1 - b2) per step (Kingma & Ba, section 2.1),
over the chunk, and the running mean of the BatchNorm they feed to the
share of that shift its train-mode passes take ((1 - momentum) = 0.1 each)
on top of the statistics' tolerance.

bfloat16 (the mnist preset's compute dtype, params in float32): the two
frameworks round bf16 products and sums at other points, so the gradients
agree only to bf16's precision, and a param whose gradient is near zero may
take Adam's step in the other direction. The yardstick is bf16's own
effect: the same chunk run by JAX in float32. Params, mu and nu: the mean
|port - JAX bf16| of each tree at most 3 times the mean |JAX f32 - JAX
bf16| (measured: 0.6 to 2 times), every param within Adam's bound; BN
statistics and the metrics atol 5e-3 (a bf16 ulp at 1 is 7.8e-3; measured
4e-4 at most).
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collaborative_gan_sampling_torch.config import TrainConfig as TTrainConfig
from collaborative_gan_sampling_torch.training.gan import (
    TrainDraws,
    make_train_chunk,
    sampling_g,
    train_state_from,
)
from collaborative_gan_sampling_torch.utils.prng import step_seed
from collaborative_gan_sampling_torch.utils.weights import (
    adam_to_optax,
    params_to_flax,
    to_jax_variables,
)
from collaborative_gan_sampling_tpu.config import TrainConfig as JTrainConfig
from collaborative_gan_sampling_tpu.training.gan import (
    TrainState as JTrainState,
    make_optimizers as j_make_optimizers,
    make_train_chunk as j_make_train_chunk,
)
from collaborative_gan_sampling_tpu.utils.prng import step_key
from tests.test_torch_models import TINY, make_pair, to_numpy_tree

LR = 2e-4
BATCH = 8
ADAM_STEP_BOUND = LR * (1 - 0.5) / (1 - 0.999) ** 0.5
MLP = dict(kind="mlp", z_dim=4, data_dim=2, g_hidden=16, d_hidden=16,
           g_layers=2, d_layers=2, compute_dtype="float32")
TINY_BF16 = dict(TINY, compute_dtype="bfloat16")


def jax_data_fn(jb):
    """Uniform real batches; with labels drawn beside them for a
    conditional bundle."""
    def data_fn(key, n):
        if not jb.conditional:
            return jax.random.uniform(key, (n, *jb.data_shape), minval=-1.0,
                                      maxval=1.0), None
        k_x, k_l = jax.random.split(key)
        return (jax.random.uniform(k_x, (n, *jb.data_shape), minval=-1.0,
                                   maxval=1.0), jb.sample_labels(k_l, n))
    return data_fn


class JaxDraws(TrainDraws):
    """The port's draw seam, backed by the arrays the JAX chunk draws from
    its own keys (``step_key(base, index, role)``, split as it splits)."""

    def __init__(self, jb, data_fn, base_key, batch):
        self.jb, self.data_fn, self.base, self.batch = (jb, data_fn,
                                                        base_key, batch)

    def d_batch(self, index):
        k_data, k_z, k_lab = jax.random.split(
            step_key(self.base, index, "data"), 3)
        x, labels_r = self.data_fn(k_data, self.batch)
        z = self.jb.sample_z(k_z, self.batch)
        return (_torch(x), _torch(labels_r), _torch(z),
                _torch(self.jb.sample_labels(k_lab, self.batch)))

    def g_batch(self, index):
        k_z, k_lab = jax.random.split(step_key(self.base, index, "z"))
        return (_torch(self.jb.sample_z(k_z, self.batch)),
                _torch(self.jb.sample_labels(k_lab, self.batch)))


def _torch(a):
    """A JAX array as a torch tensor (integer labels as int64), None as
    None."""
    if a is None:
        return None
    a = np.array(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype.kind == "i" else a)


def jax_state(g_vars, d_vars, cfg):
    g_tx, d_tx = j_make_optimizers(cfg)
    g_vars = jax.tree.map(jnp.asarray, g_vars)
    d_vars = jax.tree.map(jnp.asarray, d_vars)
    ema = (jax.tree.map(jnp.copy, g_vars["params"]) if cfg.g_ema_decay > 0
           else None)
    return JTrainState(g_vars=g_vars, d_vars=d_vars,
                       g_opt=g_tx.init(g_vars["params"]),
                       d_opt=d_tx.init(d_vars["params"]),
                       step=jnp.zeros((), jnp.int32), g_ema=ema)


def run_both(model_kw, train_kw, seed=0, port=True, pair=make_pair):
    """One chunk of ``steps_per_call`` iterations in each package from the
    same weights (``pair``'s) and draws: (JAX state, JAX metrics, port
    state, port metrics, the port's config); with ``port=False`` JAX's
    only."""
    jb, tb, g_vars, d_vars, g, d = pair(model_kw, seed=seed)
    kw = dict(batch_size=BATCH, d_lr=LR, g_lr=LR, beta1=0.5, **train_kw)
    jcfg, tcfg = JTrainConfig(**kw), TTrainConfig(**kw)
    base = jax.random.PRNGKey(seed + 100)
    data_fn = jax_data_fn(jb)
    j_state, j_m = j_make_train_chunk(jb, jcfg, data_fn, base)(
        jax_state(g_vars, d_vars, jcfg))
    if not port:
        return j_state, j_m
    t_state = train_state_from(g, d, tcfg)
    t_state, t_m = make_train_chunk(
        tb, tcfg, draws=JaxDraws(jb, data_fn, base, BATCH))(t_state)
    return j_state, j_m, t_state, t_m, tcfg


def bn_fed_biases(params):
    """{layer whose bias feeds a train-mode BN: that BN's name}."""
    out = {}
    for name in params:
        if name == "project" and "bn_project" in params:
            out[name] = "bn_project"
        for prefix in ("conv", "deconv"):
            if name.startswith(prefix) and name[len(prefix):].isdigit():
                bn = "bn" + name[len(prefix):]
                if bn in params:
                    out[name] = bn
    return out


def max_err(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        return max([max_err(got[k], want[k]) for k in want], default=0.0)
    return float(np.max(np.abs(np.asarray(got, np.float64)
                               - np.asarray(want, np.float64)), initial=0.0))


def flat(tree):
    return np.concatenate([np.ravel(np.asarray(x, np.float64))
                           for x in jax.tree.leaves(tree)])


def scaled_err(got, want):
    """Max over the arrays of a tree of |got - want| / max |want|."""
    if isinstance(want, dict):
        return max([scaled_err(got[k], want[k]) for k in want], default=0.0)
    scale = max(float(np.max(np.abs(want), initial=0.0)), 1e-30)
    return max_err(got, want) / scale


def split_noise(got, want, got_opt, want_opt, side, step_bound, passes,
                stat_atol):
    """Check and remove the biases that feed a train-mode BN (and their
    moments and the BN's running mean) from the trees."""
    for name, bn in bn_fed_biases(want["params"]).items():
        noise = max_err(got["params"][name].pop("bias"),
                        want["params"][name].pop("bias"))
        assert noise <= step_bound, (side, name, noise)
        for opt in (got_opt, want_opt):
            if opt is not None:
                opt["mu"][name].pop("bias")
                opt["nu"][name].pop("bias")
        err = max_err(got["batch_stats"][bn].pop("mean"),
                      want["batch_stats"][bn].pop("mean"))
        assert err <= stat_atol + 0.1 * passes * noise, (side, bn, err)


def compare(j_state, j_m, t_state, t_m, cfg, j32=None):
    """Assert the module docstring's tolerances; with ``j32`` (JAX's state
    after the same chunk in float32) the bfloat16 ones."""
    bf16 = j32 is not None
    n = cfg.steps_per_call
    step_bound = 2 * ADAM_STEP_BOUND * n
    stat_atol = 5e-3 if bf16 else 1e-5
    fused = cfg.fused_prop
    assert t_state.step == int(j_state.step) == n
    for side in ("g", "d"):
        module, t_opt = getattr(t_state, side), getattr(t_state, f"{side}_opt")
        got, want = (to_jax_variables(module),
                     to_numpy_tree(getattr(j_state, f"{side}_vars")))
        got_opt = adam_to_optax(t_opt, module)["0"]
        want_opt = to_numpy_tree(getattr(j_state, f"{side}_opt")[0]._asdict())
        updates = 1 if fused else (cfg.d_steps if side == "d"
                                   else cfg.g_steps)
        assert int(got_opt["count"]) == int(want_opt["count"]) == n * updates
        # BN passes kept: D two per update (real, fake), G one.
        passes = (2 if side == "d" else 1) * updates * n
        split_noise(got, want, got_opt, want_opt, side, step_bound, passes,
                    stat_atol)
        if bf16:
            ref = to_numpy_tree(getattr(j32, f"{side}_vars"))
            ref_opt = to_numpy_tree(getattr(j32, f"{side}_opt")[0]._asdict())
            split_noise(ref, to_numpy_tree(getattr(j_state, f"{side}_vars")),
                        ref_opt, None, side, step_bound, passes, 1.0)
            for a, b, r in ((got["params"], want["params"], ref["params"]),
                            (got_opt["mu"], want_opt["mu"], ref_opt["mu"]),
                            (got_opt["nu"], want_opt["nu"], ref_opt["nu"])):
                spread = np.abs(flat(r) - flat(b)).mean()
                assert np.abs(flat(a) - flat(b)).mean() <= 3 * spread, side
            assert max_err(got["params"], want["params"]) <= step_bound
        else:
            err = np.abs(flat(got["params"]) - flat(want["params"]))
            assert np.mean(err <= 1e-7) >= 0.99, side
            assert err.max() <= 0.05 * LR, side
            assert scaled_err(got_opt["mu"], want_opt["mu"]) <= 5e-4, side
            assert scaled_err(got_opt["nu"], want_opt["nu"]) <= 5e-4, side
        if "batch_stats" in want:
            assert max_err(got["batch_stats"],
                           want["batch_stats"]) <= stat_atol, side
    if cfg.g_ema_decay > 0:
        got, want = params_to_flax(t_state.g_ema), to_numpy_tree(
            j_state.g_ema)
        for name in bn_fed_biases(want):
            # (1 - d) of the live bias's noise, d >= 0.5 in these chunks
            assert max_err(got[name].pop("bias"),
                           want[name].pop("bias")) <= step_bound
        err = np.abs(flat(got) - flat(want))
        assert err.max() <= (step_bound if bf16 else 0.05 * LR)
    else:
        assert t_state.g_ema is None and j_state.g_ema is None
    assert set(t_m) == set(j_m)
    for k in j_m:
        assert float(t_m[k]) == pytest.approx(float(j_m[k]), abs=stat_atol), k


OPTIONS = {
    "d1g1": dict(),
    "d1g2": dict(g_steps=2),
    "fused": dict(fused_prop=True),
    "r1": dict(r1_gamma=1.0),
    "fused_r1": dict(fused_prop=True, r1_gamma=1.0),
    "ema": dict(g_ema_decay=0.999, g_steps=2),
}


@pytest.mark.parametrize("spc", [1, 2, 3])
@pytest.mark.parametrize("option", list(OPTIONS))
def test_chunk_matches_jax_f32(option, spc):
    out = run_both(TINY, dict(OPTIONS[option], steps_per_call=spc))
    compare(*out)


@pytest.mark.parametrize("option,spc", [("d1g2", 2), ("fused", 3),
                                        ("r1", 2), ("ema", 2)])
def test_chunk_matches_jax_bf16(option, spc):
    kw = dict(OPTIONS[option], steps_per_call=spc)
    j32 = run_both(TINY, kw, port=False)[0]
    compare(*run_both(TINY_BF16, kw), j32=j32)


@pytest.mark.parametrize("option", ["d1g1", "fused", "ema"])
def test_chunk_matches_jax_mlp(option):
    out = run_both(MLP, dict(OPTIONS[option], steps_per_call=3))
    compare(*out)


def _port_chunk(model_kw, **train_kw):
    """A port state after one chunk on seeded draws, and the modules'
    buffers before it."""
    _, tb, _, _, g, d = make_pair(model_kw, seed=3)
    before = {"g": [b.clone() for b in g.buffers()],
              "d": [b.clone() for b in d.buffers()]}
    cfg = TTrainConfig(**dict(dict(batch_size=BATCH, d_lr=LR, g_lr=LR),
                              **train_kw))

    def data_fn(gen, n):
        return torch.rand((n, *tb.data_shape), generator=gen) * 2 - 1, None

    state = train_state_from(g, d, cfg)
    state, metrics = make_train_chunk(tb, cfg, data_fn, seed=5)(state)
    return state, metrics, before


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def test_d_update_keeps_g_statistics():
    state, metrics, before = _port_chunk(TINY, g_steps=0, steps_per_call=2)
    assert set(metrics) == {"d_loss", "d_real", "d_fake"}
    assert _same(state.g.buffers(), before["g"])
    assert not _same(state.d.buffers(), before["d"])


def test_g_update_keeps_d_statistics():
    state, metrics, before = _port_chunk(TINY, d_steps=0, steps_per_call=2)
    assert set(metrics) == {"g_loss"}
    assert _same(state.d.buffers(), before["d"])
    assert not _same(state.g.buffers(), before["g"])


@pytest.mark.parametrize("option", ["d1g2", "fused_r1"])
def test_updates_leave_no_gradients(option):
    state, _, _ = _port_chunk(TINY, **OPTIONS[option], steps_per_call=1)
    for p in list(state.g.parameters()) + list(state.d.parameters()):
        assert p.grad is None


def test_sampling_g_is_the_ema_generator_with_live_statistics():
    state, _, _ = _port_chunk(TINY, **OPTIONS["ema"], steps_per_call=2)
    g = sampling_g(state)
    assert g is state.g_ema
    assert _same(g.buffers(), state.g.buffers())
    assert not _same(g.parameters(), state.g.parameters())
    state.g_ema = None
    assert sampling_g(state) is state.g


def test_draws_are_keyed_by_seed_index_and_role():
    _, tb, _, _, _, _ = make_pair(MLP)

    def data_fn(gen, n):
        return torch.randn((n, 2), generator=gen), None

    draws = TrainDraws(tb, data_fn, seed=1, batch_size=4)
    x0, _, z0, _ = draws.d_batch(7)
    x1, _, z1, _ = TrainDraws(tb, data_fn, seed=1, batch_size=4).d_batch(7)
    assert torch.equal(x0, x1) and torch.equal(z0, z1)
    assert not torch.equal(draws.d_batch(8)[2], z0)
    assert not torch.equal(draws.g_batch(7)[0], z0)
    assert not torch.equal(TrainDraws(tb, data_fn, 2, 4).g_batch(7)[0],
                           draws.g_batch(7)[0])
    # The documented mix of (seed, role, step), fixed across versions.
    assert step_seed(1, 7, "data") == int.from_bytes(
        hashlib.sha256(b"1:0:7").digest()[:8], "little")
