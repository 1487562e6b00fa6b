"""The port's serving export (``sampling/export.py``) and the seeded serving
round it traces (``ServingSampler.round_seeded`` / ``_round_from``).

* ``_round_from``, the round as a pure function of its draws, against JAX's
  ``ServingSampler.round`` with JAX's z and u injected (as
  tests/test_torch_serve.py replays them), with and without the kernels (on
  the CPU their ops take the plain versions): x and logits at ATOL, masks
  equal;
* the artifact reloaded against the live seeded round: bit for bit on the
  CPU, since it runs the same aten ops and ``cgs::`` ops in the same order
  (``make_fx`` records them as they run);
* a conditional export carrying its labels (JAX tests/test_export.py:67),
  and ``class_id``;
* the sidecar's keys against the JAX package's, less the renamed one;
* a child process that loads and runs an artifact without importing the
  models, the samplers, the training code or the pipeline;
* the Philox draws: deterministic, no global-RNG draw, and normals whose
  mean and variance over 65,536 draws lie within 4 sigma of N(0, 1).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collaborative_gan_sampling_torch import cli as t_cli
from collaborative_gan_sampling_torch.config import (
    ModelConfig as TModelConfig,
    RefineConfig as TRefineConfig,
)
from collaborative_gan_sampling_torch.models import make_bundle as t_bundle
from collaborative_gan_sampling_torch.ops.accept import (
    drs_accept_mask_philox,
)
from collaborative_gan_sampling_torch.sampling import serve as t_serve
from collaborative_gan_sampling_torch.sampling.export import (
    export_sampler,
    load_sampler,
)
from collaborative_gan_sampling_torch.sampling.serve import (
    ServingSampler as TServingSampler,
)
from collaborative_gan_sampling_torch.utils.prng import (
    philox_keys,
    philox_normal,
    philox_randint,
)
from collaborative_gan_sampling_tpu.config import (
    ModelConfig,
    RefineConfig,
)
from collaborative_gan_sampling_tpu.models import make_bundle
from collaborative_gan_sampling_tpu.sampling.export import (
    export_sampler as jax_export_sampler,
)
from collaborative_gan_sampling_tpu.sampling.serve import ServingSampler
from tests.test_torch_mlp import SMALL
from tests.test_torch_models import make_pair
from tests.test_torch_serve import _replay

ATOL = 1e-5  # the serving tests' tolerance (tests/test_torch_serve.py)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(steps=2, rate=0.05, num_batches=3, batch_size=32, burn_in=64)


@pytest.fixture(scope="module")
def pair():
    return make_pair(SMALL, seed=40)


def _torch_sampler(model_kw, method, seed=0, **refine_kw):
    bundle = t_bundle(TModelConfig(**model_kw), "cpu")
    g, d = bundle.init(torch.Generator().manual_seed(seed))
    kw = dict(KW, **refine_kw)
    return TServingSampler(bundle, TRefineConfig(**kw), method=method,
                           class_id=kw.get("class_id")), g, d


IMAGE = dict(kind="dcgan", z_dim=8, image_size=16, channels=1,
             g_base_filters=8, d_base_filters=8, compute_dtype="float32")
# The mnist preset's D at its width (28x28x1, 64 filters), bf16: its
# refinement is the cgs::conv_refine28_bf16 node.
MNIST_BF16 = dict(kind="dcgan", z_dim=16, image_size=28, channels=1,
                  g_base_filters=8, d_base_filters=64,
                  compute_dtype="bfloat16")


@pytest.mark.parametrize("method,use_pallas", [
    ("standard", False), ("standard", True), ("collab", False),
    ("collab", True)])
def test_round_from_matches_jax_round(pair, method, use_pallas,
                                      monkeypatch):
    jb, tb, g_vars, d_vars, g, d = pair
    kw = dict(KW, use_pallas=use_pallas)
    jsrv = ServingSampler(jb, RefineConfig(**kw), method=method)
    m = jsrv.calibrate(g_vars, d_vars, jax.random.PRNGKey(6))
    k_round = jax.random.PRNGKey(7)
    x_want, _, acc_want, lg_want = jsrv.round(g_vars, d_vars, m, k_round)

    zs, us = _replay(k_round, RefineConfig(**kw), jb.z_dim, calibrate=False)
    real_accept = t_serve.drs_accept_mask

    def accept_with_u(gen, logits, *args, **kw):
        return real_accept(gen, logits, *args,
                           uniforms=torch.from_numpy(us.pop(0)), **kw)

    monkeypatch.setattr(t_serve, "drs_accept_mask", accept_with_u)
    tsrv = TServingSampler(tb, TRefineConfig(**kw), method=method)
    x_got, labels, acc_got, lg_got = tsrv._round_from(
        g, d, torch.tensor(float(m)), torch.from_numpy(np.stack(zs)), None,
        torch.arange(3))
    assert labels is None and (not us or method == "standard")
    np.testing.assert_allclose(x_got.numpy(), np.asarray(x_want), atol=ATOL)
    np.testing.assert_allclose(lg_got.numpy(), np.asarray(lg_want),
                               atol=ATOL)
    np.testing.assert_array_equal(acc_got.numpy(), np.asarray(acc_want))


def test_round_from_takes_the_kernels_accept_bits(pair):
    """Off the kernel, a batch's u are the bits the accept kernel draws
    from its key: the two routes give one mask."""
    _, tb, _, _, g, d = pair
    z = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (3, 32, 4)).astype(np.float32))
    seeds = torch.tensor([11, 12, 13])
    outs = [TServingSampler(tb, TRefineConfig(**KW, use_pallas=up),
                            method="reject")._round_from(
        g, d, torch.tensor(1.5), z, None, seeds) for up in (False, True)]
    assert torch.equal(outs[0][2], outs[1][2])
    assert 0 < int(outs[0][2].sum()) < 96
    want = torch.cat([drs_accept_mask_philox(
        s, outs[0][3][32 * i:32 * (i + 1)], 1.5, 0.0, 1e-6, 80.0)
        for i, s in enumerate(seeds)])
    assert torch.equal(outs[1][2], want)


# Two batches of 16 (the trace grows with the batches).
SHORT = dict(num_batches=2, batch_size=16, burn_in=32)


@pytest.mark.parametrize("model_kw,method,use_pallas,nodes,extra", [
    (SMALL, "collab", True, "refine_mlp", {}),
    # Langevin noise: autograd refinement, noise from PhiloxNormals.
    (SMALL, "collab", True, None, dict(noise=0.01)),
    (SMALL, "reject", True, None, {}),
    (IMAGE, "collab", True, None, {}),  # the cifar10 path: autograd
    # The imagenet64 preset's z-space collab under per-class M.
    (dict(IMAGE, num_classes=4), "collab", True, None,
     dict(space="z", per_class_drs=True)),
    (MNIST_BF16, "collab", True, "conv_refine28_bf16", dict(batch_size=8)),
], ids=["toy_kernel", "toy_noise", "toy_reject", "dcgan",
        "cond_z_per_class", "mnist_bf16_kernel"])
def test_export_roundtrip_equals_live_seeded_round(tmp_path, model_kw,
                                                   method, use_pallas,
                                                   nodes, extra):
    srv, g, d = _torch_sampler(model_kw, method, use_pallas=use_pallas,
                               **dict(SHORT, **extra))
    path = str(tmp_path / "sampler.pt2")
    meta = export_sampler(srv, g, d, torch.Generator().manual_seed(5), path)
    nb, bs = srv.cfg.num_batches, srv.cfg.batch_size
    assert meta["candidates_per_round"] == nb * bs
    assert json.load(open(path + ".json")) == meta
    assert meta["bytes"] == os.path.getsize(path)
    fn, meta2 = load_sampler(path)
    assert meta2 == meta and meta["device"] == "cpu"

    m = srv.calibrate(g, d, torch.Generator().manual_seed(5))
    for seed in (0, 1):
        want = srv.round_seeded(g, d, m, torch.tensor([seed]))
        got = fn(seed)
        assert (got[1] is None) == (not srv.bundle.conditional)
        for a, b in zip(got, want):
            assert (a is None and b is None) or (
                a.dtype == b.dtype and torch.equal(a, b))
    assert got[0].shape == (nb * bs, *srv.bundle.data_shape)
    assert not torch.equal(fn(0)[0], fn(1)[0])

    targets = [str(n.target) for n in
               torch.export.load(path).graph.nodes
               if n.op == "call_function"]
    cgs = sorted({t for t in targets if t.startswith("cgs.")})
    want_ops = (["cgs.drs_accept_philox.default"] if use_pallas
                and method != "standard" else [])
    if nodes:
        want_ops = sorted(want_ops + [f"cgs.{nodes}.default"])
    assert cgs == want_ops
    for op in want_ops:  # one node per batch
        assert targets.count(op) == nb
    assert not [t for t in targets if "rand" in t]  # no global-RNG op


def test_export_conditional_carries_labels(tmp_path):
    """JAX tests/test_export.py:67, and targeted serving: class_id."""
    cond = dict(IMAGE, num_classes=4)
    srv, g, d = _torch_sampler(cond, "refinement", use_pallas=False,
                               num_batches=2, batch_size=8, burn_in=16)
    path = str(tmp_path / "cond.pt2")
    export_sampler(srv, g, d, None, path)
    fn, meta = load_sampler(path)
    assert meta["conditional"] is True and meta["class_id"] is None
    x, labels, acc, logits = fn(torch.tensor([1]))
    assert labels.shape == (16,) and labels.dtype == torch.int64
    assert 0 <= int(labels.min()) and int(labels.max()) < 4
    assert len(set(labels.tolist())) > 1
    assert bool(acc.all())  # refinement accepts all

    srv7 = TServingSampler(srv.bundle, srv.cfg, "reject", class_id=2)
    path7 = str(tmp_path / "cond2.pt2")
    meta7 = export_sampler(srv7, g, d, torch.Generator().manual_seed(1),
                           path7)
    fn7, _ = load_sampler(path7)
    x, labels, acc, logits = fn7(3)
    assert meta7["class_id"] == 2 and labels.tolist() == [2] * 16
    assert x.shape == (16, 16, 16, 1) and bool(torch.isfinite(x).all())


def test_sidecar_keys_are_jax_keys(tmp_path):
    """The same keys as JAX's sidecar but ``platforms``, which is
    ``device`` here (an artifact serves one device type); ``format`` and
    ``key_dtype`` name this format and its seed."""
    j_bundle = make_bundle(ModelConfig(**IMAGE))
    g_vars, d_vars = j_bundle.init(jax.random.PRNGKey(0))
    rkw = dict(steps=2, rate=0.05, num_batches=2, batch_size=8, burn_in=16,
               use_pallas=False)
    j_meta = jax_export_sampler(
        ServingSampler(j_bundle, RefineConfig(**rkw), method="reject"),
        g_vars, d_vars, jax.random.PRNGKey(1), str(tmp_path / "j.hlo"),
        platforms=("cpu",))
    srv, g, d = _torch_sampler(IMAGE, "reject", **rkw)
    t_meta = export_sampler(srv, g, d, None, str(tmp_path / "t.pt2"))
    assert set(t_meta) == set(j_meta) - {"platforms"} | {"device"}
    for k in set(t_meta) - {"device", "format", "key_dtype", "bytes"}:
        assert t_meta[k] == j_meta[k], k
    assert (t_meta["format"], t_meta["key_dtype"], t_meta["device"]) == (
        "torch.export", "int64[1] seed", "cpu")


CHILD = """
import hashlib, json, sys
from collaborative_gan_sampling_torch.sampling.export import load_sampler
fn, meta = load_sampler(sys.argv[1])
out = {}
for seed in (0, 1):
    res = fn(seed)
    out[seed] = [None if t is None else hashlib.sha256(
        t.contiguous().view(-1).view(torch.uint8).numpy().tobytes()
        ).hexdigest() for t in res]
pkg = "collaborative_gan_sampling_torch."
loaded = sorted(m for m in sys.modules if m.startswith(pkg))
print(json.dumps({"digests": out, "modules": loaded}))
"""


def _digest(t):
    import hashlib
    if t is None:
        return None
    return hashlib.sha256(t.contiguous().view(-1).view(torch.uint8)
                          .numpy().tobytes()).hexdigest()


def test_child_process_loads_without_model_code(tmp_path):
    srv, g, d = _torch_sampler(SMALL, "collab", use_pallas=True)
    path = str(tmp_path / "s.pt2")
    export_sampler(srv, g, d, torch.Generator().manual_seed(2), path)
    m = srv.calibrate(g, d, torch.Generator().manual_seed(2))
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", "import torch\n" + CHILD, path],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for seed in (0, 1):
        want = srv.round_seeded(g, d, m, torch.tensor([seed]))
        assert out["digests"][str(seed)] == [_digest(t) for t in want]
    for part in ("models", "sampling.serve", "sampling.refine",
                 "sampling.collab", "training", "pipeline", "data"):
        assert not [mod for mod in out["modules"]
                    if mod.startswith(f"collaborative_gan_sampling_torch."
                                      f"{part}")], (part, out["modules"])
    assert "collaborative_gan_sampling_torch.ops.registry" in out["modules"]


def test_seeded_round_is_deterministic_and_leaves_global_rng(pair):
    _, tb, _, _, g, d = pair
    srv = TServingSampler(tb, TRefineConfig(**KW, noise=0.01,
                                            use_pallas=False), "collab")
    m = torch.tensor(2.0)
    torch.manual_seed(123)
    state = torch.get_rng_state()
    a = srv.round_seeded(g, d, m, torch.tensor([4]))
    b = srv.round_seeded(g, d, m, torch.tensor([4]))
    c = srv.round_seeded(g, d, m, torch.tensor([5]))
    assert torch.equal(torch.get_rng_state(), state)
    assert all(torch.equal(x, y) for x, y in zip(a[::2], b[::2]))
    assert not torch.equal(a[0], c[0])


def test_philox_normals_are_standard_normal():
    key = philox_keys(torch.tensor([2024]), 1)[0]
    z = philox_normal(key, 65_536)
    assert z.dtype == torch.float32 and z.shape == (65_536,)
    assert torch.equal(z, philox_normal(key, 65_536))
    assert torch.equal(philox_normal(key, 101), z[:101])
    n = z.numel()
    assert abs(float(z.mean())) < 4 / n ** 0.5
    assert abs(float(z.var()) - 1.0) < 4 * (2 / n) ** 0.5
    other = philox_normal(philox_keys(torch.tensor([2025]), 1)[0], 1000)
    assert not torch.equal(other, z[:1000])
    keys = philox_keys(torch.tensor([7]), 64)
    assert len(set(keys.tolist())) == 64 and int(keys.min()) >= 0
    labels = philox_randint(key, 10_000, 10)
    counts = torch.bincount(labels, minlength=10)
    assert int(labels.max()) < 10 and int(counts.min()) > 850


def test_cli_export_and_platforms(tmp_path, capsys):
    work = str(tmp_path / "cli")
    args = ["--config", "toy2d", "--device", "cpu", "--workdir", work,
            "model.g_hidden=16", "model.d_hidden=16", "train.niters=2",
            "train.steps_per_call=2", "refine.num_batches=2",
            "refine.batch_size=16", "refine.burn_in=32"]
    out = str(tmp_path / "toy.pt2")
    assert t_cli.main(["export", *args, f"out={out}", "platforms=cpu"]) == 0
    meta = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert meta["out"] == out and meta["method"] == "collab"
    fn, _ = load_sampler(out)
    x, labels, acc, logits = fn(0)
    assert x.shape == (32, 2) and labels is None and acc.shape == (32,)
    with pytest.raises(ValueError, match="one device type"):
        t_cli.main(["export", *args, f"out={out}", "platforms=cuda,cpu"])
    with pytest.raises(ValueError, match="does not match --device"):
        t_cli.main(["export", *args, f"out={out}", "platforms=cuda"])
    assert t_cli.main(["export", *args]) == 2  # no out=
