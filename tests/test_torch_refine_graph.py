"""The autograd refinement's CUDA graph (``sampling/refine.py``,
``utils/graphs.py``).

On the CPU:

* the gate: the eager loop runs for a CPU x0, and, with the graph's device
  set to the CPU and its capture made plain calls (``CPUGraph``), for
  Langevin noise, a trajectory, z-space, a ``make_fx`` trace, a tensor rate
  and the two kernel-gated Ds, while a conditional D's batch replays;
* the cache: two Ds of one layout share an entry; another batch, labels
  shape, K, rate or D's forward gets its own; the least recently used goes
  at the limit;
* the CPU refinement is bit for bit the eager formula written out here;
* the replay's copy-in, through ``CPUGraph``: after an in-place Adam step
  on D, and with two Ds alternating, each replay is the eager loop on the
  D it is given; one ``refine_graph_replays`` a batch and as many
  ``weight_casts`` as the eager loop.

On the card (skipped without one; ``python -m pytest
tests/test_torch_refine_graph.py --noconftest -q`` there, where JAX is
absent), the same against the real graph, on a 16x16x3 conditional D and
on imagenet64's D at B = 256, and a serving export through an autograd
refinement, traced with the graph off.
"""

import contextlib
import dataclasses

import pytest
import torch
import torch.nn.functional as F

from collaborative_gan_sampling_torch.config import (
    ModelConfig,
    RefineConfig,
    get_preset,
)
from collaborative_gan_sampling_torch.models import make_bundle
from collaborative_gan_sampling_torch.sampling import refine as refine_mod
from collaborative_gan_sampling_torch.sampling.refine import (
    make_refine_fn,
    make_refine_z_fn,
)
from collaborative_gan_sampling_torch.utils import graphs, profiling
from collaborative_gan_sampling_torch.utils.graphs import ModuleGraph
from collaborative_gan_sampling_torch.utils.profiling import tallied

COND = dict(kind="dcgan", z_dim=8, image_size=16, channels=3,
            g_base_filters=8, d_base_filters=8, num_classes=5)
CONV28 = dict(kind="dcgan", z_dim=8, image_size=28, channels=1,
              g_base_filters=8, d_base_filters=64)
MLP = dict(kind="mlp", z_dim=4, data_dim=2, g_hidden=16, d_hidden=16,
           g_layers=2, d_layers=2, compute_dtype="float32")
FULL = dict(steps=3, rate=0.05, clip_norm=0.5, stop_score=0.6,
            proximal=0.1, objective="kl")


class CPUGraph(ModuleGraph):
    """``ModuleGraph`` whose capture and replay are plain calls of the
    captured function: its copies in and out, run on the CPU."""

    built: list = []

    def _capture(self, run):
        CPUGraph.built.append(self)
        self.run = run
        with tallied() as counts:
            outputs = run()
        return counts, tuple(outputs)

    def _replay(self):
        with tallied():  # the capture's tally stands for a replay's counts
            outputs = self.run()
        for static, t in zip(self.outputs, outputs):
            static.copy_(t)


@pytest.fixture(autouse=True)
def fresh_graphs():
    graphs._GRAPHS.clear()
    CPUGraph.built = []
    yield
    graphs._GRAPHS.clear()


@pytest.fixture
def cpu_graphs(monkeypatch):
    """The graph on the CPU, its capture plain calls."""
    monkeypatch.setattr(refine_mod, "_GRAPH_DEVICES", ("cpu",))
    monkeypatch.setattr(refine_mod, "ModuleGraph", CPUGraph)


@pytest.fixture
def card():
    """The card, or a skip: decided here, never while the module is
    imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _pair(model: dict, device="cpu", seed=3, dtype="bfloat16"):
    bundle = make_bundle(ModelConfig(**dict(dict(compute_dtype=dtype),
                                            **model)), device)
    gen = torch.Generator(device=bundle.device).manual_seed(seed)
    g, d = bundle.init(gen)
    return bundle, g, d


def _batch(bundle, n: int, seed: int = 5):
    gen = torch.Generator(device=bundle.device).manual_seed(seed)
    x0 = torch.rand((n,) + bundle.data_shape, generator=gen,
                    device=bundle.device) * 2 - 1
    return x0, bundle.sample_labels(gen, n)


def _eager(bundle, d, x0, labels, cfg):
    """The refinement with the graph off."""
    x, aux = make_refine_fn(bundle, cfg)(d, x0, labels)
    return x, aux["logits"]


def _same(a, b):
    assert all(torch.equal(s, t) for s, t in zip(a, b))


# --------------------------------------------------------------------------
# The gate.
# --------------------------------------------------------------------------


def _gate_case(case: str):
    """A function that runs the case's refinement and returns its
    tensors."""
    model = {"conv_kernel_d": CONV28, "mlp_kernel_d": MLP}.get(case, COND)
    bundle, g, d = _pair(model)
    cfg = RefineConfig(**dict(steps=2, rate=0.05,
                              noise=0.3 if case == "noise" else 0.0,
                              space="z" if case == "z_space" else "x"))
    x0, labels = _batch(bundle, 4)
    if case == "z_space":
        z = bundle.sample_z(torch.Generator().manual_seed(1), 4)
        return lambda: make_refine_z_fn(bundle, cfg)(g, d, z, labels)
    refine = make_refine_fn(bundle, cfg,
                            return_trajectory=case == "trajectory")
    rate = torch.tensor(0.05) if case == "tensor_rate" else None

    def run():
        gen = torch.Generator().manual_seed(2)
        x, aux = refine(d, x0, labels, generator=gen, rate=rate)
        return x, aux["logits"], aux.get("traj", x)

    if case == "make_fx":
        from torch.fx.experimental.proxy_tensor import make_fx

        def traced():
            with profiling.suspended():  # as sampling/export.py traces
                gm = make_fx(lambda x: refine(d, x, labels)[0],
                             tracing_mode="real")(x0)
            return (gm(x0),)

        return traced
    return run


@pytest.mark.parametrize("case,replays", [
    ("graph", True), ("cpu_x0", False), ("noise", False),
    ("trajectory", False), ("z_space", False), ("make_fx", False),
    ("tensor_rate", False), ("conv_kernel_d", False),
    ("mlp_kernel_d", False)])
def test_graph_gate(case, replays, monkeypatch):
    want = _gate_case(case)()
    if case != "cpu_x0":
        monkeypatch.setattr(refine_mod, "_GRAPH_DEVICES", ("cpu",))
    monkeypatch.setattr(refine_mod, "ModuleGraph", CPUGraph)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        profiling.reset()
        got = _gate_case(case)()
        counters = profiling.summary()["counters"]
    profiling.reset()
    _same(got, want)
    assert len(CPUGraph.built) == int(replays)
    assert counters.get("refine_graph_replays", 0) == int(replays)


# --------------------------------------------------------------------------
# The cache.
# --------------------------------------------------------------------------


@pytest.mark.parametrize("change,shared", [
    ("other_d", True), ("batch", False), ("labels", False),
    ("steps", False), ("rate", False), ("forward", False)])
def test_graph_key(change, shared, monkeypatch):
    bundle, _, d = _pair(COND)
    _, _, d2 = _pair(COND, seed=4)
    cfg = RefineConfig(steps=2, rate=0.05)
    x0, labels = _batch(bundle, 4)
    key = refine_mod._graph_key(bundle, d, x0, labels, cfg, cfg.rate)
    other = {
        "other_d": lambda: refine_mod._graph_key(bundle, d2, *_batch(
            bundle, 4, seed=9), cfg, 0.05),
        "batch": lambda: refine_mod._graph_key(bundle, d, *_batch(
            bundle, 6), cfg, 0.05),
        "labels": lambda: refine_mod._graph_key(bundle, d, x0, labels[:, None],
                                                cfg, 0.05),
        "steps": lambda: refine_mod._graph_key(
            bundle, d, x0, labels, dataclasses.replace(cfg, steps=3), 0.05),
        "rate": lambda: refine_mod._graph_key(bundle, d, x0, labels, cfg,
                                              0.02),
        "forward": lambda: monkeypatch.setattr(
            type(d), "forward", lambda self, x, labels=None: x.sum())
        or refine_mod._graph_key(bundle, d, x0, labels, cfg, 0.05),
    }[change]()
    assert (key == other) == shared
    built = []
    for k in (key, other):
        graphs.cached(k, lambda: built.append(1) or object())
    assert len(built) == (1 if shared else 2)


def test_cache_drops_least_recently_used():
    kept = {k: graphs.cached(k, object) for k in range(graphs.SLOTS)}
    assert graphs.cached(0, object) is kept[0]  # 0 used last, 1 least
    graphs.cached("new", object)
    assert graphs.cached(0, object) is kept[0]
    assert graphs.cached(1, object) is not kept[1]
    assert len(graphs._GRAPHS) == graphs.SLOTS


# --------------------------------------------------------------------------
# The CPU path and the copy-in.
# --------------------------------------------------------------------------


def _formula(bundle, d, x0, labels, cfg):
    """The eager autograd refinement, written out."""
    x = v0 = x0.detach()
    for _ in range(cfg.steps):
        with torch.enable_grad():
            xg = x.detach().requires_grad_(True)
            logits = bundle.discriminate(d, xg, labels, train=False)
            loss = (F.softplus(-logits) if cfg.objective == "ns"
                    else -logits).sum()
            (g,) = torch.autograd.grad(loss, xg)
        logits = logits.detach()
        if cfg.proximal > 0:
            g = g + cfg.proximal * (x - v0)
        if cfg.clip_norm > 0:
            norm = torch.sqrt(torch.sum(g * g, dim=(1, 2, 3), keepdim=True)
                              + 1e-12)
            g = g * torch.clamp_max(cfg.clip_norm / norm, 1.0)
        x_new = x - cfg.rate * g
        if cfg.stop_score > 0:
            active = torch.sigmoid(logits) < cfg.stop_score
            x_new = torch.where(active[:, None, None, None], x_new, x)
        x = x_new
    with torch.no_grad():
        return x, bundle.discriminate(d, x, labels, train=False)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("terms", ["plain", "full"])
def test_cpu_refinement_is_the_formula(dtype, terms):
    bundle, _, d = _pair(COND, dtype=dtype)
    cfg = RefineConfig(**(FULL if terms == "full" else dict(steps=3,
                                                            rate=0.05)))
    x0, labels = _batch(bundle, 6)
    _same(_eager(bundle, d, x0, labels, cfg),
          _formula(bundle, d, x0, labels, cfg))
    assert not graphs._GRAPHS


def _adam_step(bundle, d, x0, labels):
    opt = torch.optim.Adam(d.parameters(), lr=1e-2)
    loss = bundle.discriminate(d, x0, labels, train=True).square().mean()
    opt.zero_grad()
    loss.backward()
    opt.step()


@contextlib.contextmanager
def _graph_off():
    """The eager path, whatever the device."""
    saved = refine_mod._GRAPH_DEVICES
    refine_mod._GRAPH_DEVICES = ()
    try:
        yield
    finally:
        refine_mod._GRAPH_DEVICES = saved


def _within_eager(got, once, twice):
    """Each of ``got`` within what two eager runs differ by (bit for bit
    where they agree bit for bit)."""
    for g_, a, b in zip(got, once, twice):
        assert float((g_ - a).abs().max()) <= float((a - b).abs().max())


def _eager_twice(bundle, d, x0, labels, cfg):
    with _graph_off():
        return (_eager(bundle, d, x0, labels, cfg),
                _eager(bundle, d, x0, labels, cfg))


def _check_replays_follow_d(device, model, n, cfg):
    """Replays against the eager loop: on D, after an Adam step on D (its
    BN statistics moved too), on a second D, on D, on the second D."""
    bundle, _, d = _pair(model, device)
    _, _, d2 = _pair(model, device, seed=8)
    refine = make_refine_fn(bundle, cfg)
    for i, dd in enumerate((d, "step", d2, d, d2)):
        if dd == "step":
            _adam_step(bundle, d, *_batch(bundle, n, seed=11))
            dd = d
        x0, labels = _batch(bundle, n, seed=20 + i)
        once, twice = _eager_twice(bundle, dd, x0, labels, cfg)
        x, aux = refine(dd, x0, labels)
        _within_eager((x, aux["logits"]), once, twice)
    assert len(graphs._GRAPHS) == 1


@pytest.mark.parametrize("terms", ["plain", "full"])
def test_replay_follows_d_on_cpu(terms, cpu_graphs):
    cfg = RefineConfig(**(FULL if terms == "full" else dict(steps=3,
                                                            rate=0.05)))
    _check_replays_follow_d("cpu", COND, 4, cfg)
    assert len(CPUGraph.built) == 1


def _counted(fn):
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        profiling.reset()
        fn()
        counters = profiling.summary()["counters"]
    profiling.reset()
    return counters


def _check_counts(device, model, n, batches=3):
    """One ``refine_graph_replays`` a batch, and the eager counts."""
    bundle, _, d = _pair(model, device)
    cfg = RefineConfig(steps=3, rate=0.05)
    refine = make_refine_fn(bundle, cfg)
    data = [_batch(bundle, n, seed=s) for s in range(batches)]

    def run():
        for x0, labels in data:
            refine(d, x0, labels)

    refine(d, *data[0])  # the capture, outside the counts
    with _graph_off():
        eager = _counted(run)
    graph = _counted(run)
    assert eager["weight_casts"] > 0
    assert "refine_graph_replays" not in eager
    assert graph == dict(eager, refine_graph_replays=batches)


def test_replay_counts_on_cpu(cpu_graphs):
    _check_counts("cpu", COND, 4)


# --------------------------------------------------------------------------
# On the card: COND at B = 64 and imagenet64's D at B = 256.
# --------------------------------------------------------------------------

CARD_CASES = ["cond16", "imagenet64"]


def _card_case(which: str):
    if which == "cond16":
        return dict(COND), 64
    return dataclasses.asdict(get_preset("imagenet64").model), 256


@pytest.mark.parametrize("which", CARD_CASES)
def test_graph_matches_eager_on_card(card, which):
    model, n = _card_case(which)
    bundle, _, d = _pair(model, card)
    cfg = RefineConfig(steps=10, rate=0.01)
    x0, labels = _batch(bundle, n)
    once, twice = _eager_twice(bundle, d, x0, labels, cfg)
    x, aux = make_refine_fn(bundle, cfg)(d, x0, labels)
    assert len(graphs._GRAPHS) == 1
    _within_eager((x, aux["logits"]), once, twice)
    x2, _ = make_refine_fn(bundle, cfg)(d, x0, labels)  # a second replay
    assert torch.equal(x2, x)
    assert len(graphs._GRAPHS) == 1


@pytest.mark.parametrize("which", CARD_CASES)
def test_replay_follows_d_on_card(card, which):
    model, n = _card_case(which)
    _check_replays_follow_d(card, model, n, RefineConfig(steps=10, rate=0.01))


@pytest.mark.parametrize("which", CARD_CASES)
def test_replay_counts_on_card(card, which):
    _check_counts(card, *_card_case(which))


def test_export_on_card_traces_eagerly(card, tmp_path):
    from collaborative_gan_sampling_torch.sampling.export import (
        export_sampler,
        load_sampler,
    )
    from collaborative_gan_sampling_torch.sampling.serve import (
        ServingSampler,
    )

    bundle, g, d = _pair(COND, card)
    cfg = RefineConfig(steps=2, rate=0.05, batch_size=16, num_batches=2)
    sampler = ServingSampler(bundle, cfg, method="refinement")
    path = str(tmp_path / "round.pt2")
    export_sampler(sampler, g, d, torch.Generator(card).manual_seed(1), path)
    assert not graphs._GRAPHS  # the trace ran the eager loop
    samples, _, mask, logits = load_sampler(path)[0](7)
    want = sampler.round_seeded(g, d, torch.zeros((), device=card),
                                torch.tensor([7], device=card))
    assert len(graphs._GRAPHS) == 1  # the live round replays
    torch.testing.assert_close(samples, want[0])
    torch.testing.assert_close(logits, want[3])
    assert bool(mask.all())
