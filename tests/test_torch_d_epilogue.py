"""D's eval-mode epilogue as one op (``ops/d_epilogue.py``), forward and VJP.

On the CPU:

* both plain ops bit for bit against the modules' composition
  (``FlaxBatchNorm`` in eval mode, ``lrelu``, ``F.pad``) and autograd's VJP
  of it, in bf16, at the imagenet64 and mnist Ds' layer shapes at odd B;
* the routing in ``DCGANDiscriminator.forward``: with the op's device set
  to the CPU (``_DEVICES``), eval mode takes it and train mode, float32, a
  non-channels-last activation and the CPU itself (the default device set)
  take the composition; D's logits and x-gradient are the composition's in
  every case;
* the fake implementations under ``make_fx``, and an exported and reloaded
  autograd-refined conditional serving round whose graph holds the ops;
* gradients of BN's parameters: a forward whose BN parameters need a
  gradient takes the composition (the parameters' gradients are autograd's
  own), the op refuses such parameters, and every refinement runs D over
  its parameters detached, in a graph and eagerly, so that every epilogue
  takes the op;
* ``d_epilogue_kernels`` tallied by a graph's capture and counted at each
  replay, through ``CPUGraph`` (``tests/test_torch_refine_graph.py``).

On the card (skipped without one; ``python -m pytest
tests/test_torch_d_epilogue.py --noconftest -q -p no:cacheprovider``
there), the kernels against the plain ops bit for bit at the six layer
shapes, and imagenet64's D through the op against the composition.
"""

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
from collaborative_gan_sampling_torch.ops import d_epilogue as E
from collaborative_gan_sampling_torch.ops.nn import FlaxBatchNorm, lrelu
from collaborative_gan_sampling_torch.sampling import refine as refine_mod
from collaborative_gan_sampling_torch.sampling.refine import (
    make_refine_fn,
    make_refine_z_fn,
)
from collaborative_gan_sampling_torch.utils import graphs, profiling
from test_torch_refine_graph import COND, CPUGraph

# (C, H, (lo, hi), BN) of imagenet64's D (conv0, bn1, bn2, bn3) and of
# mnist's (conv0, bn1).
LAYERS = [(96, 32, (1, 2), False), (192, 16, (1, 2), True),
          (384, 8, (1, 2), True), (768, 4, (0, 0), True),
          (64, 14, (1, 2), False), (128, 7, (0, 0), True)]
LAYER_IDS = ["in64_conv0", "in64_bn1", "in64_bn2", "in64_bn3",
             "mnist_conv0", "mnist_bn1"]


@pytest.fixture
def card():
    """The card, or a skip: decided here, never while the module is
    imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def on_cpu(monkeypatch):
    """D routes its eval-mode epilogues through the op on the CPU too."""
    monkeypatch.setattr(E, "_DEVICES", ("cpu", "cuda"))


@pytest.fixture(autouse=True)
def fresh_graphs():
    graphs._GRAPHS.clear()
    yield
    graphs._GRAPHS.clear()


def _bits(a, b) -> bool:
    """Same dtype, shape and bits (so -0 is not +0)."""
    as_int = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().view(as_int),
                            b.contiguous().view(as_int)))


def _layer(c, h, bn, n, device="cpu", seed=0):
    """conv_i's output (n, C, h, h) in bf16, channels-last, with some +0
    and -0; an eval-mode BN off its init, or None."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn(n, h, h, c, generator=gen, device=device)
         * 2).to(torch.bfloat16)
    x.view(-1)[::97] = 0.0
    x.view(-1)[::89] = -0.0
    norm = None
    if bn:
        norm = FlaxBatchNorm(c).to(device).eval()
        with torch.no_grad():
            norm.running_mean.normal_(0.0, 0.3, generator=gen)
            norm.running_var.uniform_(0.05, 2.0, generator=gen)
            norm.weight.normal_(1.0, 0.3, generator=gen)
            norm.bias.normal_(0.0, 0.2, generator=gen)
    return x.permute(0, 3, 1, 2), norm, gen


def _affine(norm):
    return E.NO_AFFINE if norm is None else tuple(
        t.detach() for t in norm.eval_affine())


def _composition_vjp(x, norm, pads, g):
    """The modules' chain at x and autograd's VJP of it for ``g``."""
    xg = x.detach().requires_grad_(True)
    y = F.pad(lrelu(xg if norm is None else norm(xg)), pads * 2)
    (dx,) = torch.autograd.grad(y, xg, g)
    return y.detach(), dx


def _check_layer(c, h, pads, bn, n, device, via):
    """``via(x, affine, lo, hi) -> out`` and ``via_backward`` against the
    composition, bit for bit; returns the op's outputs."""
    x, norm, gen = _layer(c, h, bn, n, device)
    hp = h + sum(pads)
    g = torch.randn(n, hp, hp, c, generator=gen, device=device).to(
        torch.bfloat16).permute(0, 3, 1, 2)
    want, want_dx = _composition_vjp(x, norm, pads, g)
    affine = _affine(norm)
    out = via[0](x, *affine, *pads)
    dx = via[1](g, out, affine[1], *pads)
    assert _bits(out, want) and _bits(dx, want_dx)
    for t in (out, dx):
        assert t.is_contiguous(memory_format=torch.channels_last)
    xg = x.detach().requires_grad_(True)
    (through,) = torch.autograd.grad(E.d_epilogue(xg, affine, *pads), xg, g)
    assert _bits(through, want_dx)
    return out, dx


# --------------------------------------------------------------------------
# The plain ops.
# --------------------------------------------------------------------------


@pytest.mark.parametrize("layer", LAYERS, ids=LAYER_IDS)
def test_plain_ops_are_the_composition(layer):
    c, h, pads, bn = layer
    ops = (torch.ops.cgs.d_epilogue_bf16,
           torch.ops.cgs.d_epilogue_bf16_backward)
    for n in (3, 1):
        _check_layer(c, h, pads, bn, n, "cpu", ops)
    # The plain functions are the CPU implementations.
    _check_layer(c, h, pads, bn, 3, "cpu",
                 (E.epilogue_plain, E.epilogue_backward_plain))


def test_op_refuses_parameters_that_need_a_gradient():
    x, norm, _ = _layer(16, 5, True, 2)
    with pytest.raises(RuntimeError, match="differentiates x alone"):
        E.d_epilogue(x.detach().requires_grad_(True), norm.eval_affine(),
                     1, 2)


# --------------------------------------------------------------------------
# The routing in DCGANDiscriminator.forward.
# --------------------------------------------------------------------------


def _pair(model, dtype="bfloat16", device="cpu", seed=3):
    bundle = make_bundle(ModelConfig(**dict(model, compute_dtype=dtype)),
                         device)
    _, d = bundle.init(torch.Generator(device=device).manual_seed(seed))
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    with torch.no_grad():
        for m in d.modules():
            if isinstance(m, FlaxBatchNorm):
                m.running_mean.normal_(0.0, 0.2, generator=gen)
                m.running_var.uniform_(0.2, 2.0, generator=gen)
                m.weight.normal_(1.0, 0.2, generator=gen)
    return bundle, d


def _chain_logits(d, x, labels):
    """D's forward as the modules compose it, written out."""
    h = lrelu(d.conv0(x.to(d.dtype).permute(0, 3, 1, 2)))
    for i in range(1, d.n):
        h = lrelu(getattr(d, f"bn{i}")(getattr(d, f"conv{i}")(h)))
    feat = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    logit = d.out(feat)[:, 0]
    if d.num_classes > 0:
        logit = logit + torch.sum(d.proj_embed(labels) * feat, dim=-1)
    return logit.float()


def _logits_and_grad(forward, x, labels):
    xg = x.detach().requires_grad_(True)
    logits = forward(xg, labels)
    (gx,) = torch.autograd.grad(F.softplus(-logits).sum(), xg)
    return logits.detach(), gx


def _counted(fn):
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        profiling.reset()
        out = fn()
        counters = profiling.summary()["counters"]
    profiling.reset()
    return out, counters.get("d_epilogue_kernels", 0)


@pytest.mark.parametrize("case,launches", [
    ("eval", 4), ("train", 0), ("float32", 0), ("not_channels_last", 0),
    ("cpu", 0)])
def test_routing_keeps_logits_and_gradient(case, launches, monkeypatch):
    if case != "cpu":
        monkeypatch.setattr(E, "_DEVICES", ("cpu", "cuda"))
    bundle, d = _pair(COND, "float32" if case == "float32" else "bfloat16")
    for p in d.parameters():  # as a refinement runs D
        p.requires_grad_(False)
    gen = torch.Generator().manual_seed(9)
    x = torch.rand((3,) + bundle.data_shape, generator=gen) * 2 - 1
    if case == "not_channels_last":  # NCHW memory: every activation NCHW
        x = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    labels = bundle.sample_labels(gen, 3)
    d.train(case == "train")
    want = _logits_and_grad(lambda v, lab: _chain_logits(d, v, lab), x,
                            labels)
    got, n = _counted(lambda: _logits_and_grad(d, x, labels))
    assert n == launches  # two epilogues, forward and VJP
    assert _bits(got[0], want[0]) and _bits(got[1], want[1])


# --------------------------------------------------------------------------
# Gradients of BN's parameters.
# --------------------------------------------------------------------------


def test_parameter_gradients_take_the_composition(on_cpu):
    """Eval mode, BN's parameters needing a gradient: conv0's epilogue takes
    the op, BN's the composition, and every parameter's gradient is the
    composition's."""
    bundle, d = _pair(COND)
    gen = torch.Generator().manual_seed(10)
    x = torch.rand((3,) + bundle.data_shape, generator=gen) * 2 - 1
    labels = bundle.sample_labels(gen, 3)
    params = list(d.parameters())

    def grads(forward):
        loss = F.softplus(-forward(x, labels)).sum()
        return torch.autograd.grad(loss, params)

    want = grads(lambda v, lab: _chain_logits(d, v, lab))
    got, n = _counted(lambda: grads(d.eval()))
    assert n == 2  # conv0's forward and VJP
    assert all(_bits(a, b) for a, b in zip(got, want))
    with torch.no_grad():  # no gradient recorded: every epilogue takes it
        _, n = _counted(lambda: d(x, labels))
    assert n == 2


@pytest.mark.parametrize("path", ["graph", "eager", "noise", "z"])
def test_refinement_runs_d_without_parameter_gradients(path, on_cpu,
                                                       monkeypatch):
    """A refinement differentiates its iterate alone: on a D whose
    parameters need a gradient, each of its K VJPs and K + 1 forwards takes
    the op at both epilogues, in a graph and eagerly alike (x-space with
    and without Langevin noise, z-space); the graph's replay is the eager
    loop's bit for bit, and the caller's D is left as it was."""
    monkeypatch.setattr(refine_mod, "_GRAPH_DEVICES",
                        ("cpu",) if path == "graph" else ())
    monkeypatch.setattr(refine_mod, "ModuleGraph", CPUGraph)
    CPUGraph.built = []
    bundle, d = _pair(COND)
    g, _ = bundle.init(torch.Generator().manual_seed(15))
    cfg = RefineConfig(steps=3, rate=0.05, noise=0.01 * (path == "noise"),
                       space="z" if path == "z" else "x")
    gen = torch.Generator().manual_seed(11)
    z = bundle.sample_z(gen, 4)
    labels = bundle.sample_labels(gen, 4)
    refine = make_refine_z_fn(bundle, cfg)
    (x, logits), n = _counted(lambda: refine(
        g, d, z, labels, generator=torch.Generator().manual_seed(16)))
    assert len(CPUGraph.built) == (path == "graph")
    assert all(p.requires_grad for p in d.parameters())
    assert n == 2 * (4 + 3)  # two epilogues a pass: 4 forwards, 3 VJPs
    if path == "graph":
        monkeypatch.setattr(refine_mod, "_GRAPH_DEVICES", ())
        (x_eager, logits_eager), _ = _counted(
            lambda: refine(g, d, z, labels))
        assert _bits(x, x_eager) and _bits(logits, logits_eager)


def test_replays_count_what_the_capture_tallied(on_cpu, monkeypatch):
    monkeypatch.setattr(refine_mod, "_GRAPH_DEVICES", ("cpu",))
    monkeypatch.setattr(refine_mod, "ModuleGraph", CPUGraph)
    bundle, d = _pair(COND)
    cfg = RefineConfig(steps=2, rate=0.05)
    refine = make_refine_fn(bundle, cfg)
    gen = torch.Generator().manual_seed(12)
    data = [(torch.rand((4,) + bundle.data_shape, generator=gen) * 2 - 1,
             bundle.sample_labels(gen, 4)) for _ in range(3)]
    refine(d, *data[0])  # the capture, outside the counts

    def run():
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU]):
            profiling.reset()
            for x0, labels in data:
                refine(d, x0, labels)
            return profiling.summary()["counters"]

    counters = run()
    profiling.reset()
    assert counters["refine_graph_replays"] == 3
    assert counters["d_epilogue_kernels"] == 3 * 2 * (3 + 2)


# --------------------------------------------------------------------------
# Tracing and export.
# --------------------------------------------------------------------------


def test_fake_implementations_under_make_fx():
    from torch.fx.experimental.proxy_tensor import make_fx

    x, norm, gen = _layer(16, 6, True, 3)
    affine = _affine(norm)
    g = torch.randn(3, 9, 9, 16, generator=gen).to(torch.bfloat16).permute(
        0, 3, 1, 2)

    def f(x, g, *affine):
        xg = x.detach().requires_grad_(True)
        out = E.d_epilogue(xg, affine, 1, 2)
        (dx,) = torch.autograd.grad(out, xg, g)
        return out.detach(), dx

    gm = make_fx(f, tracing_mode="fake")(x, g, *affine)
    targets = [str(n.target) for n in gm.graph.nodes
               if n.op == "call_function"]
    assert targets.count("cgs.d_epilogue_bf16.default") == 1
    assert targets.count("cgs.d_epilogue_bf16_backward.default") == 1
    assert all(_bits(a, b) for a, b in zip(gm(x, g, *affine),
                                           f(x, g, *affine)))


def test_exported_conditional_round_holds_the_ops(tmp_path, on_cpu):
    from collaborative_gan_sampling_torch.sampling.export import (
        export_sampler,
        load_sampler,
    )
    from collaborative_gan_sampling_torch.sampling.serve import (
        ServingSampler,
    )

    bundle, d = _pair(COND)
    g, _ = bundle.init(torch.Generator().manual_seed(13))
    cfg = RefineConfig(steps=2, rate=0.05, num_batches=2, batch_size=8,
                       burn_in=16)
    srv = ServingSampler(bundle, cfg, method="refinement")
    path = str(tmp_path / "round.pt2")
    export_sampler(srv, g, d, None, path)
    targets = [str(n.target) for n in torch.export.load(path).graph.nodes
               if n.op == "call_function"]
    # A batch: K + 1 D forwards and K VJPs, two epilogues each.
    assert targets.count("cgs.d_epilogue_bf16.default") == 2 * 2 * 3
    assert targets.count("cgs.d_epilogue_bf16_backward.default") == 2 * 2 * 2
    fn, _ = load_sampler(path)
    m = srv.calibrate(g, d, None)
    for seed in (0, 1):
        got = fn(seed)
        want = srv.round_seeded(g, d, m, torch.tensor([seed]))
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)


# --------------------------------------------------------------------------
# On the card.
# --------------------------------------------------------------------------


def _kernel_ops():
    return (lambda x, *a: E.d_epilogue(x, a[:3], *a[3:]),
            E.d_epilogue_backward)


@pytest.mark.parametrize("layer", LAYERS, ids=LAYER_IDS)
def test_kernels_are_the_plain_ops_on_card(card, layer):
    c, h, pads, bn = layer
    for n in (256, 37):
        fwd0 = E.d_epilogue.launches
        out, dx = _check_layer(c, h, pads, bn, n, card, _kernel_ops())
        assert E.d_epilogue.launches - fwd0 == 2  # the op, then autograd's
        # The plain versions on the card's own elementwise kernels.
        x, norm, gen = _layer(c, h, bn, n, card)
        assert _bits(out, E.epilogue_plain(x, *_affine(norm), *pads))


def test_imagenet64_d_through_the_op_on_card(card, monkeypatch):
    model = dataclasses.asdict(get_preset("imagenet64").model)
    bundle, d = _pair(model, device=card)
    for p in d.parameters():
        p.requires_grad_(False)
    gen = torch.Generator(device=card).manual_seed(14)
    x = torch.rand((64,) + bundle.data_shape, generator=gen,
                   device=card) * 2 - 1
    labels = bundle.sample_labels(gen, 64)
    got, n = _counted(lambda: _logits_and_grad(d, x, labels))
    assert n == 8
    monkeypatch.setattr(E, "_DEVICES", ())
    want, n = _counted(lambda: _logits_and_grad(d, x, labels))
    assert n == 0
    assert _bits(got[0], want[0]) and _bits(got[1], want[1])
