"""Discriminator-guided refinement of samples in data space (x-space).

Counterpart of ``collaborative_gan_sampling_tpu/sampling/refine.py``:

    x_{k+1} = x_k - rate * grad_x l(D(x_k)),   l = softplus(-d) for 'ns',

with optional per-sample gradient clipping, Langevin noise, a per-sample
stop score and a proximal pull toward x_0. D runs in eval mode, so it is
per-sample decoupled and the gradient of the summed loss is each sample's
own. Where ``ops/conv_refine.supports_conv_refine_kernel`` holds, the K steps
run as a fused conv-D kernel in the model's compute dtype, as the JAX package
refines the same preset: ``fused_refine_conv28_bf16`` (bf16 matmul operands,
f32 sums) for a ``bfloat16`` model, ``fused_refine_conv28`` (f32) otherwise.
Where ``ops/refine_mlp.supports_mlp_refine_kernel`` holds, they run as the
fused MLP-D kernel, which reads D's own weight tensors. Each kernel takes
its plain version on the CPU and any rate. Elsewhere (a conditional D
among them) the steps run as autograd steps (``_autograd_refine``, the
counterpart of JAX's ``_refine_scan``). On the card those steps and the
final D pass of a batch replay as one CUDA graph (``utils/graphs.py``),
captured once per process for each key of ``_graph_key`` (D's modules and
layout, the batch's, K, the rate and cfg's terms, the math flags), wherever
the replay is the eager work: x-space, no trajectory, no Langevin noise (a
replayed draw is not the generator's), a Python number for the rate, and
nothing tracing (``utils/graphs.py::capturable``). Elsewhere, the CPU
among it, the steps run eagerly.

Latent-space refinement (``space='z'``, DGflow) drifts z instead and emits
G(z_K):

    z_{k+1} = z_k - rate * grad_z l(D(G(z_k))),

with the same clipping, noise, stop score and a proximal pull toward z_0;
each step is one autograd graph through G and D, both in eval mode.
``make_refine_z_fn`` refines from a given z in either space, and
``make_draw_refine_fn`` draws z (and, for a conditional pair, labels unless
the caller gives them) first; ``refine_samples`` is
the one-shot call of ``make_refine_fn``.

Under a profiler (``utils/profiling.py``) each batch records its spans:
``cgs.refine.draw`` (z, labels, G's forward), ``cgs.refine.prepare`` (what
a launch needs of D alone: the BN fold, the kernels' weight packing) and
``cgs.refine.steps`` (the K steps: the kernel's launch, the autograd
loop or its graph's replay, which counts one ``refine_graph_replays``).

Data parallelism (``group``; JAX ``refine.py:173-236`` constrains z to the
mesh's data axis): z is drawn whole, each rank refines its slice (through
the kernels where their gates hold) and the refined batch and its logits
are gathered whole on every rank. Langevin noise is drawn whole and sliced
as well, so every draw advances the generator as in one process.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from collaborative_gan_sampling_torch.config import RefineConfig
from collaborative_gan_sampling_torch.models import GANBundle
from collaborative_gan_sampling_torch.ops.conv_refine import (
    fused_refine_conv28,
    fused_refine_conv28_bf16,
    supports_conv_refine_kernel,
)
from collaborative_gan_sampling_torch.ops.conv_refine_ref import fold_dcgan_d
from collaborative_gan_sampling_torch.ops.refine_mlp import (
    fused_refine_mlp,
    mlp_layers,
    supports_mlp_refine_kernel,
)
from collaborative_gan_sampling_torch.parallel.mesh import (
    run_sharded,
    shard_batch,
    world_size,
)
from collaborative_gan_sampling_torch.utils.graphs import (
    ModuleGraph,
    cached,
    capturable,
)
from collaborative_gan_sampling_torch.utils.profiling import count, span

OBJECTIVES = ("ns", "kl", "saturating")
_GRAPH_DEVICES = ("cuda",)  # where an autograd refinement replays as a graph


def refine_loss_per_sample(logits: torch.Tensor,
                           objective: str = "ns") -> torch.Tensor:
    """ns: softplus(-d); kl: -d; saturating: -softplus(d)."""
    if objective == "ns":
        return F.softplus(-logits)
    if objective == "kl":
        return -logits
    if objective == "saturating":
        return -F.softplus(logits)
    raise ValueError(f"unknown refine objective {objective!r}; "
                     f"have {OBJECTIVES}")


def _clip_per_sample(g: torch.Tensor, max_norm: float) -> torch.Tensor:
    """Clip each sample's gradient to ``max_norm`` (L2 over non-batch axes)."""
    axes = tuple(range(1, g.ndim))
    norm = torch.sqrt(torch.sum(g * g, dim=axes, keepdim=True) + 1e-12)
    return g * torch.clamp_max(max_norm / norm, 1.0)


def _freeze_stopped(x_new: torch.Tensor, x: torch.Tensor,
                    logits: torch.Tensor, stop_score: float) -> torch.Tensor:
    """Keep x for samples that D scores >= stop_score at x."""
    active = torch.sigmoid(logits) < stop_score
    return torch.where(active.reshape(active.shape + (1,) * (x.ndim - 1)),
                       x_new, x)


def _normal_like(x: torch.Tensor, generator) -> torch.Tensor:
    """N(0, I) of x's shape from ``generator``: a ``torch.Generator`` (or
    None, the global one), or a function of x that draws them itself (the
    seeded serving round's ``utils/prng.py::PhiloxNormals``)."""
    if callable(generator):
        return generator(x)
    return torch.randn(x.shape, generator=generator, device=x.device,
                       dtype=x.dtype)


def _descend(grad_fn: Callable, v0: torch.Tensor, cfg: RefineConfig,
             generator: torch.Generator | None, rate,
             trajectory: list | None = None) -> torch.Tensor:
    """K steps v <- v - rate * g from v0 (x or z), with ``grad_fn(v) ->
    (g, logits at v)`` and cfg's proximal pull, clipping, noise and stop
    score; each iterate is appended to ``trajectory`` where given."""
    v = v0 = v0.detach()
    for _ in range(cfg.steps):
        g, logits = grad_fn(v)
        if cfg.proximal > 0:
            g = g + cfg.proximal * (v - v0)
        if cfg.clip_norm > 0:
            g = _clip_per_sample(g, cfg.clip_norm)
        v_new = v - rate * g
        if cfg.noise > 0:
            v_new = v_new + (2.0 * rate * cfg.noise) ** 0.5 * _normal_like(
                v, generator)
        if cfg.stop_score > 0:
            v_new = _freeze_stopped(v_new, v, logits, cfg.stop_score)
        v = v_new
        if trajectory is not None:
            trajectory.append(v)
    return v


def _loss_grad(forward: Callable, objective: str) -> Callable:
    """``grad_fn(v) -> (grad_v sum_i l(logit_i), logits)`` of a forward
    ``v -> logits``."""
    def grad_fn(v):
        with torch.enable_grad():
            vg = v.detach().requires_grad_(True)
            logits = forward(vg)
            loss = refine_loss_per_sample(logits, objective).sum()
            (g,) = torch.autograd.grad(loss, vg)
        return g, logits.detach()

    return grad_fn


def _autograd_refine(bundle: GANBundle, cfg: RefineConfig,
                     generator: torch.Generator | None, rate,
                     trajectory: list | None = None) -> Callable:
    """``steps(d, x0, labels) -> (x_K, D(x_K))``: the K autograd steps
    under D in eval mode, then D's final pass without gradients."""
    def steps(d, x0, labels):
        x = _descend(_loss_grad(lambda x: bundle.discriminate(
            d, x, labels, train=False), cfg.objective), x0, cfg,
            generator, rate, trajectory)
        with torch.no_grad():
            return x, bundle.discriminate(d, x, labels, train=False)

    return steps


def _graph_applies(x0: torch.Tensor, cfg: RefineConfig, rate,
                   return_trajectory: bool) -> bool:
    """Whether a graph's replay is the eager autograd refinement's work."""
    return (x0.device.type in _GRAPH_DEVICES and cfg.space == "x"
            and not return_trajectory and cfg.noise == 0
            and isinstance(rate, (int, float)) and not isinstance(rate, bool)
            and capturable(x0))


def _math_flags() -> tuple:
    """The global settings that choose the card's kernels and their
    precision."""
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark,
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction,
            torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction,
            torch.are_deterministic_algorithms_enabled())


def _layout(t: torch.Tensor | None) -> tuple | None:
    return None if t is None else (t.shape, t.stride(), t.dtype, t.device)


def _graph_key(bundle: GANBundle, d, x0: torch.Tensor,
               labels: torch.Tensor | None, cfg: RefineConfig,
               rate) -> tuple:
    """All that an autograd refinement's graph depends on but the values of
    D's tensors, x0 and the labels: D's modules by class and forward (a
    forward replaced on a class is other work), the layouts, cfg's terms
    and the math flags."""
    return (bundle,
            tuple((type(m), type(m).forward) for m in d.modules()),
            tuple(_layout(p) + (p.requires_grad,) for p in d.parameters()),
            tuple(_layout(b) for b in d.buffers()),
            _layout(x0), _layout(labels), cfg.steps, float(rate),
            cfg.objective, cfg.clip_norm, cfg.stop_score, cfg.proximal,
            _math_flags())


def make_refine_fn(bundle: GANBundle, cfg: RefineConfig,
                   return_trajectory: bool = False) -> Callable:
    """Build ``refine(d, x0, labels=None, generator=None, rate=None)
    -> (x_K, aux)``; aux = {'logits': D(x_K), 'traj': (K+1, B, ...) if
    requested}. ``rate`` (a float or a 0-d tensor) overrides cfg.rate."""
    bf16 = bundle.cfg.compute_dtype == "bfloat16"

    def refine(d, x0: torch.Tensor, labels: torch.Tensor | None = None,
               generator: torch.Generator | None = None, rate=None):
        rate = cfg.rate if rate is None else rate
        if supports_conv_refine_kernel(bundle, cfg, labels,
                                       return_trajectory):
            fused = fused_refine_conv28_bf16 if bf16 else fused_refine_conv28
            with span("cgs.refine.prepare"):
                folded = fold_dcgan_d(d)
            with span("cgs.refine.steps"):
                x_k, logits = fused(folded, x0, cfg.steps, rate)
            return x_k, {"logits": logits}
        if supports_mlp_refine_kernel(bundle, cfg, labels,
                                      return_trajectory):
            with span("cgs.refine.prepare"):
                layers = mlp_layers(d)
            with span("cgs.refine.steps"):
                x_k, logits = fused_refine_mlp(layers, x0, cfg.steps, rate)
            return x_k, {"logits": logits}
        traj = [x0.detach()] if return_trajectory else None
        with span("cgs.refine.steps"):
            if _graph_applies(x0, cfg, rate, return_trajectory):
                graph = cached(
                    _graph_key(bundle, d, x0, labels, cfg, rate),
                    lambda: ModuleGraph(_autograd_refine(
                        bundle, cfg, None, rate), d, x0, labels))
                d.train(False)  # as the eager forwards leave it
                x, logits = graph(d, x0, labels)
                count("refine_graph_replays")
            else:
                x, logits = _autograd_refine(bundle, cfg, generator, rate,
                                             traj)(d, x0, labels)
        aux = {"logits": logits}
        if return_trajectory:
            aux["traj"] = torch.stack(traj)
        return x, aux

    return refine


def _sharded_noise(generator, group) -> Callable:
    """A noise source for the rank's slice: N(0, I) drawn for the whole
    batch from ``generator`` (see ``_normal_like``), the rank's slice
    kept."""
    def draw(x):
        full = x.new_empty((x.shape[0] * world_size(group),) + x.shape[1:])
        return shard_batch(group, _normal_like(full, generator))

    return draw


def make_refine_z_fn(bundle: GANBundle, cfg: RefineConfig,
                     group=None) -> Callable:
    """Build ``refine_z(g, d, z, labels=None, generator=None, rate=None)
    -> (x, logits)``: K refinement steps of x0 = G(z) (``space='x'``) or
    of z, emitting G(z_K) (``space='z'``); ``generator`` serves the
    Langevin noise only. With a ``group``, z (and labels) are the whole
    batch, each rank refines its slice and (x, logits) come back whole."""
    if cfg.space not in ("x", "z"):
        raise ValueError(f"refine.space must be 'x' or 'z', got "
                         f"{cfg.space!r}")
    refine = make_refine_fn(bundle, cfg)

    def refine_z(g, d, z: torch.Tensor, labels: torch.Tensor | None = None,
                 generator=None, rate=None):
        if group is not None and cfg.noise > 0:
            generator = _sharded_noise(generator, group)
        return run_sharded(group, lambda z_, lab: refine_local(
            g, d, z_, lab, generator, rate), z, labels)

    def refine_local(g, d, z, labels, generator, rate):
        if cfg.space == "z":
            rate = cfg.rate if rate is None else rate

            def forward(z):
                x = bundle.generate(g, z, labels, train=False)
                return bundle.discriminate(d, x, labels, train=False)

            with span("cgs.refine.steps"):
                z = _descend(_loss_grad(forward, cfg.objective), z, cfg,
                             generator, rate)
                with torch.no_grad():
                    x = bundle.generate(g, z, labels, train=False)
                    return x, bundle.discriminate(d, x, labels, train=False)
        with span("cgs.refine.draw"), torch.no_grad():
            x0 = bundle.generate(g, z, labels, train=False)
        x, aux = refine(d, x0, labels, generator=generator, rate=rate)
        return x, aux["logits"]

    return refine_z


def make_draw_refine_fn(bundle: GANBundle, cfg: RefineConfig,
                        group=None) -> Callable:
    """Build ``draw_refine(g, d, generator, n, labels=None, rate=None)
    -> (x, labels, logits)``: z ~ N(0, I) (then labels, for a conditional
    pair given none), and ``make_refine_z_fn``'s refinement of z (over
    ``group``'s ranks, the whole batch back on each)."""
    refine_z = make_refine_z_fn(bundle, cfg, group)

    def draw_refine(g, d, generator: torch.Generator | None, n: int,
                    labels: torch.Tensor | None = None, rate=None):
        with span("cgs.refine.draw"):
            z = bundle.sample_z(generator, n)
            if labels is None:
                labels = bundle.sample_labels(generator, n)
        x, logits = refine_z(g, d, z, labels, generator, rate)
        return x, labels, logits

    return draw_refine


def refine_samples(bundle: GANBundle, d, x0: torch.Tensor, cfg: RefineConfig,
                   labels: torch.Tensor | None = None,
                   return_trajectory: bool = False):
    """One-shot ``make_refine_fn(bundle, cfg, return_trajectory)(d, x0,
    labels)``: (x_K, aux), through the kernels where their gates hold.
    Counterpart of the JAX package's ``refine_samples``; held to it in
    float32 within 1e-5 (``tests/test_torch_benchmark_cli.py``)."""
    return make_refine_fn(bundle, cfg, return_trajectory)(d, x0, labels)
