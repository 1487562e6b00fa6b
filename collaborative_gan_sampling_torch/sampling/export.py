"""Ahead-of-time serving export: the sampler as a self-contained artifact.

Counterpart of ``collaborative_gan_sampling_tpu/sampling/export.py``. The
serving round

    seed -> z (, labels) -> G -> [K-step refinement] -> D logits -> [DRS accept]

is traced with the trained weights, the DRS calibration (burn-in logit max
M) and, for collab, the shaped D baked in, and written as one
``torch.export`` file (``torch.export.save``) plus a JSON sidecar with the
shapes and the method, so that a server can check it before loading.
``load_sampler`` runs it with no model code: it imports the op registry
(``ops/registry.py``), whose ``cgs::`` ops are the hand kernels' nodes in
the program, and nothing of ``models/``, ``training/`` or the pipeline.

Where JAX's artifact takes a ``uint32[2]`` key, this one takes an
``int64[1]`` seed: the round's draws come from it by Philox on tensor ops
(``ServingSampler.round_seeded``). An artifact serves the one device type
it was traced on (``device`` in the sidecar), where JAX's lowers for
several platforms at once.

The round is traced at the aten level first (``make_fx`` on real tensors,
which runs it once), then exported from that graph: the refinement that no
kernel serves takes its gradient with ``torch.autograd.grad``, which
``torch.export``'s own tracer does not take (nor ``torch.func.grad`` over
a module's ``nn.Linear``), while ``make_fx`` records the backward's aten
ops as it runs them. The hand kernels stay single ``cgs::`` nodes.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Callable

import torch

_META_SUFFIX = ".json"


def _meta_path(path: str) -> str:
    return path + _META_SUFFIX


class _Program(torch.nn.Module):
    """The traced round as the module that ``torch.export`` takes."""

    def __init__(self, traced: torch.nn.Module):
        super().__init__()
        self.traced = traced

    def forward(self, seed):
        return self.traced(seed)


def _views_as_reshapes(traced: torch.fx.GraphModule) -> torch.fx.GraphModule:
    """``traced`` with each ``aten.view`` node made an ``aten.reshape``.

    ``make_fx`` on real tensors records a ``reshape`` as ``aten.view``
    wherever the real strides allow one. ``torch.export`` traces that graph
    again on fake tensors, whose strides can differ from the real ones: on
    the card, the export of a round refined by autograd failed at D's NHWC
    flatten, a view on the real strides of D's features and none on their
    fake strides (a contiguous NCHW tensor, permuted). A reshape is a view
    where the strides allow it and a copy elsewhere: the same values either
    way. No op of the round writes in place through a view."""
    for node in traced.graph.nodes:
        if node.target is torch.ops.aten.view.default:
            node.target = torch.ops.aten.reshape.default
    traced.recompile()
    return traced


def _frozen(module: torch.nn.Module) -> torch.nn.Module:
    """An eval-mode copy whose parameters need no gradient: the program
    holds them as weights, not as leaves of a graph."""
    module = copy.deepcopy(module).eval()
    for p in module.parameters():
        p.requires_grad_(False)
    return module


def export_sampler(sampler, g: torch.nn.Module, d: torch.nn.Module,
                   generator: torch.Generator | None, path: str) -> dict:
    """Serialize one serving round of ``sampler`` (a ``ServingSampler``)
    under (g, d) to ``path``; returns the sidecar meta dict.

    M is calibrated once from ``generator`` and baked in, with the weights
    of g and d (the shaped D, for collab). The artifact's callable takes one
    int64 seed and returns ``(samples, labels or None, accept_mask,
    logits)`` for ``num_batches * batch_size`` candidates, exactly what
    ``sampler.round_seeded`` returns for the same seed. The file is written
    atomically (``.tmp``, then ``os.replace``). A sampler with a process
    group is refused, as JAX refuses a mesh (``export.py:58-62``): the
    artifact is one process's program."""
    from torch.fx.experimental.proxy_tensor import make_fx

    from collaborative_gan_sampling_torch.utils.profiling import suspended

    if sampler.group is not None:
        raise ValueError(
            "export_sampler serialises one process's program; build the "
            "ServingSampler with group=None (the export keeps every "
            "batch of the round on one device)")

    device = sampler.bundle.device
    g, d = _frozen(g), _frozen(d)
    m = sampler.calibrate(g, d, generator).detach()

    def serve_round(seed):
        return sampler.round_seeded(g, d, m, seed)

    seed = torch.zeros(1, dtype=torch.int64, device=device)
    # Under a recording profiler a span's record_function would be traced
    # as profiler nodes of the program.
    with suspended():
        traced = _views_as_reshapes(
            make_fx(serve_round, tracing_mode="real")(seed))
    exported = torch.export.export(_Program(traced), (seed,))
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        torch.export.save(exported, fh)
    os.replace(tmp, path)

    cfg = sampler.cfg
    meta = {
        "format": "torch.export",
        "method": sampler.method,
        "device": device.type,
        "batch_size": cfg.batch_size,
        "num_batches": cfg.num_batches,
        "candidates_per_round": cfg.batch_size * cfg.num_batches,
        "data_shape": list(sampler.bundle.data_shape),
        "conditional": sampler.bundle.conditional,
        "class_id": sampler.class_id,
        "refine_steps": cfg.steps if sampler._refine_on else 0,
        "rejection": sampler._reject_on,
        "key_dtype": "int64[1] seed",
        "bytes": os.path.getsize(path),
    }
    with open(_meta_path(path), "w") as fh:
        json.dump(meta, fh, indent=2, sort_keys=True)
    return meta


def load_sampler(path: str) -> tuple[Callable, dict]:
    """(callable, meta) from an ``export_sampler`` artifact.

    The callable takes an int64 seed (an int or a tensor of one element)
    and returns ``(samples, labels or None, accept_mask, logits)`` on the
    artifact's device. No model code, config or checkpoint is needed: the
    file is self-contained but for the ``cgs::`` ops, which this imports."""
    from collaborative_gan_sampling_torch.ops import registry  # noqa: F401

    program = torch.export.load(path).module()
    meta = {}
    if os.path.exists(_meta_path(path)):
        with open(_meta_path(path)) as fh:
            meta = json.load(fh)
    device = torch.device(meta.get("device", "cpu"))

    def serve_round(seed):
        seed = torch.as_tensor(seed, dtype=torch.int64).reshape(1)
        return tuple(program(seed.to(device)))

    return serve_round, meta
