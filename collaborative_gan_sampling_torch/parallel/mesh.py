"""Data parallelism over a ``torch.distributed`` process group, one process
per card.

Counterpart of ``collaborative_gan_sampling_tpu/parallel/mesh.py``. The JAX
package shards the batch axis over a 1-D device mesh and lets GSPMD insert
the collectives, so a sharded program computes what the one-device program
computes: BatchNorm moments, the DRS max and percentile, losses and
gradients are all taken over the global batch. In one process per card
nothing does that for us, so each of these is made global here, by hand:

* ``shard_batch``: the rank's slice of a global-batch tensor (the
  counterpart of ``shard_batch`` / ``constrain_batch``): every rank draws
  the whole batch from the shared seeded stream and keeps its slice, so
  the streams advance as in one process;
* ``all_gather``: the slices concatenated in rank order, on every rank;
* ``all_reduce_sum`` / ``all_reduce_mean``: autograd-aware (the backward of
  a sum all-reduce is a sum all-reduce, so it is differentiable twice, as
  R1's double backward needs);
* ``sum_gradients``: the sum all-reduce of a list of gradients (each rank's
  loss is scaled by 1 / world size, so the sum is the global mean's);
* ``replicate``: rank 0's parameters and buffers broadcast to every rank
  (the counterpart of ``replicate``);
* ``run_sharded``: a function of batch-leading tensors run on the rank's
  slices, its outputs gathered whole.

``group=None`` stands for one process: every helper is then the identity.

Divergence from JAX, on purpose: ``make_mesh(n)`` takes the first ``n`` of
the visible devices. A process group is not a device list to take a prefix
of, so ``make_group`` accepts ``data_axis`` -1 (all processes) or the world
size, and raises on anything else.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch
import torch.distributed as dist


def world_size(group) -> int:
    """The number of processes in ``group``; 1 for None."""
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    """This process's rank in ``group``; 0 for None."""
    return 0 if group is None else dist.get_rank(group)


def check_data_axis(data_axis: int, n: int) -> None:
    """``mesh.data_axis`` must be -1 (every process) or ``n``, the world
    size."""
    if data_axis not in (-1, n):
        raise ValueError(
            f"mesh.data_axis={data_axis} with {n} processes: the data axis "
            "spans every process of the group (one per card), so it must be "
            f"-1 or the world size {n}; processes are not a device list to "
            "take a prefix of")


def make_group(data_axis: int = -1):
    """The data-parallel group, every process of the initialised default
    group (``parallel/multihost.py``): the counterpart of ``make_mesh``."""
    if not dist.is_initialized():
        raise RuntimeError("make_group needs an initialised process group "
                           "(parallel/multihost.py)")
    check_data_axis(data_axis, dist.get_world_size())
    return dist.group.WORLD


def check_divisible(sizes: dict[str, int], n: int) -> None:
    """Every batch size in ``sizes`` (name -> size) must divide by the
    ``n``-process group (the JAX package's ``Experiment`` check and
    wording)."""
    for name, bs in sizes.items():
        if bs % n:
            raise ValueError(
                f"{name}={bs} is not divisible by the {n}-device data mesh; "
                "batch-axis sharding needs equal per-device shards")


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of m that is >= n."""
    return ((n + m - 1) // m) * m


def shard_batch(group, x: torch.Tensor | None) -> torch.Tensor | None:
    """The rank's contiguous slice of ``x``'s leading axis (None passes)."""
    if group is None or x is None:
        return x
    n = world_size(group)
    if x.shape[0] % n:
        raise ValueError(f"a batch of {x.shape[0]} does not split over "
                         f"{n} processes")
    b = x.shape[0] // n
    r = rank(group)
    return x[r * b:(r + 1) * b]


def all_gather(group, x: torch.Tensor | None) -> torch.Tensor | None:
    """Every rank's ``x`` concatenated along the leading axis in rank order,
    on every rank (None passes). Half-width floats travel as float32, which
    holds them exactly (``gloo`` takes no bfloat16)."""
    if group is None or x is None:
        return x
    wire = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x
    wire = wire.contiguous()
    parts = [torch.empty_like(wire) for _ in range(world_size(group))]
    dist.all_gather(parts, wire, group=group)
    return torch.cat(parts).to(x.dtype)


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group, with the sum all-reduce as its own backward (so
    a double backward goes through it too). Not ``torch.distributed.nn``'s,
    whose status differs between torch releases."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum(group, x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the group, on every rank; differentiable."""
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


def all_reduce_mean(group, x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the group, on every rank; differentiable.
    Over equal local batches, the mean of the local means is the global
    mean."""
    if group is None:
        return x
    return all_reduce_sum(group, x) / world_size(group)


def sum_gradients(group, grads: Iterable[torch.Tensor | None]
                  ) -> list[torch.Tensor | None]:
    """Each gradient summed over the group (in one flat all-reduce per
    dtype). Each rank's loss carries the factor 1 / world size, so the sum
    is the gradient of the global mean."""
    grads = list(grads)
    if group is None:
        return grads
    out = list(grads)
    by_dtype: dict[torch.dtype, list[int]] = {}
    for i, g in enumerate(grads):
        if g is not None:
            by_dtype.setdefault(g.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([grads[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        off = 0
        for i in idx:
            n = grads[i].numel()
            out[i] = flat[off:off + n].view_as(grads[i])
            off += n
    return out


def replicate(group, modules: Iterable[torch.nn.Module | None]) -> None:
    """Broadcast rank 0's parameters and buffers of each module (None
    skipped) to every rank, in place."""
    if group is None:
        return
    src = dist.get_global_rank(group, 0)
    with torch.no_grad():
        for m in modules:
            if m is None:
                continue
            for t in list(m.parameters()) + list(m.buffers()):
                dist.broadcast(t.data, src=src, group=group)


def barrier(group) -> None:
    """Wait for every rank of the group (nothing for None)."""
    if group is not None:
        dist.barrier(group=group)


def run_sharded(group, fn: Callable, *batch: torch.Tensor | None):
    """``fn`` on the rank's slice of each batch-leading argument (None
    passes), each output (a tensor, or a tuple of tensors or None) gathered
    whole on every rank; ``fn(*batch)`` itself for None."""
    if group is None:
        return fn(*batch)
    out = fn(*(shard_batch(group, t) for t in batch))
    if isinstance(out, tuple):
        return tuple(all_gather(group, o) for o in out)
    return all_gather(group, out)
