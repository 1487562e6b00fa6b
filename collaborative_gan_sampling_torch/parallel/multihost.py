"""Multi-process bootstrap: ``torch.distributed.init_process_group`` from the
launcher's environment.

Counterpart of ``collaborative_gan_sampling_tpu/parallel/multihost.py``.
Opt-in through the environment and a no-op in a single process:

* torchrun (``torch.distributed.run``): ``WORLD_SIZE`` > 1 with
  ``MASTER_ADDR`` / ``MASTER_PORT``, ``RANK`` and ``LOCAL_RANK``; this
  takes the place of JAX's ``JAX_COORDINATOR_ADDRESS``;
* a Slurm multi-task step or an Open MPI launch, detected by the JAX
  package's own conservative rules (``_cluster_scheduler_detected``), with
  their rank and size variables mapped onto ``init_process_group``; the
  rendezvous address still comes from ``MASTER_ADDR`` / ``MASTER_PORT``.

JAX also detects a TPU multislice (``MEGASCALE_*``) and a Cloud TPU pod
(``TPU_WORKER_HOSTNAMES``); those markers have no counterpart here and are
not read.

Backend: ``nccl`` for the card, with ``torch.cuda.set_device`` on the local
rank (modulo the visible cards); ``gloo`` for the CPU, and for the card when
a host runs more processes than it has cards (torchrun's
``LOCAL_WORLD_SIZE``, Open MPI's ``OMPI_COMM_WORLD_LOCAL_SIZE``): NCCL
refuses two ranks on one device, and ``gloo`` carries CUDA tensors through
the host.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def _int_env(name: str, default: int = 1) -> int:
    return int(os.environ.get(name, "") or default)


def _cluster_scheduler_detected() -> bool:
    """True when a multi-process scheduler environment is present. Strictly
    conservative: single-process allocations return False. A Slurm batch
    script of an ``--ntasks=N`` allocation inherits ``SLURM_NTASKS=N`` but
    runs one task, so only a multi-task step (``SLURM_STEP_NUM_TASKS`` > 1
    with ``SLURM_PROCID``) counts."""
    if (_int_env("SLURM_NTASKS") > 1
            and _int_env("SLURM_STEP_NUM_TASKS") > 1
            and os.environ.get("SLURM_PROCID") is not None):
        return True
    return _int_env("OMPI_COMM_WORLD_SIZE") > 1


def _topology() -> tuple[int, int, int, int] | None:
    """(rank, world size, local rank, processes on this host) from the
    environment, or None in a single process. Slurm names no per-host
    count for a step in one variable: 1 is taken."""
    if _int_env("WORLD_SIZE") > 1 and os.environ.get("MASTER_ADDR") \
            and os.environ.get("MASTER_PORT"):
        return (_int_env("RANK", 0), _int_env("WORLD_SIZE"),
                _int_env("LOCAL_RANK", 0), _int_env("LOCAL_WORLD_SIZE"))
    if not _cluster_scheduler_detected():
        return None
    if _int_env("OMPI_COMM_WORLD_SIZE") > 1:
        return (_int_env("OMPI_COMM_WORLD_RANK", 0),
                _int_env("OMPI_COMM_WORLD_SIZE"),
                _int_env("OMPI_COMM_WORLD_LOCAL_RANK", 0),
                _int_env("OMPI_COMM_WORLD_LOCAL_SIZE"))
    return (_int_env("SLURM_PROCID", 0), _int_env("SLURM_STEP_NUM_TASKS"),
            _int_env("SLURM_LOCALID", 0), 1)


def choose_backend(device: str | torch.device | None,
                   local_size: int) -> str:
    """``nccl`` where each process of the host has a card of its own,
    ``gloo`` on the CPU or where processes share a card."""
    on_card = torch.device("cuda" if device is None else device).type \
        == "cuda"
    if on_card and local_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def maybe_initialize_distributed(
        device: str | torch.device | None = None) -> bool:
    """Initialise the default process group iff a multi-process environment
    is configured. ``device`` is the run's device (None: the card), which
    with the processes on this host picks the backend
    (``choose_backend``). Returns True when a process group is up
    (idempotent: also when one already was), False for the single-process
    no-op; never raises where nothing is configured."""
    if dist.is_initialized():
        return True
    topo = _topology()
    if topo is None:
        return False
    rank, world, local, local_size = topo
    on_card = torch.device("cuda" if device is None else device).type \
        == "cuda"
    backend = choose_backend(device, local_size)
    if on_card:
        torch.cuda.set_device(local % max(1, torch.cuda.device_count()))
    os.environ.setdefault("MASTER_ADDR", "localhost")
    os.environ.setdefault("MASTER_PORT", "29500")
    dist.init_process_group(backend, rank=rank, world_size=world,
                            init_method="env://")
    return True


def shutdown_distributed() -> None:
    """Destroy the default process group if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()
