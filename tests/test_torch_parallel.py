"""The port's data parallelism (``parallel/``, ``--mesh``) and
``--debug-nans`` on the CPU.

* The bootstrap is a no-op in one process, and detects a Slurm step, Open
  MPI and torchrun by JAX ``parallel/multihost.py``'s rules (the TPU
  markers are not read).
* ``mesh.data_axis`` must be -1 or the world size; a batch that does not
  divide raises the JAX package's own message.
* A one-process ``gloo`` group (an all-reduce over one rank is the
  identity): the train chunk, with R1 and FusedProp, and collab are equal
  bit for bit to the runs without a group, and the all-reduce is
  differentiable twice.
* Two ``gloo`` processes under torchrun (this file is the worker): the
  toy2d and a small BatchNorm mnist train chunk within 1e-4 (losses) and
  1e-5 (parameters) of one process, and collab samples within 2e-5 with
  equal masks (JAX ``tests/test_parallel.py:64-67``, ``:110``). The biases
  of the layers that feed a BatchNorm have an exactly zero gradient: the
  rounding noise there differs between one and two processes and Adam
  scales it up to its step size, so those are held to Adam's movement
  bound and the train-mode outputs of G and D, which BatchNorm makes
  independent of them, to 1e-5.
* ``cli train --mesh`` under torchrun writes one checkpoint, from rank 0.
* ``--debug-nans`` raises at an injected NaN, naming the op; a clean run
  passes.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:  # run as a torchrun worker
    sys.path.insert(0, str(REPO))

from collaborative_gan_sampling_torch import cli  # noqa: E402
from collaborative_gan_sampling_torch.config import (  # noqa: E402
    apply_overrides,
    get_preset,
)
from collaborative_gan_sampling_torch.parallel import mesh  # noqa: E402
from collaborative_gan_sampling_torch.parallel import (  # noqa: E402
    multihost,
)
from collaborative_gan_sampling_torch.pipeline import Experiment  # noqa: E402
from collaborative_gan_sampling_torch.sampling.collab import (  # noqa: E402
    sample,
)
from collaborative_gan_sampling_torch.training.gan import (  # noqa: E402
    create_train_state,
    make_train_chunk,
)
from collaborative_gan_sampling_torch.utils.prng import (  # noqa: E402
    step_generator,
)

TOY = ["model.g_hidden=16", "model.d_hidden=16", "model.g_layers=2",
       "model.d_layers=2", "train.batch_size=16", "train.steps_per_call=3",
       "train.log_every=3", "train.ckpt_every=3", "refine.batch_size=32",
       "refine.num_batches=3", "refine.burn_in=64"]
IMG = ["model.image_size=16", "model.g_base_filters=8",
       "model.d_base_filters=8", "model.z_dim=8",
       "model.compute_dtype=float32", "train.batch_size=8",
       "train.steps_per_call=3", "train.r1_gamma=1.0",
       "refine.batch_size=8", "refine.num_batches=3", "refine.burn_in=8",
       "refine.shape_every=1"]
ENV_KEYS = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
            "MASTER_ADDR", "MASTER_PORT", "SLURM_NTASKS",
            "SLURM_STEP_NUM_TASKS", "SLURM_PROCID", "SLURM_LOCALID",
            "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK",
            "OMPI_COMM_WORLD_LOCAL_RANK", "OMPI_COMM_WORLD_LOCAL_SIZE",
            "MEGASCALE_COORDINATOR_ADDRESS", "TPU_WORKER_HOSTNAMES")


def _cfg(preset, workdir, extra=()):
    cfg = apply_overrides(get_preset(preset),
                          TOY if preset == "toy2d" else IMG)
    return apply_overrides(cfg.replace(workdir=str(workdir)), list(extra))


def _flat(module):
    return {n: p.detach().clone() for n, p in module.named_parameters()}


def _bn_fed(name: str) -> bool:
    """A bias of a layer whose output goes into a BatchNorm: G's project
    and deconv{i}, D's conv{i} for i >= 1."""
    layer, _, leaf = name.rpartition(".")
    return leaf == "bias" and (
        layer == "project"
        or (layer.startswith("deconv") and layer != "deconv_out")
        or (layer.startswith("conv") and layer != "conv0"))


def _compare_chunk(preset, workdir, group):
    """One train chunk with and without ``group`` from the same seed, then
    collab from the one-process state with and without it: max
    differences."""
    cfg = _cfg(preset, workdir)
    exp = Experiment(cfg, echo_metrics=False, device="cpu")
    states, metrics = [], []
    for g in (None, group):
        state = create_train_state(exp.bundle, cfg.train, cfg.seed)
        state, m = make_train_chunk(exp.bundle, cfg.train, exp.data_fn,
                                    cfg.seed, group=g)(state)
        states.append(state)
        metrics.append({k: float(v) for k, v in m.items()})
    one, two = states
    out = {"loss": max(abs(metrics[0][k] - metrics[1][k])
                       for k in metrics[0]),
           "params": 0.0, "bn_fed": 0.0}
    for a, b in ((one.g, two.g), (one.d, two.d)):
        for (name, p), q in zip(_flat(a).items(), _flat(b).values()):
            key = "bn_fed" if _bn_fed(name) else "params"
            out[key] = max(out[key], float((p - q).abs().max()))
    out["running_var"] = max(
        [0.0] + [float((a.running_var - b.running_var).abs().max())
                 for m1, m2 in ((one.g, two.g), (one.d, two.d))
                 for a, b in zip(m1.modules(), m2.modules())
                 if hasattr(a, "running_var")])
    gen = torch.Generator().manual_seed(7)
    z = exp.bundle.sample_z(gen, cfg.train.batch_size)
    x = exp.data_fn(gen, cfg.train.batch_size)[0]
    with torch.no_grad():
        out["train_outputs"] = max(
            float((exp.bundle.generate(one.g, z, train=True)
                   - exp.bundle.generate(two.g, z, train=True)).abs().max()),
            float((exp.bundle.discriminate(one.d, x, train=True)
                   - exp.bundle.discriminate(two.d, x, train=True))
                  .abs().max()))
    out["lr_steps"] = max(cfg.train.d_lr, cfg.train.g_lr) * \
        cfg.train.steps_per_call
    res = [sample(exp.bundle, one.g, one.d, cfg.refine,
                  step_generator(cfg.seed, 0, "eval", "cpu"),
                  method="collab", data_fn=exp.data_fn, group=g)
           for g in (None, group)]
    out["samples"] = float((res[0].samples - res[1].samples).abs().max())
    out["masks_equal"] = bool(torch.equal(res[0].accepted, res[1].accepted))
    out["n"] = int(res[1].samples.shape[0])
    return out


def _worker(out_path: str, workdir: str) -> None:
    """torchrun entry: both presets' chunk and collab in a 2-process group,
    and the Experiment's divisibility check; rank 0 writes the JSON."""
    torch.set_num_threads(1)
    assert multihost.maybe_initialize_distributed("cpu")
    assert multihost.maybe_initialize_distributed("cpu")  # idempotent
    group = mesh.make_group(-1)
    results = {p: _compare_chunk(p, workdir, group)
               for p in ("toy2d", "mnist")}
    exp = Experiment(_cfg("toy2d", workdir), use_mesh=True,
                     echo_metrics=False, device="cpu")
    results["group_size"] = mesh.world_size(exp.group)
    try:
        Experiment(_cfg("toy2d", workdir, ["train.batch_size=15"]),
                   use_mesh=True, echo_metrics=False, device="cpu")
    except ValueError as e:
        results["divisible_error"] = str(e)
    if dist.get_rank() == 0:
        with open(out_path, "w") as fh:
            json.dump(results, fh)
    multihost.shutdown_distributed()


def _torchrun(args, cwd, timeout=300):
    env = {k: v for k, v in os.environ.items() if k not in ENV_KEYS}
    env["PYTHONPATH"] = str(REPO)
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=timeout)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    out = tmp / "out.json"
    proc = _torchrun([__file__, "worker", str(out), str(tmp / "wd")], tmp)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("preset", ["toy2d", "mnist"])
def test_two_ranks_train_chunk_matches_one_process(two_ranks, preset):
    r = two_ranks[preset]
    assert r["loss"] < 1e-4
    assert r["params"] < 1e-5
    assert r["running_var"] < 1e-5
    assert r["train_outputs"] < 1e-5
    # Adam moves a parameter by at most about its lr a step, in each run.
    assert r["bn_fed"] < 4 * r["lr_steps"]


@pytest.mark.parametrize("preset", ["toy2d", "mnist"])
def test_two_ranks_collab_matches_one_process(two_ranks, preset):
    r = two_ranks[preset]
    assert r["samples"] < 2e-5
    assert r["masks_equal"]
    assert r["n"] == (96 if preset == "toy2d" else 24)


def test_two_ranks_experiment_group_and_divisibility(two_ranks):
    assert two_ranks["group_size"] == 2
    assert two_ranks["divisible_error"] == (
        "train.batch_size=15 is not divisible by the 2-device data mesh; "
        "batch-axis sharding needs equal per-device shards")


def test_cli_train_mesh_writes_one_checkpoint(tmp_path):
    wd = tmp_path / "wd"
    args = ["-m", "collaborative_gan_sampling_torch.cli", "train", "--mesh",
            "--config", "toy2d", "--device", "cpu", "--workdir", str(wd),
            *TOY, "train.niters=6"]
    proc = _torchrun(args, tmp_path)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = [json.loads(line) for line in proc.stdout.splitlines()
             if line.startswith("{")]
    assert lines == [{"trained_steps": 6, "workdir": str(wd)}]  # rank 0
    assert sorted(os.listdir(wd / "ckpts")) == [
        "ckpt_00000003.msgpack", "ckpt_00000006.msgpack", "config.json"]
    with open(wd / "train.jsonl") as fh:
        assert [json.loads(line)["step"] for line in fh] == [3, 6]


# -- one process -------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def one_rank_group():
    """A ``gloo`` group of this process alone."""
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    yield dist.group.WORLD
    dist.destroy_process_group()


def test_bootstrap_is_a_noop_in_one_process(monkeypatch):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    assert not multihost.maybe_initialize_distributed("cpu")
    assert not dist.is_initialized()
    assert multihost._topology() is None


@pytest.mark.parametrize("env,want", [
    ({}, None),
    ({"SLURM_NTASKS": "4", "SLURM_PROCID": "0"}, None),  # batch script
    ({"SLURM_NTASKS": "4", "SLURM_STEP_NUM_TASKS": "4", "SLURM_PROCID": "2",
      "SLURM_LOCALID": "1"}, (2, 4, 1, 1)),
    ({"OMPI_COMM_WORLD_SIZE": "1"}, None),
    ({"OMPI_COMM_WORLD_SIZE": "3", "OMPI_COMM_WORLD_RANK": "1",
      "OMPI_COMM_WORLD_LOCAL_RANK": "1", "OMPI_COMM_WORLD_LOCAL_SIZE": "3"},
     (1, 3, 1, 3)),
    ({"WORLD_SIZE": "2", "RANK": "1", "LOCAL_RANK": "1",
      "LOCAL_WORLD_SIZE": "2", "MASTER_ADDR": "localhost",
      "MASTER_PORT": "29500"}, (1, 2, 1, 2)),
    ({"WORLD_SIZE": "2", "RANK": "1"}, None),  # no rendezvous address
    ({"MEGASCALE_COORDINATOR_ADDRESS": "x:1"}, None),  # TPU markers: not read
    ({"TPU_WORKER_HOSTNAMES": "a,b"}, None),
], ids=["none", "slurm-batch", "slurm-step", "ompi-1", "ompi-3", "torchrun",
        "torchrun-no-addr", "megascale", "tpu-pod"])
def test_scheduler_detection(monkeypatch, env, want):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert multihost._topology() == want


@pytest.mark.parametrize("device,local_size,cards,want", [
    ("cpu", 2, 0, "gloo"), ("cpu", 1, 4, "gloo"), (None, 1, 1, "nccl"),
    ("cuda", 4, 4, "nccl"), ("cuda", 2, 1, "gloo"), (None, 8, 4, "gloo"),
], ids=["cpu", "cpu-with-cards", "one-card", "four-cards", "two-on-one",
        "more-than-cards"])
def test_backend_follows_the_cards(monkeypatch, device, local_size, cards,
                                   want):
    """NCCL where every process of the host has a card of its own, gloo on
    the CPU or where processes share a card."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert multihost.choose_backend(device, local_size) == want


def test_data_axis_rule():
    mesh.check_data_axis(-1, 2)
    mesh.check_data_axis(2, 2)
    for bad in (0, 1, 3):
        with pytest.raises(ValueError, match="not a device list"):
            mesh.check_data_axis(bad, 2)


def test_divisibility_message_is_jax_s():
    """The port's error for a batch that does not divide is the JAX
    package's, word for word (its mesh of 8 fake CPU devices)."""
    from collaborative_gan_sampling_tpu import config as jconfig
    from collaborative_gan_sampling_tpu.pipeline import (
        Experiment as JExperiment,
    )

    jcfg = jconfig.apply_overrides(jconfig.get_preset("toy2d"),
                                   ["train.batch_size=12"])
    with pytest.raises(ValueError) as jerr:
        JExperiment(jcfg, use_mesh=True)
    with pytest.raises(ValueError) as terr:
        mesh.check_divisible({"train.batch_size": 12}, 8)
    assert str(terr.value) == str(jerr.value)


def test_helpers_without_a_group():
    x = torch.arange(12.0).reshape(6, 2)
    assert mesh.shard_batch(None, x) is x
    assert mesh.all_gather(None, x) is x
    assert mesh.all_reduce_mean(None, x) is x
    assert mesh.run_sharded(None, lambda a: a * 2, x).equal(x * 2)
    assert mesh.pad_to_multiple(10, 4) == 12
    assert mesh.world_size(None) == 1 and mesh.rank(None) == 0


def test_all_reduce_is_differentiable_twice(one_rank_group):
    x = torch.tensor([0.5, -1.0, 2.0], requires_grad=True)
    y = mesh.all_reduce_sum(one_rank_group, x.pow(3)).sum()
    (g,) = torch.autograd.grad(y, x, create_graph=True)
    (gg,) = torch.autograd.grad(g.sum(), x)
    assert torch.equal(g, 3 * x.detach() ** 2)
    assert torch.equal(gg, 6 * x.detach())


@pytest.mark.parametrize("extra", [(), ("train.fused_prop=true",
                                        "train.g_ema_decay=0.9")],
                         ids=["r1", "fused-ema"])
def test_one_rank_group_is_bit_exact(one_rank_group, tmp_path, extra):
    cfg = _cfg("mnist", tmp_path, extra)
    exp = Experiment(cfg, echo_metrics=False, device="cpu")
    runs = []
    for g in (None, one_rank_group):
        state = create_train_state(exp.bundle, cfg.train, cfg.seed)
        state, m = make_train_chunk(exp.bundle, cfg.train, exp.data_fn,
                                    cfg.seed, group=g)(state)
        res = sample(exp.bundle, state.g, state.d, cfg.refine,
                     step_generator(cfg.seed, 0, "eval", "cpu"),
                     method="collab", data_fn=exp.data_fn, group=g)
        runs.append((state, m, res))
    (s1, m1, r1), (s2, m2, r2) = runs
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    for a, b in ((s1.g, s2.g), (s1.d, s2.d)):
        for t1, t2 in zip(a.state_dict().values(), b.state_dict().values()):
            assert torch.equal(t1, t2)
    assert torch.equal(r1.samples, r2.samples)
    assert torch.equal(r1.accepted, r2.accepted)


def test_export_refuses_a_group(one_rank_group):
    from collaborative_gan_sampling_torch.models import make_bundle
    from collaborative_gan_sampling_torch.sampling.export import (
        export_sampler,
    )
    from collaborative_gan_sampling_torch.sampling.serve import (
        ServingSampler,
    )

    cfg = _cfg("toy2d", "unused")
    bundle = make_bundle(cfg.model, "cpu")
    srv = ServingSampler(bundle, cfg.refine, method="refinement",
                         group=one_rank_group)
    with pytest.raises(ValueError, match="group=None"):
        export_sampler(srv, None, None, None, "unused.pt2")


# -- --debug-nans -------------------------------------------------------------

def test_debug_nans_names_the_op():
    from collaborative_gan_sampling_torch.utils.debug import debug_nans

    x = torch.tensor([1.0, -1.0])
    with debug_nans():
        assert torch.isinf(torch.log(x.abs() - 1.0)).all()  # inf passes
        with pytest.raises(FloatingPointError, match="aten.sqrt"):
            torch.sqrt(x)
    assert torch.isnan(torch.sqrt(x)).any()  # off outside


def test_cli_debug_nans(tmp_path, monkeypatch, capsys):
    """A clean run passes under --debug-nans; a NaN injected into D's
    forward stops the run at the op that made it."""
    from collaborative_gan_sampling_torch.models import mlp

    args = ["train", "--config", "toy2d", "--device", "cpu",
            "--debug-nans", "--workdir", str(tmp_path / "a"), *TOY,
            "train.niters=3"]
    assert cli.main(args) == 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == {
        "trained_steps": 3, "workdir": str(tmp_path / "a")}
    forward = mlp.MLPDiscriminator.forward
    monkeypatch.setattr(mlp.MLPDiscriminator, "forward",
                        lambda self, x: forward(self, x) * torch.sqrt(
                            torch.full_like(x[:, 0], -1.0)))
    args[args.index(str(tmp_path / "a"))] = str(tmp_path / "b")
    with pytest.raises(FloatingPointError, match="aten.sqrt"):
        cli.main(args)


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    _worker(sys.argv[2], sys.argv[3])
