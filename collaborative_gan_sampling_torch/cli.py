"""CLI: ``python -m collaborative_gan_sampling_torch.cli <cmd> ...``.

Counterpart of ``collaborative_gan_sampling_tpu/cli.py``:

    cli train     --config toy2d [a.b=c ...]
    cli refine    --config toy2d refine.method=refinement
    cli collab    --config toy2d          # refine + reject + shape
    cli generate  --config toy2d n=100000 out=samples.npz
    cli generate  --config imagenet64 n=4096 class=7   # one class
    cli export    --config toy2d out=sampler.pt2      # torch.export artifact
    cli teaser    --config toy2d          # trajectory figures and GIF
    cli eval      --config mnist          # sample refine.method, evaluate
    cli sweep     --config mnist sweep_steps=1,5,10,20,50
    cli tune      --config cifar10 sweep_steps=5,10 tune_rates=0.01,0.02
    cli collab    --config cifar10 --auto-tune   # tune, then sample
    cli benchmark --config toy2d          # all five methods, one table
    cli inspect   --config cifar10        # the latest checkpoint, no device
    cli profile   --config mnist          # torch.profiler trace, span summary
    cli import-tf1 --config celeba tf1=/path/to/tf1/ckpts [step=N]
    cli presets

``export`` writes the serving round as one ``torch.export`` file
(``out=``, ``class=``; ``sampling/export.py``) for the device it runs on:
``platforms=`` takes that one device type (``cuda`` or ``cpu``, as
``--device`` gives it), where the JAX CLI lowers for several platforms at
once. ``import-tf1`` converts the reference's TF1 ``tf.train.Saver``
checkpoint (a directory or a prefix) into a checkpoint of the workdir at
``step=`` (default ``train.niters``, so that the commands after it sample
the imported (G, D) without training; ``compat/tf1_import.py``). Any
config field is overridable as dotted key=value
(``config.apply_overrides``); ``data.path=`` points ``mnist`` / ``fmnist``
at idx files, ``cifar10`` at the python pickles and ``celeba`` /
``imagenet64`` at a folder of images. Commands after ``train`` but
``inspect`` and ``import-tf1`` restore the latest checkpoint of the
workdir (one that either package wrote) and resume training first if it
is behind ``train.niters``. ``refine``, ``collab`` and ``eval`` print
``Experiment.evaluate`` of their samples (FID, with KID and
precision/recall when configured, on image presets; %HQ and KL on 2D);
``sweep`` prints the refinement-depth sweep and its best K; ``tune`` the
(K, rate[, objective][, space][, stop][, prox]) grid of
``Experiment.select_hparams`` and its best cell, with the JAX CLI's keys
(``tune_rates=``, ``tune_objectives=``, ``tune_spaces=``, ``tune_stops=``,
``tune_proxs=``; K from ``sweep_steps=``). ``--auto-tune`` on ``refine``
and ``collab`` tunes (K, rate) under the method being run first.
``inspect`` reads the checkpoint alone: no dataset, no model, no device,
so it runs without a card. Everything else runs on the card unless
``--device cpu`` is given.

Each command takes only its own keys (``n=``, ``out=``, ``class=``,
``platforms=``, ``tf1=``, ``step=``, ``sweep_steps=``, ``tune_*=``); on
another command such a key raises the config's unknown-field error. The
JAX CLI consumes ``sweep_steps=`` and ``tune_*=`` on every command; the
port keeps the stricter rule.

``--mesh``: data-parallel over the processes of a launcher, one per card
(``python -m torch.distributed.run --nproc_per_node N -m
collaborative_gan_sampling_torch.cli train --mesh ...``;
``parallel/``). The process group comes up from the launcher's
environment (``parallel/multihost.py``), over ``nccl`` on the card and
``gloo`` on the CPU or where a host runs more processes than it has
cards (two processes sharing one card). Rank 0 writes the files and prints
the result. ``--debug-nans`` stops at the first op that makes a NaN
(``utils/debug.py``; every op synchronises, so for development runs
only).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from collaborative_gan_sampling_torch.config import (
    apply_overrides,
    get_preset,
    list_presets,
)
from collaborative_gan_sampling_torch.parallel.multihost import (
    maybe_initialize_distributed,
    shutdown_distributed,
)
from collaborative_gan_sampling_torch.utils.debug import debug_nans
from collaborative_gan_sampling_torch.utils.profiling import summary

# The self-guarding sampling recipe of the JAX CLI's --safe: refinement
# stops per sample at D's decision boundary, and shaping stops once D no
# longer separates real from refined.
SAFE_OVERRIDES = ["refine.stop_score=0.5", "refine.shaping_target=0.5"]
# tune's grid axes beyond (K, rate), in the cells' order: the override
# key, select_hparams' argument, the axis' name in the grid's keys, its
# best_* key in the output, and the values' type.
TUNE_AXES = (
    ("tune_objectives", "objectives", "obj", "best_objective", str),
    ("tune_spaces", "spaces", "space", "best_space", str),
    ("tune_stops", "stops", "stop", "best_stop", float),
    ("tune_proxs", "proxs", "prox", "best_proximal", float),
)


def _build_cfg(args, overrides):
    cfg = get_preset(args.config)
    if args.workdir:
        cfg = cfg.replace(workdir=args.workdir)
    if args.safe:  # before the user's overrides, so theirs win
        cfg = apply_overrides(cfg, SAFE_OVERRIDES)
    return apply_overrides(cfg, overrides)


def _inspect(cfg) -> dict:
    """The workdir's latest checkpoint: step, parameter counts, whether an
    EMA generator and a shaped D are there, and the saved config's model
    section, from paths the config gives: no Experiment, no dataset, no
    device (the JAX CLI's ``_inspect``)."""
    import os

    import numpy as np

    from collaborative_gan_sampling_torch.pipeline import shaped_d_path
    from collaborative_gan_sampling_torch.utils.checkpoint import (
        latest_checkpoint,
        restore_checkpoint,
        saved_config,
    )

    ckpt_dir = os.path.join(cfg.workdir, "ckpts")
    path = latest_checkpoint(ckpt_dir)
    if path is None:
        return {"workdir": cfg.workdir, "checkpoint": None,
                "note": "no checkpoint; run train first"}

    def n_params(tree) -> int:
        if isinstance(tree, dict):
            return sum(n_params(v) for v in tree.values())
        return int(np.size(tree)) if tree is not None else 0

    raw = restore_checkpoint(path)  # the raw dict: no model is built
    saved = saved_config(ckpt_dir) or {}
    return {
        "workdir": cfg.workdir,
        "checkpoint": path,
        "step": int(np.asarray(raw.get("step", -1))),
        "g_params": n_params(raw.get("g_vars", {}).get("params", {})),
        "d_params": n_params(raw.get("d_vars", {}).get("params", {})),
        "g_ema_tracked": raw.get("g_ema") is not None,
        "shaped_d_saved": os.path.exists(shaped_d_path(cfg.workdir)),
        "model_config": saved.get("model"),
    }


def _check_platforms(platforms: list[str] | None, device: str | None
                     ) -> None:
    """``export platforms=``: an artifact serves the one device type it is
    traced on, so one value, and the one ``--device`` gives (the card
    unless it says otherwise)."""
    if platforms is None:
        return
    if len(platforms) != 1:
        raise ValueError(
            f"export platforms={','.join(platforms)}: a torch.export "
            "artifact serves one device type, the one it was traced on; "
            "give one of cuda or cpu and export once per device type")
    want = (device or "cuda").split(":")[0]
    if platforms[0] != want:
        raise ValueError(f"export platforms={platforms[0]} does not match "
                         f"--device ({want}); the artifact is traced on "
                         "the device the command runs on")


def _tune_result(best: tuple, table: dict, axes: dict) -> dict:
    """``cli tune``'s output: best_k, best_rate and best_<axis> of each
    axis swept in ``axes`` (override key -> values or None), then the grid
    keyed as "k=5,rate=0.01,obj=ns" (the JAX CLI's format)."""
    names = ["k", "rate"]
    result = {"best_k": best[0], "best_rate": best[1]}
    for key, _, name, best_key, _ in TUNE_AXES:
        if axes[key] is not None:
            result[best_key] = best[len(names)]
            names.append(name)
    result["grid"] = {",".join(f"{n}={v}" for n, v in zip(names, cell)): m
                      for cell, m in table.items()}
    return result


def main(argv: list[str] | None = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    parser = argparse.ArgumentParser(prog="cgs-torch")
    parser.add_argument("command", choices=["train", "refine", "collab",
                                            "benchmark", "eval", "sweep",
                                            "tune", "teaser", "profile",
                                            "generate", "export", "inspect",
                                            "import-tf1", "presets"])
    parser.add_argument("--config", default="toy2d",
                        help=f"preset: {list_presets()}")
    parser.add_argument("--workdir", default="")
    parser.add_argument("--method", default="",
                        help="sampling method override for refine/generate")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    parser.add_argument("--mesh", action="store_true",
                        help="data-parallel over the launcher's processes, "
                             "one per card")
    parser.add_argument("--debug-nans", action="store_true",
                        help="raise at the first op that makes a NaN "
                             "(development runs: every op synchronises)")
    parser.add_argument("--safe", action="store_true",
                        help="apply the self-guarding sampling recipe "
                             "(refine.stop_score=0.5, "
                             "refine.shaping_target=0.5)")
    parser.add_argument("--auto-tune", action="store_true",
                        help="refine/collab: tune (K, rate) on the "
                             "checkpoint under the method first, then "
                             "sample at the best cell")
    args, overrides = parser.parse_known_args(argv)

    if args.command == "presets":
        print(json.dumps(list_presets()))
        return 0

    # A no-op in one process; see parallel/multihost.py.
    started = (args.command not in ("inspect", "import-tf1")
               and not torch.distributed.is_initialized()
               and maybe_initialize_distributed(args.device))
    try:
        with debug_nans(args.debug_nans):
            return _run(args, overrides)
    finally:
        if started:
            shutdown_distributed()


def _emit(obj, **kw) -> None:
    """Print one JSON result, on rank 0 only when a process group is
    up."""
    if (not torch.distributed.is_initialized()
            or torch.distributed.get_rank() == 0):
        print(json.dumps(obj, **kw), flush=True)


def _run(args, overrides: list[str]) -> int:
    gen_n, gen_out, gen_class = 10_000, "", None
    exp_out, exp_platforms = "", None
    tf1_src, tf1_step = "", None
    sweep_steps, tune_rates = [1, 5, 10, 20, 50], None
    axes = {key: None for key, *_ in TUNE_AXES}
    casts = {key: cast for key, *_, cast in TUNE_AXES}
    grid_cmds = ("sweep", "tune", "refine", "collab")
    kept = []
    for ov in overrides:
        # Each command's own keys: on another command a stray n=, out=,
        # class=, sweep_steps= or tune_*= raises the unknown-field error
        # instead of being swallowed.
        key, _, val = ov.partition("=")
        if args.command == "generate" and key == "n":
            gen_n = int(val)
        elif args.command == "generate" and key == "out":
            gen_out = val
        elif args.command in ("generate", "export") and key == "class":
            gen_class = int(val)
        elif args.command == "export" and key == "out":
            exp_out = val
        elif args.command == "export" and key == "platforms":
            exp_platforms = val.split(",")
        elif args.command == "import-tf1" and key == "tf1":
            tf1_src = val
        elif args.command == "import-tf1" and key == "step":
            tf1_step = int(val)
        elif args.command in grid_cmds and key == "sweep_steps":
            sweep_steps = [int(k) for k in val.split(",")]
        elif args.command in grid_cmds[1:] and key == "tune_rates":
            tune_rates = [float(r) for r in val.split(",")]
        elif args.command in grid_cmds[1:] and key in axes:
            axes[key] = [casts[key](v) for v in val.split(",")]
        else:
            kept.append(ov)
    cfg = _build_cfg(args, kept)

    if args.command == "inspect":
        # The checkpoint alone: no Experiment, so no dataset, no model and
        # no device.
        print(json.dumps(_inspect(cfg), indent=2))
        return 0

    if args.command == "import-tf1":
        if not tf1_src:
            print("import-tf1 requires tf1=<path to TF1 checkpoint dir or "
                  "prefix>", file=sys.stderr)
            return 2
        from collaborative_gan_sampling_torch.compat.tf1_import import (
            tf1_to_checkpoint,
        )

        path = tf1_to_checkpoint(tf1_src, cfg, step=tf1_step,
                                 device=args.device)
        print(json.dumps({"checkpoint": path, "workdir": cfg.workdir}))
        return 0

    if args.command == "export":
        if not exp_out:
            print("export requires out=<artifact path>", file=sys.stderr)
            return 2
        _check_platforms(exp_platforms, args.device)

    from collaborative_gan_sampling_torch.pipeline import Experiment

    exp = Experiment(cfg, use_mesh=args.mesh, device=args.device)
    if args.command == "train":
        state = exp.train()
        _emit({"trained_steps": state.step, "workdir": cfg.workdir})
        return 0

    state = exp.load_or_train()
    if args.command in ("refine", "collab", "eval"):
        method = args.method or ("collab" if args.command == "collab"
                                 else cfg.refine.method)
        refine_cfg, tuned = None, {}
        if args.auto_tune and args.command != "eval":
            if method not in ("refinement", "collab"):
                # (K, rate) drive only the refining methods.
                print(json.dumps({"note": f"--auto-tune ignored for "
                                          f"method={method!r} (no (K, rate) "
                                          "to tune)"}), file=sys.stderr)
            else:
                # Tuned under the method being run: shaping changes D's
                # gradient field, so (K, rate) tuned for refinement
                # under-tune collab.
                (bk, br), _ = exp.select_hparams(state, sweep_steps,
                                                 tune_rates, method=method)
                refine_cfg = dataclasses.replace(cfg.refine, steps=bk,
                                                 rate=br)
                tuned = {"tuned_k": bk, "tuned_rate": br}
        res = exp.sample(state, method=method, refine_cfg=refine_cfg)
        _emit({"method": method, **tuned, **exp.evaluate(res)})
        return 0

    if args.command == "sweep":
        best_k, table = exp.select_k(state, sweep_steps,
                                     method=args.method or "refinement")
        _emit({"best_k": best_k, "sweep": table})
        return 0

    if args.command == "tune":
        best, table = exp.select_hparams(
            state, sweep_steps, tune_rates,
            method=args.method or "refinement",
            **{arg: axes[key] for key, arg, *_ in TUNE_AXES})
        _emit(_tune_result(best, table, axes))
        return 0

    if args.command == "benchmark":
        _emit(exp.benchmark(state), indent=2)
        return 0

    if args.command == "profile":
        _emit({"trace_dir": exp.profile(state), "spans": summary()})
        return 0

    if args.command == "teaser":
        _emit(exp.teaser(state))
        return 0

    if args.command == "export":
        meta = exp.export(state, exp_out, method=args.method or None,
                          class_id=gen_class)
        _emit({"out": exp_out, **meta})
        return 0

    # generate: the serving path, streaming accepted samples.
    method = args.method or cfg.refine.method
    _, _, stats = exp.generate(state, gen_n, method=method,
                               out=gen_out or None, class_id=gen_class)
    _emit(stats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
