"""CLI: ``python -m collaborative_gan_sampling_torch.cli <cmd> ...``.

Counterpart of ``collaborative_gan_sampling_tpu/cli.py`` for the commands
the port has:

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
    cli profile   --config mnist          # torch.profiler trace
    cli presets

Counterpart of the JAX CLI but for ``import-tf1``. ``export`` writes the
serving round as one ``torch.export`` file (``out=``, ``class=``;
``sampling/export.py``) for the device it runs on: ``platforms=`` takes
that one device type (``cuda`` or ``cpu``, as ``--device`` gives it), where
the JAX CLI lowers for several platforms at once. Any config field is
overridable as dotted key=value (``config.apply_overrides``);
``data.path=`` points ``mnist`` / ``fmnist`` at idx files, ``cifar10`` at
the python pickles and ``celeba`` / ``imagenet64`` at a folder of images. Commands after ``train`` but
``inspect`` restore the latest checkpoint of the workdir (one that either
package wrote) and resume training first if it is behind
``train.niters``. ``refine``, ``collab`` and ``eval`` print
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
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from collaborative_gan_sampling_torch.config import (
    apply_overrides,
    get_preset,
    list_presets,
)

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
                                            "presets"])
    parser.add_argument("--config", default="toy2d",
                        help=f"preset: {list_presets()}")
    parser.add_argument("--workdir", default="")
    parser.add_argument("--method", default="",
                        help="sampling method override for refine/generate")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
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

    gen_n, gen_out, gen_class = 10_000, "", None
    exp_out, exp_platforms = "", None
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

    if args.command == "export":
        if not exp_out:
            print("export requires out=<artifact path>", file=sys.stderr)
            return 2
        _check_platforms(exp_platforms, args.device)

    from collaborative_gan_sampling_torch.pipeline import Experiment

    exp = Experiment(cfg, device=args.device)
    if args.command == "train":
        state = exp.train()
        print(json.dumps({"trained_steps": state.step,
                          "workdir": cfg.workdir}))
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
        print(json.dumps({"method": method, **tuned, **exp.evaluate(res)}))
        return 0

    if args.command == "sweep":
        best_k, table = exp.select_k(state, sweep_steps,
                                     method=args.method or "refinement")
        print(json.dumps({"best_k": best_k, "sweep": table}))
        return 0

    if args.command == "tune":
        best, table = exp.select_hparams(
            state, sweep_steps, tune_rates,
            method=args.method or "refinement",
            **{arg: axes[key] for key, arg, *_ in TUNE_AXES})
        print(json.dumps(_tune_result(best, table, axes)))
        return 0

    if args.command == "benchmark":
        print(json.dumps(exp.benchmark(state), indent=2))
        return 0

    if args.command == "profile":
        print(json.dumps({"trace_dir": exp.profile(state)}))
        return 0

    if args.command == "teaser":
        print(json.dumps(exp.teaser(state)))
        return 0

    if args.command == "export":
        meta = exp.export(state, exp_out, method=args.method or None,
                          class_id=gen_class)
        print(json.dumps({"out": exp_out, **meta}))
        return 0

    # generate: the serving path, streaming accepted samples.
    method = args.method or cfg.refine.method
    _, _, stats = exp.generate(state, gen_n, method=method,
                               out=gen_out or None, class_id=gen_class)
    print(json.dumps(stats))
    return 0


if __name__ == "__main__":
    sys.exit(main())
