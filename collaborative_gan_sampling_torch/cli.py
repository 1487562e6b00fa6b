"""CLI: ``python -m collaborative_gan_sampling_torch.cli <cmd> ...``.

Counterpart of ``collaborative_gan_sampling_tpu/cli.py`` for the commands
the port has:

    cli train     --config toy2d [a.b=c ...]
    cli refine    --config toy2d refine.method=refinement
    cli collab    --config toy2d          # refine + reject + shape
    cli generate  --config toy2d n=100000 out=samples.npz
    cli generate  --config imagenet64 n=4096 class=7   # one class
    cli eval      --config mnist          # sample refine.method, evaluate
    cli sweep     --config mnist sweep_steps=1,5,10,20,50
    cli presets

Any config field is overridable as dotted key=value
(``config.apply_overrides``). Commands after ``train`` restore the latest
checkpoint of the workdir (one that either package wrote) and resume
training first if it is behind ``train.niters``. ``refine``, ``collab`` and
``eval`` print ``Experiment.evaluate`` of their samples (FID, with KID and
precision/recall when configured, on image presets; %HQ and KL on 2D);
``sweep`` prints the refinement-depth sweep and its best K. Runs on the
card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
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


def _build_cfg(args, overrides):
    cfg = get_preset(args.config)
    if args.workdir:
        cfg = cfg.replace(workdir=args.workdir)
    if args.safe:  # before the user's overrides, so theirs win
        cfg = apply_overrides(cfg, SAFE_OVERRIDES)
    return apply_overrides(cfg, overrides)


def main(argv: list[str] | None = None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    parser = argparse.ArgumentParser(prog="cgs-torch")
    parser.add_argument("command", choices=["train", "refine", "collab",
                                            "eval", "sweep", "generate",
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
    args, overrides = parser.parse_known_args(argv)

    if args.command == "presets":
        print(json.dumps(list_presets()))
        return 0

    gen_n, gen_out, gen_class = 10_000, "", None
    sweep_steps = [1, 5, 10, 20, 50]
    kept = []
    for ov in overrides:
        # generate's and sweep's own keys: on another command a stray n=,
        # out=, class= or sweep_steps= raises the unknown-field error
        # instead of being swallowed.
        if args.command == "generate" and ov.startswith("n="):
            gen_n = int(ov.split("=", 1)[1])
        elif args.command == "generate" and ov.startswith("out="):
            gen_out = ov.split("=", 1)[1]
        elif args.command == "generate" and ov.startswith("class="):
            gen_class = int(ov.split("=", 1)[1])
        elif args.command == "sweep" and ov.startswith("sweep_steps="):
            sweep_steps = [int(k) for k in ov.split("=", 1)[1].split(",")]
        else:
            kept.append(ov)
    cfg = _build_cfg(args, kept)

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
        res = exp.sample(state, method=method)
        print(json.dumps({"method": method, **exp.evaluate(res)}))
        return 0

    if args.command == "sweep":
        best_k, table = exp.select_k(state, sweep_steps,
                                     method=args.method or "refinement")
        print(json.dumps({"best_k": best_k, "sweep": table}))
        return 0

    # generate: the serving path, streaming accepted samples.
    method = args.method or cfg.refine.method
    _, _, stats = exp.generate(state, gen_n, method=method,
                               out=gen_out or None, class_id=gen_class)
    print(json.dumps(stats))
    return 0


if __name__ == "__main__":
    sys.exit(main())
