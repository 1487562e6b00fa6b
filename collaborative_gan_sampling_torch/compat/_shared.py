"""The reference's flag names mapped onto the config, for the compat mains.

Counterpart of ``collaborative_gan_sampling_tpu/compat/_shared.py``
(JAX ``:12-89``): the same ``MODE_TO_METHOD``, flags, defaults and
``to_config``, held to it in ``tests/test_torch_compat.py`` (the same
config dict for each script's defaults and flags). One flag beyond them,
``--device``: the port runs on the card unless the caller asks for the
CPU (``--device cpu``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from collaborative_gan_sampling_torch.config import Config, get_preset

# Reference mode names -> the port's sampling methods.
MODE_TO_METHOD = {
    "standard": "standard",
    "rejection": "reject",
    "reject": "reject",
    "hastings": "mhgan",
    "mhgan": "mhgan",
    "refinement": "refinement",
    "refine": "refinement",
    "collab": "collab",
    "collaborate": "collab",
}


def build_parser(defaults: dict) -> argparse.ArgumentParser:
    """The reference's flags (``synthetic/main_synthetic.py`` and the
    carpedm20-style image mains), with per-script defaults."""
    p = argparse.ArgumentParser()
    p.add_argument("--mode", default="train",
                   help="train | standard | rejection | hastings | "
                        "refinement | collab | benchmark")
    p.add_argument("--niters", type=int, default=defaults.get("niters", 4000))
    p.add_argument("--batch_size", type=int,
                   default=defaults.get("batch_size", 256))
    p.add_argument("--z_dim", type=int, default=defaults.get("z_dim"))
    p.add_argument("--lr", type=float, default=defaults.get("lr", 2e-4))
    p.add_argument("--beta1", type=float, default=0.5)
    p.add_argument("--rollout_steps", type=int, default=10,
                   help="K — refinement gradient steps")
    p.add_argument("--rollout_rate", type=float,
                   default=defaults.get("rollout_rate", 0.1),
                   help="lambda — refinement step size")
    p.add_argument("--rejection_gamma", type=float, default=0.0)
    p.add_argument("--shaping_interval", type=int, default=1)
    p.add_argument("--checkpoint_dir", default="")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card)")
    return p


def to_config(preset: str, args: argparse.Namespace) -> Config:
    cfg = get_preset(preset)
    model = cfg.model
    if args.z_dim:
        model = dataclasses.replace(model, z_dim=args.z_dim)
    train = dataclasses.replace(
        cfg.train, niters=args.niters, batch_size=args.batch_size,
        d_lr=args.lr, g_lr=args.lr, beta1=args.beta1)
    refine = dataclasses.replace(
        cfg.refine, steps=args.rollout_steps, rate=args.rollout_rate,
        gamma=args.rejection_gamma, shape_every=args.shaping_interval,
        batch_size=args.batch_size)
    workdir = args.checkpoint_dir or cfg.workdir
    return dataclasses.replace(cfg, model=model, train=train, refine=refine,
                               workdir=workdir, seed=args.seed)


def run(preset: str, argv=None, defaults: dict | None = None) -> int:
    args = build_parser(defaults or {}).parse_args(argv)
    method = MODE_TO_METHOD.get(args.mode)
    if args.mode not in ("train", "benchmark") and method is None:
        raise SystemExit(f"unknown --mode {args.mode!r}")
    from collaborative_gan_sampling_torch.pipeline import Experiment

    exp = Experiment(to_config(preset, args), device=args.device)
    if args.mode == "train":
        state = exp.train()
        print(json.dumps({"trained_steps": state.step}))
        return 0

    state = exp.load_or_train()
    if args.mode == "benchmark":
        print(json.dumps(exp.benchmark(state), indent=2))
        return 0
    res = exp.sample(state, method=method)
    print(json.dumps({"mode": args.mode, **exp.evaluate(res)}))
    return 0
