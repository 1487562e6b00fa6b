"""Quickstart: the reference's 2D experiment end-to-end in one script, on
the card.

Trains the toy GAN on the imbalanced 8-Gaussian ring, compares all five
sampling strategies (%HQ / mode-KL), and renders the teaser figures (which
need matplotlib). The PyTorch counterpart of ``examples/quickstart_2d.py``.

    python examples_torch/quickstart_2d.py [--device cpu]

NITERS=50 in the environment shrinks the run (used by the CI smoke test).
"""

import argparse
import json
import os

from collaborative_gan_sampling_torch.config import get_preset
from collaborative_gan_sampling_torch.pipeline import Experiment

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default=None,
                    help="torch device (default: the card)")
args = parser.parse_args()

cfg = get_preset("toy2d").replace(workdir="runs/quickstart_2d")
exp = Experiment(cfg, device=args.device)

state = exp.train(niters=int(os.environ.get("NITERS", 1000)))
table = exp.benchmark(state)  # standard | reject | mhgan | refinement | collab
print(json.dumps(table, indent=2))
print(json.dumps(exp.teaser(state)))  # trajectory + overview figures, GIF
