"""Train once, shape once, refine many times, on the card.

Collab sampling fine-tunes (shapes) the discriminator while it samples; the
shaped D is itself a product — later refinement runs reuse it without paying
for shaping again, and with different (K, lambda) settings. The PyTorch
counterpart of ``examples/shaped_d_reuse.py``.

    python examples_torch/shaped_d_reuse.py [--device cpu]

NITERS=50 in the environment shrinks the run (used by the CI smoke test).
"""

import argparse
import dataclasses
import json
import os

from collaborative_gan_sampling_torch.config import get_preset
from collaborative_gan_sampling_torch.pipeline import Experiment

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default=None,
                    help="torch device (default: the card)")
args = parser.parse_args()

cfg = get_preset("toy2d").replace(workdir="runs/shaped_reuse")
exp = Experiment(cfg, device=args.device)
state = exp.load_or_train(niters=int(os.environ.get("NITERS", 1000)))

# One collab pass: refine -> reject -> shape, round after round.
res = exp.sample(state, method="collab")
print("collab:", json.dumps(exp.evaluate(res)))
exp.save_shaped_d(res)

# Later (any process): refinement under the shaped D, at a different depth.
for k in (5, 20):
    rcfg = dataclasses.replace(cfg.refine, steps=k)
    r = exp.sample(state, method="refinement", use_shaped_d=True,
                   refine_cfg=rcfg)
    print(f"refine K={k} under shaped D:", json.dumps(exp.evaluate(r)))
