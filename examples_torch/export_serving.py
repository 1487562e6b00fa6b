"""Fleet deployment: export the sampler, serve it with no model code.

Train (or restore) a tiny image GAN, export one serving round — trained
weights, DRS calibration and the shaped discriminator baked into a
self-contained ``torch.export`` artifact — then reload it as a plain
callable and generate accepted samples. The load side needs neither the
config, the checkpoint nor any model class: this is what ships to serving
hosts. The PyTorch counterpart of ``examples/export_serving.py``; the
artifact serves the device type it was traced on (``--device``), where the
JAX one is lowered for the platforms it is given, and it takes an int64
seed where the JAX one takes a key.

    python examples_torch/export_serving.py [--device cpu]

NITERS=50 in the environment shrinks the run (used by the CI smoke test).
"""

import argparse
import json
import os

import torch

from collaborative_gan_sampling_torch.config import apply_overrides, get_preset
from collaborative_gan_sampling_torch.pipeline import Experiment
from collaborative_gan_sampling_torch.sampling.export import load_sampler

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default=None,
                    help="torch device (default: the card)")
args = parser.parse_args()

niters = int(os.environ.get("NITERS", 1000))
cfg = get_preset("mnist").replace(workdir="runs/export_demo")
# Tiny model so the example runs in seconds; drop the overrides for the real
# preset.
cfg = apply_overrides(cfg, [
    f"train.niters={niters}", "train.steps_per_call=25",
    "model.image_size=16", "model.g_base_filters=8",
    "model.d_base_filters=8", "model.z_dim=16",
    "refine.steps=5", "refine.num_batches=2", "refine.batch_size=64",
    "refine.burn_in=64", "refine.use_pallas=false",
])

exp = Experiment(cfg, device=args.device)
state = exp.load_or_train()

# -- producer side: one call writes the artifact + JSON meta sidecar -------
meta = exp.export(state, "runs/export_demo/sampler.pt2", method="collab")
print("exported:", json.dumps(meta))

# -- serving side: no Experiment, no config, no checkpoint ------------------
fn, meta = load_sampler("runs/export_demo/sampler.pt2")
samples, labels, accept, logits = fn(123)
acc = accept.cpu()
print(f"served round: {samples.shape[0]} candidates, "
      f"{int(acc.sum())} accepted "
      f"(accept_rate={float(acc.float().mean()):.3f})")
assert bool(torch.isfinite(samples).all())
