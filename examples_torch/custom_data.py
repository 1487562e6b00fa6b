"""Plugging in your own data, on the card.

Image presets read real files from ``data.path`` (MNIST idx, CIFAR-10 pickle
batches, or a folder of JPEG/PNG for CelebA-style data); with no path they
fall back to the procedural distribution. For anything else, drive the
training layer directly with a ``data_fn(generator, n) -> (x, labels)``
(``training/gan.py``'s ``DataFn``) that draws from the ``torch.Generator``
it is given — including from a table on the device, as below. The PyTorch
counterpart of ``examples/custom_data.py``.

    python examples_torch/custom_data.py [--device cpu]

NITERS=50 in the environment shrinks the run (used by the CI smoke test).
"""

import argparse
import math
import os

import torch

from collaborative_gan_sampling_torch.config import ModelConfig, TrainConfig
from collaborative_gan_sampling_torch.models import make_bundle
from collaborative_gan_sampling_torch.training import (
    create_train_state,
    make_train_chunk,
)

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default=None,
                    help="torch device (default: the card)")
args = parser.parse_args()

bundle = make_bundle(ModelConfig(kind="mlp", z_dim=4,
                                 compute_dtype="float32"), device=args.device)
dev = bundle.device

# A made-up 2D dataset: points on a spiral, resident on the device.
t = torch.linspace(0, 4 * math.pi, 50_000, device=dev)
table = torch.stack([t / 6 * torch.cos(t), t / 6 * torch.sin(t)], dim=1)


def data_fn(generator, n):
    idx = torch.randint(0, table.shape[0], (n,), generator=generator,
                        device=dev)
    jitter = 0.05 * torch.randn((n, 2), generator=generator, device=dev)
    return table[idx] + jitter, None


tcfg = TrainConfig(batch_size=256,
                   niters=int(os.environ.get("NITERS", 500)),
                   steps_per_call=50, d_lr=1e-3, g_lr=1e-3)
state = create_train_state(bundle, tcfg, seed=0)
chunk = make_train_chunk(bundle, tcfg, data_fn, seed=0)
for _ in range(tcfg.niters // tcfg.steps_per_call):
    state, metrics = chunk(state)
print("final:", {k: float(v) for k, v in metrics.items()})
