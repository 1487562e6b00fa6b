"""Migrate a trained TF1 reference checkpoint into the framework, on the
card.

The reference trains with TF1 and saves via ``tf.train.Saver``; those
checkpoints import directly (``compat/tf1_import.py``) — this example
fabricates one (a synthetic-stack MLP pair, saved with a real Saver) so it
runs self-contained, then imports it and runs collaborative sampling on the
imported (G, D) without any retraining. The PyTorch counterpart of
``examples/migrate_tf1.py``; the Saver directory goes under
``runs/migrate_demo/`` where that one takes a temporary directory.

    python examples_torch/migrate_tf1.py [--device cpu]

Requires tensorflow (writing and reading the TF1 format only). NITERS is
accepted for CI-smoke symmetry but unused — the point is that nothing trains
here.
"""

import argparse
import json
import os

import numpy as np

from collaborative_gan_sampling_torch.compat.tf1_import import (
    tf1_to_checkpoint,
)
from collaborative_gan_sampling_torch.config import apply_overrides, get_preset
from collaborative_gan_sampling_torch.models import resolve_device
from collaborative_gan_sampling_torch.pipeline import Experiment

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default=None,
                    help="torch device (default: the card)")
args = parser.parse_args()
device = resolve_device(args.device)  # no card: fail before TensorFlow

os.environ.setdefault("TF_CPP_MIN_LOG_LEVEL", "2")
import tensorflow as tf  # noqa: E402

tf1 = tf.compat.v1
tf1.disable_eager_execution()

# -- stand-in for "your existing TF1 training run" ---------------------------
rng = np.random.default_rng(0)


def _dense(x, out_dim, scope):
    with tf1.variable_scope(scope):
        w = tf1.get_variable("Matrix", initializer=tf1.constant(
            (rng.standard_normal((int(x.shape[-1]), out_dim)) *
             0.2).astype(np.float32)))
        b = tf1.get_variable("bias", initializer=tf1.constant(
            np.zeros(out_dim, np.float32)))
    return tf1.matmul(x, w) + b


tf1_dir = os.path.abspath("runs/migrate_demo/tf1_ckpt")
os.makedirs(tf1_dir, exist_ok=True)
with tf1.Graph().as_default():
    h = tf1.placeholder(tf1.float32, (1, 4))
    with tf1.variable_scope("generator"):
        for i in range(3):
            h = tf1.nn.relu(_dense(h, 128, f"fc{i}"))
        _dense(h, 2, "out")
    d = tf1.placeholder(tf1.float32, (1, 2))
    with tf1.variable_scope("discriminator"):
        for i in range(3):
            d = tf1.nn.relu(_dense(d, 128, f"fc{i}"))
        _dense(d, 1, "out")
    with tf1.Session() as sess:
        sess.run(tf1.global_variables_initializer())
        tf1.train.Saver().save(sess, os.path.join(tf1_dir, "model"),
                               global_step=5000)
print("TF1 Saver checkpoint at:", tf1_dir)

# -- the migration: one call -------------------------------------------------
cfg = get_preset("toy2d").replace(workdir="runs/migrate_demo")
cfg = apply_overrides(cfg, ["refine.num_batches=4"])
path = tf1_to_checkpoint(tf1_dir, cfg, device=device)
print("imported ->", path)

# Every post-training command now runs on the imported (G, D): load_or_train
# sees a finished run (step == train.niters) and does NOT retrain.
exp = Experiment(cfg, device=device)
state = exp.load_or_train()
res = exp.sample(state, method="collab")
print("collab on imported weights:", json.dumps(exp.evaluate(res)))
