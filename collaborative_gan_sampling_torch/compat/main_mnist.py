"""Reference-compatible entry: ``mnist/main_mnist.py`` flags (JAX
``compat/main_mnist.py``), plus ``--device``."""

import sys

from collaborative_gan_sampling_torch.compat._shared import run


def main(argv=None) -> int:
    return run("mnist", argv,
               defaults={"niters": 4000, "batch_size": 256, "lr": 2e-4,
                         "rollout_rate": 0.02, "z_dim": 100})


if __name__ == "__main__":
    sys.exit(main())
