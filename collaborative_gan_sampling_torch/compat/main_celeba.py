"""Reference-compatible entry: ``celebA/main.py`` flags (JAX
``compat/main_celeba.py``), plus ``--device``."""

import sys

from collaborative_gan_sampling_torch.compat._shared import run


def main(argv=None) -> int:
    return run("celeba", argv,
               defaults={"niters": 40000, "batch_size": 128, "lr": 2e-4,
                         "rollout_rate": 0.01, "z_dim": 100})


if __name__ == "__main__":
    sys.exit(main())
