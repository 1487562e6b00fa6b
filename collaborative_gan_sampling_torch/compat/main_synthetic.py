"""Reference-compatible entry: ``synthetic/main_synthetic.py`` flags (JAX
``compat/main_synthetic.py``), plus ``--device``."""

import sys

from collaborative_gan_sampling_torch.compat._shared import run


def main(argv=None) -> int:
    return run("toy2d", argv,
               defaults={"niters": 4000, "batch_size": 256, "lr": 1e-3,
                         "rollout_rate": 0.1})


if __name__ == "__main__":
    sys.exit(main())
