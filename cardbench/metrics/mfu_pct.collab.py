"""The whole step (draw, refine, D passes, shaping) against the dense bf16 peak."""

from cardbench.readers import mfu_pct


def read(r):
    return mfu_pct(r, shaping=True)
