"""The whole step (z -> G -> refine) against the dense bf16 peak."""

from cardbench.readers import mfu_pct


def read(r):
    return mfu_pct(r, shaping=False)
