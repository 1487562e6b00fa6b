"""Kernel #4 (csrc/conv_refine28_bf16.cu): its bound over its device time per launch."""

from cardbench.readers import roofline_pct


def read(r):
    return roofline_pct(r, "conv_refine28_bf16")
