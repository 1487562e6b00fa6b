"""What each refinement launch does with D alone (sampling/refine.py's BN fold, ops/conv_refine.py's weight packing) as a share of a collab call: span cgs.refine.prepare over cgs.collab.call."""

from cardbench.span_readers import share_pct


def read(r):
    return share_pct(("cgs.refine.prepare",), "cgs.collab.call")
