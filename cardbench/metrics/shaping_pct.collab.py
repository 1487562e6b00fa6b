"""Shaping's share of a collab call (training/shaping.py via sampling/collab.py): span cgs.collab.shape over cgs.collab.call."""

from cardbench.span_readers import share_pct


def read(r):
    return share_pct(("cgs.collab.shape",), "cgs.collab.call")
