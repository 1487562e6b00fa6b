"""Compaction and the fetch to the host as a share of a serving request (ServingSampler.compact): spans cgs.serve.compact and cgs.serve.fetch over cgs.serve.generate."""

from cardbench.span_readers import share_pct


def read(r):
    return share_pct(("cgs.serve.compact", "cgs.serve.fetch"),
                     "cgs.serve.generate")
