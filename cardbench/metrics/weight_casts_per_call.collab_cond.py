"""The weight and table conversions to the compute dtype per collab call (ops/nn.py: every forward of G, of D in the autograd refinement and in shaping): counter weight_casts over the count of span cgs.collab.call. None where the store holds no such counter, as under a program without it."""

from cardbench.span_readers import _summary, per_root


def read(r):
    if "weight_casts" not in _summary()["counters"]:
        return None
    return per_root("weight_casts", "cgs.collab.call")
