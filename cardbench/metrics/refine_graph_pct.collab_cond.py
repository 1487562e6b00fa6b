"""The autograd refinement's batches replayed as one CUDA graph (sampling/refine.py) as a share of its batches: 100 x counter refine_graph_replays over the count of span cgs.refine.steps. None where the store holds no such counter, as under a program without it."""

from cardbench.span_readers import _summary, per_root


def read(r):
    if "refine_graph_replays" not in _summary()["counters"]:
        return None
    share = per_root("refine_graph_replays", "cgs.refine.steps")
    return None if share is None else 100.0 * share
