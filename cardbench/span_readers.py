"""What the program-span metric readers compute: ratios inside the port's
span store (``collaborative_gan_sampling_torch/utils/profiling.py``), which
the program fills while the traced slice's profiler sessions record. A
ratio of two sums of the store does not depend on how many units the
sessions held. Each returns None where the store holds no span of the
unit's root, as under a program that records no spans."""

from __future__ import annotations


def _summary() -> dict:
    from collaborative_gan_sampling_torch.utils import profiling

    summary = getattr(profiling, "summary", None)  # a program without spans
    return summary() if summary else {"spans": {}, "counters": {}}


def share_pct(parts: tuple[str, ...], root: str):
    """The spans ``parts``' total time over the root spans' total."""
    spans = _summary()["spans"]
    root_ms = spans.get(root, {}).get("total_ms", 0.0)
    if root_ms <= 0:
        return None
    return 100.0 * sum(spans[p]["total_ms"] for p in parts
                       if p in spans) / root_ms


def per_root(counter: str, root: str):
    """Counter ``counter`` over the count of root spans."""
    s = _summary()
    roots = s["spans"].get(root, {}).get("count", 0)
    return s["counters"].get(counter, 0) / roots if roots else None
