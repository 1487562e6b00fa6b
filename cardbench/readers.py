"""What the metric readers (``metrics/<metric>.py``) compute, from a
``harness.Reading``. Each returns None where the run has nothing to read;
none returns 0 for a share of a peak or a roofline."""

from __future__ import annotations

import json
import statistics
from pathlib import Path

from cardbench import flops

HERE = Path(__file__).resolve().parent


def per_second(r, key: str):
    return r.total(key) / r.window_s if r.window_s > 0 else None


def p95_ms(r):
    """95th percentile of every request's latency (a failed one is
    infinite), linear between order statistics."""
    lat = r.latencies_ms()
    if len(lat) < 2:
        return lat[0] if lat else None
    return statistics.quantiles(lat, n=20, method="inclusive")[18]


def roofline_pct(r, kernel: str):
    """Kernel #4's device time per launch against its bound: its in-range
    FLOPs for the cell's batch at the dense bf16 peak."""
    if r.trace is None or kernel != "conv_refine28_bf16":
        return None
    spec = json.loads((HERE / "kernels" / f"{kernel}.json").read_text())
    secs, n = r.trace.kernel(spec["device_name"])
    if not n:
        return None
    bound = (flops.refine_flops_per_sample(r.cell.refine["steps"])
             * r.cell.batch / flops.PEAK_BF16_FLOPS)
    return 100.0 * bound / (secs / n)


def mfu_pct(r, shaping: bool):
    """The whole step's FLOPs over the untraced units' time at the dense
    bf16 peak: z -> G -> K steps -> D for every candidate, burn-in included,
    and with ``shaping`` each shaping step's D forward and backward on its
    real and refined batches, three D forwards a sample."""
    secs = r.untraced_s()
    if secs <= 0:
        return None
    model, rc = r.cell.model, r.cell.refine
    work = r.total("candidates", True) * flops.pipeline_flops_per_sample(
        model, rc["steps"])
    if shaping:
        work += (r.total("shaping_steps", True) * 2 * rc["batch_size"] * 3
                 * flops.d_forward_flops(model))
    return 100.0 * work / secs / flops.PEAK_BF16_FLOPS


def accept_pct(r):
    cands = r.total("candidates")
    return 100.0 * r.total("accepted") / cands if cands else None


def launches_per_batch(r):
    """Host kernel launches in the traced slice per batch of candidates
    (one draw-refine of ``batch_size``; burn-in and calibration count)."""
    if r.trace is None or not r.trace.batches():
        return None
    return r.trace.launches / r.trace.batches()


def device_idle_pct(r):
    if r.trace is None or r.trace.slice_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.slice_s)
