"""The readers of the program's spans and counter (``span_readers.py``;
five metrics of source ``program_span`` and ``program_counter``), on the
store that the program fills under the CPU profiler: each cell's entry runs
two units at a tiny size, and each reader's value is worked out again by
hand from the stored spans and the units' own counts. On an empty store,
and on a store that holds another cell's root, each reader returns
None."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import tiny
from cardbench import harness
from collaborative_gan_sampling_torch.utils import profiling

BENCH = json.loads((Path(__file__).resolve().parents[2]
                    / "BENCHMARK.json").read_text())
SHARES = {"shaping_pct.collab": (("cgs.collab.shape",), "cgs.collab.call"),
          "refine_prep_pct.collab": (("cgs.refine.prepare",),
                                     "cgs.collab.call"),
          "calibrate_pct.serve": (("cgs.serve.calibrate",),
                                  "cgs.serve.generate"),
          "compact_fetch_pct.serve": (("cgs.serve.compact",
                                       "cgs.serve.fetch"),
                                      "cgs.serve.generate")}
NAMES = set(SHARES) | {"host_syncs_per_request.serve"}
SPAN_METRICS = {m["name"]: m for m in BENCH["per_layer"]
                if m["name"] in NAMES}


def _fill(spec, workload):
    """Two units of the cell's entry under the CPU profiler, on an emptied
    store; returns the cell and the units' counts."""
    cell = harness.make_cell(spec, workload, 2 ** 31 + 11,
                             torch.device("cpu"), tiny.TINY)
    entry = spec.entry(cell.mix["entry"])(cell)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        units = [entry.run_one(i) for i in range(2)]
    return cell, units


def _ms(names):
    return sum(r.end_ns - r.start_ns for r in profiling.records()
               if r.name in names) / 1e6


def test_the_five_metrics_are_declared():
    assert len(SPAN_METRICS) == 5
    for name, m in SPAN_METRICS.items():
        assert m["workloads"] == ["mnist." + name.rsplit(".", 1)[1]]
        assert m["source"] == ("program_counter" if name not in SHARES
                               else "program_span")


@pytest.mark.parametrize("workload", ["mnist.collab", "mnist.serve"])
def test_readers_by_hand(workload, one_thread):
    spec = harness.Spec()
    cell, units = _fill(spec, workload)
    reading = harness.Reading(cell, 0.0, 1.0, [], None)
    mine = [m["name"] for m in spec.metrics(workload, True)
            if m["name"] in SPAN_METRICS]
    others = set(SPAN_METRICS) - set(mine)
    assert len(mine) == {"mnist.collab": 2, "mnist.serve": 3}[workload]
    for name in mine:
        got = spec.reader(name)(reading)
        if name in SHARES:
            parts, root = SHARES[name]
            want = 100.0 * _ms(parts) / _ms({root})
            assert 0 < want < 100
        else:
            # 1 + 3 a round: the first round's rate, then each round's
            # nonzero, its copy and its accepted count.
            burn = max(1, cell.refine["burn_in"] // cell.refine["batch_size"])
            rounds = [(u["batches"] - burn) // cell.refine["num_batches"]
                      for u in units]
            want = sum(1 + 3 * k for k in rounds) / len(units)
        assert got == pytest.approx(want, rel=1e-9), name
    for name in others:  # the other cell's root is not in the store
        assert spec.reader(name)(reading) is None


def test_readers_return_none_on_an_empty_store():
    spec = harness.Spec()
    profiling.reset()
    reading = harness.Reading(harness.make_cell(
        spec, "mnist.collab", 3, torch.device("cpu")), 0.0, 1.0, [], None)
    for name in SPAN_METRICS:
        assert spec.reader(name)(reading) is None
