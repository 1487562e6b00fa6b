"""On the card, at each cell's own size: the program proves correct and the
control (the plain reference in fp8 in the program's place) fails at least
one of the cell's limits, on three seeds. Skipped without a card; run on the
card with ``python -m pytest cardbench/tests -q -m card``."""

from __future__ import annotations

import json
import time
from pathlib import Path

import pytest

from cardbench import harness
from test_cardbench_faults import CASES, IDS, broken_limits

BENCH = json.loads((Path(__file__).resolve().parents[2]
                    / "BENCHMARK.json").read_text())
SECONDS = {"celeba.collab": 9.0, "mnist.serve": 5.0}


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_control_fails_at_the_cells_size(workload, card):
    spec = harness.Spec()
    limits = spec.limits(workload)
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        r = harness.run_cell(spec, workload, seed,
                             SECONDS.get(workload, 3.0), False,
                             time.perf_counter(), card, control=True)
        assert r["correct"], r["check"]
        assert any(r["_control"][k] > v for k, v in limits.items()), \
            r["_control"]


@pytest.mark.card
@pytest.mark.parametrize("workload,fault", CASES, ids=IDS)
def test_fault_breaks_a_limit_at_the_cells_size(workload, fault, card,
                                                 monkeypatch):
    def run(w):
        return harness.run_cell(harness.Spec(), w, 2 ** 31 + 201,
                                SECONDS.get(w, 3.0), False,
                                time.perf_counter(), card)
    assert broken_limits(workload, fault, monkeypatch, run)
