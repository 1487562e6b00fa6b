"""Each cell end to end at a tiny size on the CPU, through the port's plain
versions: the run completes, reports its metrics and holds the card's
limits (but two of celeba's, below); the fp8 control in the program's
place breaks at least one of them."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

import tiny

BENCH = json.loads((Path(__file__).resolve().parents[2]
                    / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


# Numbers that a tiny run on the CPU reads above the card's limits: the
# CPU's bf16 convolutions at 64x64x3 and batches of 8 (the card's runs of
# the cell read 0.03 to 0.06 and 0.004 to 0.008; PERF.md section 2).
CPU_ABOVE = {"celeba.collab": {"logit_gap", "shaped_logit_gap"}}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_runs_and_holds_its_limits(workload, one_thread):
    r = tiny.run(workload, control=True)
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert "setup_s" in r["metrics"] and len(r["metrics"]) >= 2
    assert list(r)[-3] == "check"  # then the internal keys, never printed
    skip = CPU_ABOVE.get(workload, set())
    held = {k: row for k, row in r["check"].items() if k not in skip}
    assert all(row["value"] <= row["limit"] for row in held.values()), held
    assert r["correct"] or skip
    failed = [k for k, v in r["_control"].items()
              if k in held and v > held[k]["limit"]]
    assert failed, f"the control passed every limit: {r['_control']}"


def test_result_line_is_json_with_check_last(capsys, one_thread):
    from cardbench import harness

    harness.print_result(tiny.run("mnist.refine_b2048"))
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[-1] == "check"
    assert set(line) >= {"correct", "attempted", "failed", "metrics",
                         "device"}
    assert err.strip().splitlines()[-1].startswith("check ")
