"""On the card, at the size of ``imagenet64.collab_cond``: the program
proves correct and the fp8 control fails at least one limit on three seeds,
and each fault of ``cond_faults.py`` breaks a limit that the clean run keeps
(one judged call a run: the whole model, batch and pool, a shorter window).
Skipped without a card; run on the card with
``python -m pytest cardbench/tests/test_cardbench_cond_card.py -q -m card``.
"""

from __future__ import annotations

import functools
import time

import pytest

import cond_faults
from cardbench import harness

WORKLOAD = "imagenet64.collab_cond"
ONE_CALL = {"mix": {"check": 1, "check_from": 1}}


def _run(card, seed: int, seconds: float, overrides=None,
         control: bool = False) -> dict:
    return harness.run_cell(harness.Spec(), WORKLOAD, seed, seconds, False,
                            time.perf_counter(), card, overrides,
                            control=control)


@functools.cache
def _clean_check(card) -> dict:
    return _run(card, 2 ** 31 + 201, 3.0, ONE_CALL)["check"]


@pytest.mark.card
@pytest.mark.parametrize("seed", [2 ** 31 + 101, 2 ** 31 + 102,
                                  2 ** 31 + 103])
def test_control_fails_at_the_cells_size(seed, card):
    limits = harness.Spec().limits(WORKLOAD)
    r = _run(card, seed, 9.0, control=True)
    assert r["correct"], r["check"]
    assert any(r["_control"][k] > v for k, v in limits.items()), \
        r["_control"]


@pytest.mark.card
@pytest.mark.parametrize("fault", cond_faults.FAULTS, ids=cond_faults.IDS)
def test_fault_breaks_a_limit_at_the_cells_size(fault, card, monkeypatch):
    clean = _clean_check(card)
    with monkeypatch.context() as m:
        fault(m)
        faulty = _run(card, 2 ** 31 + 201, 3.0, ONE_CALL)["check"]
    broken = cond_faults.broken_limits(clean, faulty)
    print(f"{fault.__name__} breaks {sorted(broken)}")
    assert broken, faulty
