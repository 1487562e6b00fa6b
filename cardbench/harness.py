"""The benchmark of the PyTorch / CUDA port, driven by data.

``BENCHMARK.json`` names each cell's configuration and traffic mix; the
harness finds everything else by those names:

* ``configs/<config>.json``: the preset, the model and refine settings as
  run, the source, ``reduced`` and ``assumed``;
* ``traffic/<mix>.json``: the parameters of a mix, read by the entry it
  names (``"entry"``);
* ``entries/<entry>.py``: a general loop that drives one of the port's
  entry points, its plain reference and the numbers its check compares
  (class ``Entry``; ``dcgan_entry.py`` says what it offers);
* ``limits/<workload>.json``: the limit of each number the output check
  compares;
* ``metrics/<metric>.py``: one reader per metric, ``read(reading)`` ->
  a number, or None where the cell has nothing to read;
* ``kernels/<kernel>.json``: a program kernel's launch counter and its
  device name, for the profiler's retry rule (``trace.py``).

A run: seed weights and images made on the card (``inputs.py``), the
program's pair loaded with them, the cell's shapes warmed (set-up), then
back-to-back units (calls or requests) for ``seconds``. The units that
start inside the window are all counted, and the window ends when the last
of them does. With ``trace`` the profiler covers a slice of units after the
first. Then the program's state is freed and the kept outputs are judged
against the entry's plain reference (``reference/``), which replays them
from the same inputs.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import random
import sys
import time
import traceback
from contextlib import nullcontext
from pathlib import Path

import torch

from cardbench import inputs
from cardbench import trace as tracing

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "collaborative_gan_sampling_tpu")
TRACE_SLICE_S = 0.5
TRACE_MAX_UNITS = 20


def forbidden_modules(names) -> list[str]:
    """The forbidden packages among module names, by whole top-level name."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


class Spec:
    """``BENCHMARK.json`` and the files it names, found by name."""

    def __init__(self, root: Path = HERE, bench: dict | None = None):
        self.root = root
        self.bench = bench or json.loads(
            (root.parent / "BENCHMARK.json").read_text())

    def workload(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def _json(self, kind: str, name: str) -> dict:
        return json.loads((self.root / kind / f"{name}.json").read_text())

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def mix(self, name: str) -> dict:
        return self._json("traffic", name)

    def limits(self, workload: str) -> dict:
        return self._json("limits", workload)

    def metrics(self, workload: str, traced: bool) -> list[dict]:
        """The cell's metrics: its end-to-end ones untraced, its per-layer
        ones traced (each listed for it, or for every cell)."""
        group = self.bench["per_layer" if traced else "end_to_end"]
        return [m for m in group
                if workload in m.get("workloads", [workload])]

    def _module(self, kind: str, name: str):
        path = self.root / kind / f"{name}.py"
        mod_name = f"cardbench_{kind}_" + "".join(
            c if c.isalnum() else "_" for c in name)
        spec = importlib.util.spec_from_file_location(mod_name, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    def reader(self, metric: str):
        return self._module("metrics", metric).read

    def entry(self, name: str):
        """The class ``Entry`` of ``entries/<name>.py``."""
        return self._module("entries", name).Entry


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    seed: int
    device: torch.device

    @property
    def model(self) -> dict:
        return self.config["model"]

    @property
    def refine(self) -> dict:
        return self.config["refine"]

    @property
    def batch(self) -> int:
        """Candidates a refinement launch takes."""
        return self.mix.get("batch", self.refine["batch_size"])

    def generator(self, *tags) -> torch.Generator:
        return inputs.generator(self.seed, self.device, *tags)

    def rng(self, *tags) -> random.Random:
        return random.Random(inputs.subseed(self.seed, *tags))


def make_cell(spec: Spec, workload: str, seed: int, device: torch.device,
              overrides: dict | None = None) -> Cell:
    """The cell; ``overrides`` ({'refine': {...}, 'mix': {...}}) shrink it
    for the CPU tests."""
    w = spec.workload(workload)
    config, mix = spec.config(w["config"]), spec.mix(w["traffic"])
    overrides = overrides or {}
    config = dict(config, refine=dict(config["refine"],
                                      **overrides.get("refine", {})))
    mix = dict(mix, **overrides.get("mix", {}))
    return Cell(workload, config, mix, seed, device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# The window, the traced slice, and the reading the metric readers take.
# ---------------------------------------------------------------------------


class _Session:
    """One profiler session over a few units; read after the window."""

    def __init__(self, specs: dict, device: torch.device):
        from torch.profiler import ProfilerActivity, profile

        self.specs, self.device = specs, device
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.before = {k: tracing.counter(s) for k, s in specs.items()}
        self.units: list = []
        self.prof.start()
        self.t0 = time.perf_counter()

    def span(self):
        return torch.profiler.record_function(tracing.UNIT_SPAN)

    def full(self, rec: dict) -> bool:
        self.units.append(rec)
        return (time.perf_counter() - self.t0 >= TRACE_SLICE_S
                or len(self.units) >= TRACE_MAX_UNITS)

    def stop(self) -> None:
        _sync(self.device)
        self.prof.stop()
        self.moved = {k: tracing.counter(s) - self.before[k]
                      for k, s in self.specs.items()}

    def read(self) -> tracing.TraceReading | None:
        return tracing.analyse(self.prof, self.units, self.moved, self.specs)


def run_window(entry, seconds: float, traced: bool) -> dict:
    """Units back to back from t0: those that start before t0 + seconds make
    the window, which ends with the last of them. A traced run profiles
    units from the second on (TRACE_SLICE_S of them) and reads the session
    after the window; a session that is not whole is followed by another
    over further units, past the window, up to ``tracing.SESSIONS``."""
    dev = entry.cell.device
    specs = tracing.kernel_specs(HERE) if traced else {}
    units, sessions, session = [], [], None

    def unit(i: int, in_window: bool) -> dict:
        rec = {"index": i, "in_window": in_window,
               "traced": session is not None}
        t_unit = time.perf_counter()
        try:
            with session.span() if session is not None else nullcontext():
                rec.update(entry.run_one(i))
        except Exception:  # a failed unit counts and the loop goes on
            traceback.print_exc()
            rec["failed"] = True
        rec["t0"], rec["t1"] = t_unit, time.perf_counter()
        units.append(rec)
        return rec

    t0 = time.perf_counter()
    i = 0
    while i == 0 or time.perf_counter() - t0 < seconds:
        if traced and session is None and not sessions and i >= 1:
            session = _Session(specs, dev)
        rec = unit(i, True)
        i += 1
        if session is not None and session.full(rec):
            session.stop()
            sessions.append(session)
            session = None
    window_s = units[-1]["t1"] - t0
    if session is not None:
        session.stop()
        sessions.append(session)
        session = None
    reading, tries = None, 0
    while traced and reading is None:
        if sessions:
            reading = sessions.pop(0).read()
            tries += 1
            continue
        if tries >= tracing.SESSIONS:
            raise RuntimeError(
                f"{tries} profiler sessions recorded no device work or "
                "dropped a launched kernel's records")
        session = _Session(specs, dev)
        while not session.full(unit(i, False)):
            i += 1
        i += 1
        session.stop()
        sessions.append(session)
        session = None
    return {"units": [u for u in units if u["in_window"]],
            "window_s": window_s, "trace": reading}


@dataclasses.dataclass
class Reading:
    """What a metric reader reads: the cell, set-up, the window's units and
    the traced slice."""

    cell: Cell
    setup_s: float
    window_s: float
    units: list
    trace: tracing.TraceReading | None

    def total(self, key: str, untraced: bool = False) -> float:
        return sum(u.get(key, 0) for u in self.units
                   if not (untraced and u["traced"]) and not u.get("failed"))

    def untraced_s(self) -> float:
        return sum(u["t1"] - u["t0"] for u in self.units if not u["traced"])

    def latencies_ms(self) -> list[float]:
        return [math.inf if u.get("failed") else u["latency_ms"]
                for u in self.units]


def compare(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {value, limit}}) over the numbers that have a limit:
    each at or under it; a missing number, or none at all, is not
    correct."""
    rows = {k: {"value": numbers.get(k, math.inf), "limit": v}
            for k, v in limits.items()}
    ok = bool(numbers) and all(r["value"] <= r["limit"] for r in rows.values())
    return ok, rows


def _finite(v):
    return v if v is not None and math.isfinite(v) else None


def run_cell(spec: Spec, workload: str, seed: int, seconds: float,
             traced: bool, t_process: float, device: torch.device | None = None,
             overrides: dict | None = None, control: bool = False) -> dict:
    """One run of a cell; returns the result line's object, plus the
    control's numbers under 'control' when asked."""
    device = device or torch.device("cuda", 0)
    t_entry = time.perf_counter()
    cell = make_cell(spec, workload, seed, device, overrides)
    entry = spec.entry(cell.mix["entry"])(cell)
    _sync(device)
    t_warm = time.perf_counter()
    entry.warm()
    _sync(device)
    # What set-up made stays for the run: frozen, the ~170,000 objects of
    # torch and the port are not scanned again by collections in the window,
    # each of which would otherwise pause the host for a tenth of a second.
    # Objects that the window allocates are collected as they would be.
    gc.collect()
    gc.freeze()
    t_window = time.perf_counter()
    setup_s = t_window - t_process
    print(f"setup: {t_entry - t_process:.3f} s to the cell, "
          f"{t_warm - t_entry:.3f} s inputs and the program's pair, "
          f"{t_window - t_warm:.3f} s warm-up", file=sys.stderr)
    win = run_window(entry, seconds, traced)
    gc.unfreeze()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    entry.free_program()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers, ctrl = entry.judge(control)
    failed = sum(1 for u in win["units"] if u.get("failed"))
    correct, check = compare(numbers, spec.limits(workload))
    reading = Reading(cell, setup_s, win["window_s"], win["units"],
                      win["trace"])
    metrics = {}
    for m in spec.metrics(workload, traced):
        value = _finite(spec.reader(m["name"])(reading))
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else str(device)),
                "count": 1, "memory_peak_bytes": peak}
    if traced and win["trace"] is not None:
        dev_info.update(busy_s=win["trace"].busy_s,
                        window_s=win["trace"].slice_s)
    result = {"correct": correct and failed == 0,
              "attempted": len(win["units"]), "failed": failed,
              "metrics": metrics, "device": dev_info}
    if traced and win["trace"] is not None:
        result["breakdown"] = tracing.breakdown(win["trace"])
    result["check"] = check
    result["_numbers"], result["_control"] = numbers, ctrl
    return result


def print_result(result: dict) -> None:
    """The result line, ``check`` last, after each compared number beside
    its limit on standard error."""
    line = {k: v for k, v in result.items() if not k.startswith("_")}
    for row in line["check"].values():
        if not math.isfinite(row["value"]):
            row["value"] = str(row["value"])
    for name, row in line["check"].items():
        print(f"check {name} {row['value']} limit {row['limit']}",
              file=sys.stderr)
    print(json.dumps(line))
