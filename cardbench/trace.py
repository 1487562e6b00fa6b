"""The traced slice: ``torch.profiler`` over a few steady units of the window
(units after the first), read into device busy time, kernel time by name,
host launches, and the device's idle gaps named by what the host was doing.

A profiler session on an H100 has been seen to record none of a kernel's
launches. A session is kept only when every program kernel whose launch
counter moved during it (``cardbench/kernels/*.json``) shows in its device
records; otherwise the next units are profiled in a new session, up to
``SESSIONS`` of them, and the run fails when none is whole.
"""

from __future__ import annotations

import bisect
import importlib
import json
from dataclasses import dataclass, field
from pathlib import Path

SESSIONS = 3
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchCooperativeKernel")
UNIT_SPAN = "cardbench.unit"
MIN_GAP_US = 1.0


def kernel_specs(root: Path) -> dict:
    """name -> {'counter': 'module:function', 'device_name': str}."""
    return {p.stem: json.loads(p.read_text())
            for p in sorted((root / "kernels").glob("*.json"))}


def counter(spec: dict) -> int:
    module, attr = spec["counter"].split(":")
    return getattr(importlib.import_module(module), attr).launches


def short_name(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(")[0][:64]


@dataclass
class TraceReading:
    slice_s: float
    busy_s: float
    launches: int
    units: list  # the units' records (counts) the slice covered
    kernels: dict  # short kernel name -> [device seconds, records]
    gaps: dict  # host op -> idle device seconds
    moved: dict = field(default_factory=dict)  # kernel spec -> launches

    def kernel(self, device_name: str) -> tuple[float, int]:
        """(device seconds, records) of one kernel."""
        secs, n = self.kernels.get(device_name, (0.0, 0))
        return secs, n

    def batches(self) -> int:
        return sum(u["batches"] for u in self.units)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def analyse(prof, units: list, moved: dict, specs: dict) -> TraceReading | None:
    """The slice's reading, or None when a moved kernel has no record."""
    from torch.autograd import DeviceType

    device, host, spans = [], [], []
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                device.append((start, end, short_name(e.name)))
        elif e.name == UNIT_SPAN:
            spans.append((start, end))
        else:
            host.append((start, end, e.name))
    if not spans or not device:
        return None
    lo, hi = min(s for s, _ in spans), max(e for _, e in spans)
    kernels = {}
    for s, e, name in device:
        row = kernels.setdefault(name, [0.0, 0])
        row[0] += (e - s) / 1e6
        row[1] += 1
    for name, n in moved.items():
        if n and specs[name]["device_name"] not in kernels:
            return None
    merged = _merge([(max(s, lo), min(e, hi)) for s, e, _ in device
                     if e > lo and s < hi])
    busy = sum(e - s for s, e in merged)
    launches = sum(1 for s, _, name in host
                   if lo <= s <= hi and name.startswith(LAUNCH_CALLS))
    host.sort()
    starts = [s for s, _, _ in host]
    gaps = {}
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    for g0, g1 in zip(edges[::2], edges[1::2]):
        if g1 - g0 < MIN_GAP_US:
            continue
        label = _host_op(host, starts, (g0 + g1) / 2)
        gaps[label] = gaps.get(label, 0.0) + (g1 - g0) / 1e6
    return TraceReading(slice_s=(hi - lo) / 1e6, busy_s=busy / 1e6,
                        launches=launches, units=units, kernels=kernels,
                        gaps=gaps, moved=moved)


def _host_op(host, starts, t, scan: int = 512) -> str:
    """The innermost host op running at t (the latest-starting one that
    still runs), or 'python between ops' where none runs."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 1 - scan), -1):
        s, e, name = host[j]
        if e >= t:
            return name
    return "python between ops"


def breakdown(reading: TraceReading) -> dict:
    ops = sorted(reading.kernels.items(), key=lambda kv: -kv[1][0])[:10]
    gaps = sorted(reading.gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v[0]] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}
