"""Timing and tracing.

Counterpart of ``collaborative_gan_sampling_tpu/utils/profiling.py``:
``block`` waits for the device work behind a tree of tensors, ``timeit``
times a function with its warm-up calls excluded, and ``trace`` records a
``torch.profiler`` trace (CPU activity, and CUDA activity where a card is
present) and writes it into a directory as a Chrome trace
(``<host>_<pid>.<ms>.pt.trace.json``, which TensorBoard's profiler plugin
and ``chrome://tracing`` read). ``card_line`` names the card that a
measurement ran on, for the record beside its numbers.

Spans and counters inside the program: ``span(name)`` marks a region of the
sampling paths and ``count(name, n)`` adds to a counter (``host_syncs``:
the device-to-host reads). Both record only while a ``torch.profiler``
session records, and never while a graph is traced (``torch.compile``, or
inside ``suspended()``, which ``sampling/export.py`` opens around its
``make_fx`` trace). Off, ``span`` returns one shared no-op context: no
``record_function``, no allocation, no clock read. On, a span enters
``torch.profiler.record_function(name)``, so the profiler records it on its
own clock beside the device's records, and its name, start and end
(``time.perf_counter_ns``), its id, its parent's and its root's ids go into
this module's store, with the counters. ``summary()`` reads the store:
count, total and self milliseconds by span name (self: the duration less
what the child spans cover), and the counters; ``records()`` gives the
spans themselves and ``reset()`` empties the store. Spans nest on one
thread, as the sampling paths run. Inside ``tallied()`` the counts go to
a tally instead, profiler or not: what a CUDA graph's capture performs,
which each replay then counts (``sampling/refine.py``).
"""

from __future__ import annotations

import contextlib
import subprocess
import time
from typing import Any, Callable, NamedTuple

import torch


def _tensors(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def block(tree: Any) -> Any:
    """Wait until the work that produces every tensor in ``tree`` (nested
    dicts, lists and tuples) is done on its device; returns ``tree``."""
    for dev in {t.device for t in _tensors(tree) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return tree


def timeit(fn: Callable[[], Any], warmup: int = 2, iters: int = 10) -> dict:
    """Time ``fn`` (which returns the tensors it computes) over ``iters``
    calls after ``warmup`` untimed ones, each call waited for with
    ``block``: {'mean_s', 'min_s', 'iters'}."""
    for _ in range(warmup):
        block(fn())
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        block(fn())
        times.append(time.perf_counter() - t0)
    return {"mean_s": sum(times) / len(times), "min_s": min(times),
            "iters": iters}


@contextlib.contextmanager
def trace(logdir: str | None):
    """Record the region under ``torch.profiler`` when ``logdir`` is set and
    write its Chrome trace into ``logdir``; otherwise do nothing."""
    if not logdir:
        yield
        return
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


class SpanRecord(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int | None  # the enclosing span's id; None for a root
    root: int  # the outermost enclosing span's id (its own for a root)


class _Store:
    def __init__(self):
        self.spans: list[tuple] = []  # SpanRecord's fields
        self.counters: dict[str, int] = {}
        self.open: list[_Span] = []  # the spans entered and not left
        self.next_id = 0
        self.suspended = 0
        self.tallies: list[dict[str, int]] = []  # innermost last


_STORE = _Store()
_OFF = contextlib.nullcontext()


def _recording() -> bool:
    return (torch._C._autograd._profiler_enabled() and not _STORE.suspended
            and not torch.compiler.is_compiling())


class _Span:
    __slots__ = ("name", "id", "parent", "root", "_rf", "_start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        store = _STORE
        outer = store.open[-1] if store.open else None
        self.id = store.next_id
        store.next_id += 1
        self.parent = outer.id if outer is not None else None
        self.root = outer.root if outer is not None else self.id
        store.open.append(self)
        self._start = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        end = time.perf_counter_ns()
        _STORE.open.pop()
        _STORE.spans.append((self.name, self._start, end, self.id,
                             self.parent, self.root))
        self._rf.__exit__(exc_type, exc, tb)


def span(name: str):
    """A context that records the region as span ``name`` while a profiler
    session records (see the module's docstring); a shared no-op
    otherwise."""
    if not _recording():
        return _OFF
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while a profiler session records;
    inside ``tallied()``, to the innermost tally instead."""
    if _STORE.tallies:
        tally = _STORE.tallies[-1]
        tally[name] = tally.get(name, 0) + n
    elif _recording():
        _STORE.counters[name] = _STORE.counters.get(name, 0) + n


@contextlib.contextmanager
def tallied():
    """Within, every ``count`` adds to the dict this yields and not to the
    store, whether or not a profiler session records: around a CUDA
    graph's capture, whose counts each replay adds."""
    tally: dict[str, int] = {}
    _STORE.tallies.append(tally)
    try:
        yield tally
    finally:
        _STORE.tallies.pop()


@contextlib.contextmanager
def suspended():
    """No span or count records inside, whatever the profiler does: around
    a graph trace that would take a ``record_function`` as graph nodes
    (``make_fx``)."""
    _STORE.suspended += 1
    try:
        yield
    finally:
        _STORE.suspended -= 1


def records() -> list[SpanRecord]:
    """The stored spans, in the order they ended."""
    return [SpanRecord(*r) for r in _STORE.spans]


def summary() -> dict:
    """{'spans': {name: {'count', 'total_ms', 'self_ms'}}, 'counters':
    {name: n}} over the store."""
    recs = records()
    covered: dict[int, int] = {}
    for r in recs:
        if r.parent is not None:
            covered[r.parent] = (covered.get(r.parent, 0)
                                 + r.end_ns - r.start_ns)
    spans: dict[str, dict] = {}
    for r in recs:
        row = spans.setdefault(r.name, {"count": 0, "total_ms": 0.0,
                                        "self_ms": 0.0})
        ns = r.end_ns - r.start_ns
        row["count"] += 1
        row["total_ms"] += ns / 1e6
        row["self_ms"] += (ns - covered.get(r.id, 0)) / 1e6
    return {"spans": spans, "counters": dict(_STORE.counters)}


def reset() -> None:
    """Empty the store of spans and counters."""
    _STORE.spans.clear()
    _STORE.counters.clear()


def _card_uuid(index: int) -> str:
    """The card's UUID as nvidia-smi prints it (``GPU-`` and 8-4-4-4-12
    hex digits)."""
    return "GPU-" + str(torch.cuda.get_device_properties(index).uuid)


def card_line(dev: torch.device) -> str:
    """``"<name>, <power.limit>"`` of the card behind ``dev``, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
    them, or ``str(dev)`` off the card. The row is found by the card's UUID:
    nvidia-smi lists every card in PCI order whatever
    ``CUDA_VISIBLE_DEVICES`` hides, so torch's index may point at another
    card's row. Raises when no row has the UUID."""
    if dev.type != "cuda":
        return str(dev)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    uuid = _card_uuid(index)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=uuid,name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    for row in smi.stdout.splitlines():
        row_uuid, _, rest = row.partition(",")
        if row_uuid.strip() == uuid:
            return rest.strip()
    raise RuntimeError(f"nvidia-smi lists no card with UUID {uuid} "
                       f"(cuda:{index})")
