"""Timing and tracing.

Counterpart of ``collaborative_gan_sampling_tpu/utils/profiling.py``:
``block`` waits for the device work behind a tree of tensors, ``timeit``
times a function with its warm-up calls excluded, and ``trace`` records a
``torch.profiler`` trace (CPU activity, and CUDA activity where a card is
present) and writes it into a directory as a Chrome trace
(``<host>_<pid>.<ms>.pt.trace.json``, which TensorBoard's profiler plugin
and ``chrome://tracing`` read).
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable

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
