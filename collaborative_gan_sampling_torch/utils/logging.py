"""Structured JSONL metrics writer.

Counterpart of ``collaborative_gan_sampling_tpu/utils/logging.py``: one JSON
line per event, with the step and the seconds since the writer opened, and
an optional TensorBoard mirror (``tensorboard_dir``): every numeric key of
an event but ``step`` as a scalar at that step, through
``torch.utils.tensorboard.SummaryWriter``, imported only when a mirror is
asked for. The JAX package writes the same tags, steps and values as TF2
tensor events; this writes ``simple_value`` scalars.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import IO, Any


def _to_py(v: Any) -> Any:
    # 0-d tensors and numpy scalars -> python scalars (one host read each).
    if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
        return v.item()
    if hasattr(v, "tolist"):
        return v.tolist()
    return v


class MetricsWriter:
    """Append-only JSONL writer: one event per line with step + wall time."""

    def __init__(self, path: str | None = None, echo: bool = True,
                 tensorboard_dir: str | None = None, append: bool = True):
        """``append=False`` truncates an existing log: a run that starts
        from scratch (step 0) passes it, so that a retrain leaves no stale
        first run in the file (readers assume monotonic steps)."""
        self._fh: IO[str] | None = None
        self._echo = echo
        self._t0 = time.time()
        self._tb = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a" if append else "w", buffering=1)
        if tensorboard_dir:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(tensorboard_dir)

    def write(self, step: int, **metrics: Any) -> None:
        event = {"step": int(step), "t": round(time.time() - self._t0, 3)}
        event.update({k: _to_py(v) for k, v in metrics.items()})
        line = json.dumps(event)
        if self._fh is not None:
            self._fh.write(line + "\n")
        if self._tb is not None:
            for k, v in event.items():
                if k != "step" and isinstance(v, (int, float)):
                    self._tb.add_scalar(k, v, int(step))
        if self._echo:
            print(line, file=sys.stderr)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        if self._tb is not None:
            self._tb.close()
            self._tb = None

    def __enter__(self) -> "MetricsWriter":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
