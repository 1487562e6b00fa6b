"""Retries of transient backend failures around long units of work.

Counterpart of ``collaborative_gan_sampling_tpu/utils/retry.py``, with its
control flow: ``with_retries`` runs ``fn()`` and retries an error that
``is_transient_backend_error`` accepts, with a linear backoff, up to
``retries`` times; any other error re-raises at once. Held to the JAX
package's cases in ``tests/test_torch_tune.py``.

On the card the transient errors are those of ``torch.distributed``'s
rendezvous and store (``DistNetworkError``, ``DistStoreError``) whose
message carries one of the JAX package's markers: a dropped connection to
another process. A CUDA error is never transient: it leaves the device's
context unusable, so no retry in the same process can succeed.
"""

from __future__ import annotations

import time
from typing import Callable, TypeVar

T = TypeVar("T")

_TRANSIENT_MARKERS = (
    "remote_compile",
    "response body closed",
    "INTERNAL",
    "UNAVAILABLE",
    "DEADLINE_EXCEEDED",
    "Connection reset",
    "Socket closed",
)
# By name, as the JAX package matches its own backend's errors:
# torch.distributed's network and store errors.
_TRANSIENT_TYPES = ("DistNetworkError", "DistStoreError")


def is_transient_backend_error(err: BaseException) -> bool:
    """True for a ``torch.distributed`` network or store error whose
    message names a dropped connection or a timeout."""
    if type(err).__name__ not in _TRANSIENT_TYPES:
        return False
    msg = str(err)
    return any(m in msg for m in _TRANSIENT_MARKERS)


def with_retries(fn: Callable[[], T], retries: int = 3,
                 backoff_s: float = 30.0, label: str = "",
                 _sleep: Callable[[float], None] | None = None) -> T:
    """Run ``fn()``, retrying transient backend errors after ``backoff_s``
    times the attempt's number of seconds. Other errors propagate at once;
    the last transient one propagates after ``retries`` retries."""
    if _sleep is None:
        _sleep = time.sleep  # bound at call time so tests can patch it
    attempt = 0
    while True:
        try:
            return fn()
        except Exception as err:  # noqa: BLE001 — filtered below
            if not is_transient_backend_error(err) or attempt >= retries:
                raise
            attempt += 1
            print(f"[retry] transient backend error"
                  f"{f' ({label})' if label else ''} — "
                  f"attempt {attempt}/{retries}, backing off "
                  f"{backoff_s * attempt:.0f}s: {str(err)[:120]}",
                  flush=True)
            _sleep(backoff_s * attempt)
