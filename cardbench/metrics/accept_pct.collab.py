"""Accepted over candidates, burn-in included (sampling/rejection.py, ops/accept.py)."""

from cardbench.readers import accept_pct as read  # noqa: F401
