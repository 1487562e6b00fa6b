"""Host kernel launches per batch of candidates in the traced slice (sampling/collab.py)."""

from cardbench.readers import launches_per_batch as read  # noqa: F401
