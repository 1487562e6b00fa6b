"""95th percentile of the latency of every request of the window, from the call to the samples on the host."""

from cardbench.readers import p95_ms as read  # noqa: F401
