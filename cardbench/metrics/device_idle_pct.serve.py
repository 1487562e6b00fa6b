"""The device idle: 1 - the union of device intervals over the traced slice."""

from cardbench.readers import device_idle_pct as read  # noqa: F401
