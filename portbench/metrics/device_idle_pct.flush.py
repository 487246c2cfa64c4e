"""device_idle_pct.flush: see :func:`portbench.readers.device_idle_pct`."""

from portbench.readers import device_idle_pct as read  # noqa: F401
