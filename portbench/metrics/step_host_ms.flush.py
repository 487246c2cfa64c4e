"""step_host_ms.flush: see :func:`portbench.readers.step_host_ms`."""

from portbench.readers import step_host_ms as read  # noqa: F401
