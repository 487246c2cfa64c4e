"""step_p95_ms: see :func:`portbench.readers.step_p95_ms`."""

from portbench.readers import step_p95_ms as read  # noqa: F401
