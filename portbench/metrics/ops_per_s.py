"""ops_per_s: see :func:`portbench.readers.ops_per_s`."""

from portbench.readers import ops_per_s as read  # noqa: F401
