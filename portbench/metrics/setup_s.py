"""setup_s: see :func:`portbench.readers.setup_s`."""

from portbench.readers import setup_s as read  # noqa: F401
