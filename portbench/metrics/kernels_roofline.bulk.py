"""kernels_roofline.bulk: see :func:`portbench.readers.kernels_roofline`."""

from portbench.readers import kernels_roofline as read  # noqa: F401
