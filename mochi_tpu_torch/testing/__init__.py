"""Test harnesses.  ``VirtualCluster`` (an in-process cluster) is ported;
the process cluster, Byzantine harnesses, invariant checker and scenario
engine of the JAX package are not yet."""

from .virtual_cluster import VirtualCluster

__all__ = ["VirtualCluster"]
