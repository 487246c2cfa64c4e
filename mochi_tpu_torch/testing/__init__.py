"""Test harnesses.  ``VirtualCluster`` (an in-process cluster),
``ProcessCluster`` (replicas in real ``python -m mochi_tpu_torch.server``
processes) and the invariant checker are ported; the Byzantine harnesses and
the scenario engine of the JAX package are not yet."""

from .invariants import InvariantChecker
from .process_cluster import ProcessCluster
from .virtual_cluster import VirtualCluster

__all__ = ["InvariantChecker", "ProcessCluster", "VirtualCluster"]
