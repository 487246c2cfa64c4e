"""Test harnesses: ``VirtualCluster`` (an in-process cluster),
``ProcessCluster`` (replicas in real ``python -m mochi_tpu_torch.server``
processes), the invariant checker, the Byzantine replica and client
harnesses, and (as submodules) the schedule explorer ``testing.schedule``
and the scenario engine ``testing.scenario``."""

from .byzantine import STRATEGIES, AttackStrategy, ByzantineReplica, make_strategy
from .byzantine_client import CLIENT_STRATEGIES, ByzantineClient
from .invariants import InvariantChecker
from .process_cluster import ProcessCluster
from .virtual_cluster import VirtualCluster

__all__ = [
    "AttackStrategy",
    "ByzantineClient",
    "ByzantineReplica",
    "CLIENT_STRATEGIES",
    "InvariantChecker",
    "ProcessCluster",
    "STRATEGIES",
    "VirtualCluster",
    "make_strategy",
]
