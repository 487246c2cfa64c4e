"""Deterministic network conditioning & fault injection (in-transport netem
analog).  See :mod:`mochi_tpu_torch.netsim.sim` and docs/OPERATIONS.md
§"Network conditioning"."""

from .sim import LinkEvent, LinkPolicy, LinkSpec, NetSim

__all__ = ["LinkEvent", "LinkPolicy", "LinkSpec", "NetSim"]
