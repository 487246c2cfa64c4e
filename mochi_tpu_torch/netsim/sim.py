"""netsim: deterministic in-transport network conditioning & fault injection.

A netem analog that lives inside the asyncio transport — no root, no OS
``tc qdisc``, no separate proxy processes.  Every *directed* logical link
(``src -> dst``, endpoint labels like ``client-0`` / ``server-3``) gets a
:class:`LinkPolicy`: a seeded RNG stream drawing per-frame latency (base +
jitter), drop, reorder and bandwidth-serialization decisions, plus a live
up/down state driven by a :class:`LinkEvent` schedule (partition at t,
heal at t+Δ, degrade one replica's uplink).  The policy is enforced at the
``_FramedProtocol`` frame seams in ``net/transport.py``: the *initiator*
of a connection applies the ``A -> B`` policy to the frames it sends
(egress) and the ``B -> A`` policy to the frames it receives (ingress), so
one connection models both directions of its link and servers need no
peer-identity guessing — the exact same conditioning therefore applies to
``RpcServer`` responses, ``RpcClientPool`` requests and ``fan_out`` legs.

Why frames, not bytes: the sim rides *above* a real kernel socket
(loopback TCP or UDS), which already guarantees ordered byte delivery —
dropping mid-stream bytes would corrupt length-prefixed framing and read
as peer misbehavior, not loss.  Dropping whole frames models message loss
the way the protocol actually experiences WAN loss: a request or response
that never arrives, recovered by client timeout + retry.

Determinism: each directed link's RNG is seeded from
``sha256(seed, src, dst)`` — the same cluster seed reproduces the exact
per-link delay/drop/reorder *sequence* run over run, independent of link
creation order and of every other link's traffic.  (Wall-clock arrival
times still depend on host scheduling; the drawn conditioning plan does
not.)

Counters ride a :class:`~mochi_tpu_torch.utils.metrics.Metrics` registry owned
by the :class:`NetSim` (``netsim.link.<src>-><dst>.{frames,delivered,
dropped,delayed,reordered}`` counters + ``...queue_depth`` gauges), so the
admin surfaces (``/status``, ``/metrics.prom``) render them with the same
machinery as every other metric.
"""

from __future__ import annotations

import asyncio
import hashlib
import random
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..utils.metrics import Metrics

__all__ = ["LinkSpec", "LinkEvent", "LinkPolicy", "NetSim"]

# The event loop's systematic timer overshoot, compensated at arming time
# (LinkPolicy.send): CPython's epoll selector rounds its poll timeout UP
# to whole milliseconds (selectors.EpollSelector), then the loop
# dispatches — a call_later fires ~0.5-0.8 ms LATE, so every simulated
# hop silently inflates by most of a timer quantum.  Half a quantum is
# the expected ceiling error; the residual dispatch cost stays, keeping
# compensated arrivals slightly late (never early) on average.
_TIMER_SLACK_S = 5e-4


@dataclass(frozen=True)
class LinkSpec:
    """Conditioning parameters for ONE direction of a link.

    ``delay_ms``/``jitter_ms`` are one-way figures: a symmetric RTT of
    13 ms is ``delay_ms=6.5`` on each direction (:meth:`NetSim.mesh` does
    that split).  ``drop``/``reorder`` are per-frame probabilities;
    ``bandwidth_bps`` (0 = unlimited) adds store-and-forward serialization
    delay of ``8*len(frame)/bandwidth_bps`` seconds per frame, queued
    behind the link's previous departures.
    """

    delay_ms: float = 0.0
    jitter_ms: float = 0.0
    drop: float = 0.0
    reorder: float = 0.0
    bandwidth_bps: float = 0.0

    @property
    def is_noop(self) -> bool:
        return (
            self.delay_ms == 0.0
            and self.jitter_ms == 0.0
            and self.drop == 0.0
            and self.reorder == 0.0
            and self.bandwidth_bps == 0.0
        )


@dataclass(frozen=True)
class LinkEvent:
    """One scheduled link-state change, ``at_s`` seconds after
    :meth:`NetSim.ensure_started`.  ``src``/``dst`` are endpoint labels or
    ``"*"`` wildcards — ``("server-2", "*")`` is server-2's uplink,
    ``("*", "server-2")`` its downlink, both together a full partition.

    kinds: ``down`` (frames dropped), ``up`` (clears ``down``),
    ``set`` (replace the matching links' spec with ``spec``),
    ``reset`` (restore the topology's base spec).
    """

    at_s: float
    kind: str  # "down" | "up" | "set" | "reset"
    src: str = "*"
    dst: str = "*"
    spec: Optional[LinkSpec] = None

    def matches(self, src: str, dst: str) -> bool:
        return self.src in ("*", src) and self.dst in ("*", dst)


class LinkPolicy:
    """Conditioning state for one directed link; scheduling happens on the
    running event loop via ``call_later`` (never blocking it).

    ``send(deliver, frame)`` either delivers inline (no-op spec, empty
    queue — the cheap path), drops, or schedules ``deliver(frame)`` at the
    drawn arrival time.  FIFO order is preserved per link (an arrival
    never lands before its predecessor's) unless the reorder draw fires,
    in which case the frame is held one extra propagation delay and
    *may* be overtaken by its successors — the netem reorder analog.
    """

    __slots__ = (
        "sim", "src", "dst", "name", "spec", "base_spec", "down", "rng",
        "_busy_until", "_last_arrival", "_pending",
        "_k_frames", "_k_delivered", "_k_dropped", "_k_delayed",
        "_k_reordered", "_k_lost", "_k_depth",
    )

    def __init__(self, sim: "NetSim", src: str, dst: str, spec: LinkSpec):
        self.sim = sim
        self.src = src
        self.dst = dst
        self.name = f"{src}->{dst}"
        self.spec = spec
        self.base_spec = spec
        self.down = False
        digest = hashlib.sha256(
            f"{sim.seed}:{src}->{dst}".encode()
        ).digest()
        self.rng = random.Random(int.from_bytes(digest[:8], "big"))
        self._busy_until = 0.0       # bandwidth serialization horizon
        self._last_arrival = 0.0     # FIFO floor for in-order delivery
        self._pending: set = set()   # outstanding TimerHandles
        prefix = f"netsim.link.{self.name}."
        self._k_frames = prefix + "frames"
        self._k_delivered = prefix + "delivered"
        self._k_dropped = prefix + "dropped"
        self._k_delayed = prefix + "delayed"
        self._k_reordered = prefix + "reordered"
        self._k_lost = prefix + "lost"
        self._k_depth = prefix + "queue_depth"

    # ------------------------------------------------------------- planning

    def plan(self, n_bytes: int, now: float) -> Tuple[str, float]:
        """Draw this frame's fate: ``("drop", 0)``, or ``("deliver"|
        "reorder", delay_s)``.  Pure function of the link's RNG stream and
        queue state — the unit-testable deterministic core (same seed =>
        identical sequence of (fate, delay) tuples for the same frame
        sizes)."""
        spec = self.spec
        if self.down:
            return "drop", 0.0
        if spec.drop > 0.0 and self.rng.random() < spec.drop:
            return "drop", 0.0
        delay = spec.delay_ms / 1e3
        if spec.jitter_ms > 0.0:
            delay += self.rng.uniform(-spec.jitter_ms, spec.jitter_ms) / 1e3
            if delay < 0.0:
                delay = 0.0
        if spec.bandwidth_bps > 0.0:
            depart = max(now, self._busy_until) + (
                8.0 * n_bytes / spec.bandwidth_bps
            )
            self._busy_until = depart
            arrival = depart + delay
        else:
            arrival = now + delay
        if spec.reorder > 0.0 and self.rng.random() < spec.reorder:
            # Held back one extra propagation delay and EXEMPT from the
            # FIFO floor: successors drawn with smaller delays overtake it.
            return "reorder", (arrival - now) + max(delay, 1e-4)
        if arrival < self._last_arrival:
            arrival = self._last_arrival
        self._last_arrival = arrival
        return "deliver", arrival - now

    # ------------------------------------------------------------- data path

    def send(self, deliver: Callable[[bytes], None], frame: bytes) -> None:
        """Condition one frame; ``deliver`` runs inline (fast path) or via
        ``call_later`` at the planned arrival."""
        counters = self.sim.metrics.counters
        counters[self._k_frames] += 1
        if not self.down and self.spec.is_noop and not self._pending:
            self._count_delivery(deliver(frame))
            return
        loop = asyncio.get_running_loop()
        fate, delay = self.plan(len(frame), loop.time())
        if fate == "drop":
            counters[self._k_dropped] += 1
            return
        if fate == "reorder":
            counters[self._k_reordered] += 1
        if delay <= 0.0 and not self._pending:
            self._count_delivery(deliver(frame))
            return
        counters[self._k_delayed] += 1
        handle_box: List = []
        # Arm the timer EARLY by the loop's systematic overshoot: the
        # epoll-backed selector rounds its poll timeout UP to whole
        # milliseconds and the loop then dispatches, so call_later fires
        # ~0.5-0.8 ms late (measured: a 6.5 ms one-way link delivers at
        # ~7.3 ms, turning a claimed 13 ms RTT into 14.5 on the wire).  A
        # simulator standing in for a real WAN must not inflate every hop
        # by the host's timer quantum; the DRAWN delay (the determinism
        # surface) is unchanged — only the arming compensates.
        handle = loop.call_later(
            max(0.0, delay - _TIMER_SLACK_S), self._arrive, handle_box,
            deliver, frame,
        )
        handle_box.append(handle)
        self._pending.add(handle)
        self.sim.metrics.set_gauge(self._k_depth, len(self._pending))

    def _count_delivery(self, outcome) -> None:
        """``deliver`` callbacks may report a frame as un-deliverable by
        returning False (egress to a transport that closed while the frame
        was in flight — the network analog of loss-at-the-far-end); count
        those as ``lost``, never ``delivered`` — "delivered == frames" is
        the evidence records' lossless-mesh observable and must not lie."""
        if outcome is False:
            self.sim.metrics.counters[self._k_lost] += 1
        else:
            self.sim.metrics.counters[self._k_delivered] += 1

    def _arrive(self, handle_box: List, deliver: Callable[[bytes], None], frame: bytes) -> None:
        self._pending.discard(handle_box[0])
        self.sim.metrics.set_gauge(self._k_depth, len(self._pending))
        self._count_delivery(deliver(frame))

    def close(self) -> None:
        for handle in self._pending:
            handle.cancel()
        self._pending.clear()
        self.sim.metrics.set_gauge(self._k_depth, 0)

    def stats(self) -> Dict[str, float]:
        c = self.sim.metrics.counters
        return {
            "frames": c[self._k_frames],
            "delivered": c[self._k_delivered],
            "dropped": c[self._k_dropped],
            "delayed": c[self._k_delayed],
            "reordered": c[self._k_reordered],
            "lost": c[self._k_lost],
            "queue_depth": len(self._pending),
            "down": self.down,
        }


class NetSim:
    """Topology + schedule + per-link policy registry for one cluster.

    Link spec resolution for ``src -> dst``, most specific wins:
    exact ``(src, dst)`` override, then ``("*", dst)``, then
    ``(src, "*")``, then the topology default.  ``enabled=False`` keeps
    the object (and its API surface) but hands out no policies — the
    transports take their ``link is None`` fast path, which is the
    passthrough leg of the A/B overhead bound.
    """

    def __init__(
        self,
        seed: int = 0,
        default: Optional[LinkSpec] = None,
        links: Optional[Dict[Tuple[str, str], LinkSpec]] = None,
        schedule: Sequence[LinkEvent] = (),
        enabled: bool = True,
    ):
        self.seed = seed
        self.default = default if default is not None else LinkSpec()
        self.links = dict(links) if links else {}
        self.schedule: List[LinkEvent] = sorted(schedule, key=lambda e: e.at_s)
        self.enabled = enabled
        self.metrics = Metrics()
        self._policies: Dict[Tuple[str, str], LinkPolicy] = {}
        # Schedule state that must also apply to links created LATER (links
        # materialize lazily on first connection): active down patterns and
        # spec overrides, in application order.
        self._down_patterns: List[Tuple[str, str]] = []
        self._spec_patterns: List[Tuple[str, str, Optional[LinkSpec]]] = []
        self._timers: List[asyncio.TimerHandle] = []
        self._started = False

    @classmethod
    def mesh(
        cls,
        seed: int = 0,
        rtt_ms: float = 0.0,
        jitter_ms: float = 0.0,
        drop: float = 0.0,
        reorder: float = 0.0,
        bandwidth_bps: float = 0.0,
        schedule: Sequence[LinkEvent] = (),
        links: Optional[Dict[Tuple[str, str], LinkSpec]] = None,
        enabled: bool = True,
    ) -> "NetSim":
        """Full-mesh topology from round-trip figures: every directed link
        gets half the RTT (and half the RTT jitter) one-way, so a
        request/response pair sums back to ``rtt_ms ± ~jitter_ms``."""
        default = LinkSpec(
            delay_ms=rtt_ms / 2.0,
            jitter_ms=jitter_ms / 2.0,
            drop=drop,
            reorder=reorder,
            bandwidth_bps=bandwidth_bps,
        )
        return cls(
            seed=seed, default=default, links=links,
            schedule=schedule, enabled=enabled,
        )

    # ------------------------------------------------------------- policies

    def _resolve_spec(self, src: str, dst: str) -> LinkSpec:
        for key in ((src, dst), ("*", dst), (src, "*")):
            spec = self.links.get(key)
            if spec is not None:
                return spec
        return self.default

    def policy(self, src: str, dst: str) -> Optional[LinkPolicy]:
        """Get-or-create the directed-link policy (None when disabled)."""
        if not self.enabled:
            return None
        key = (src, dst)
        pol = self._policies.get(key)
        if pol is None:
            pol = LinkPolicy(self, src, dst, self._resolve_spec(src, dst))
            # replay schedule state that already fired
            for ps, pd in self._down_patterns:
                if ps in ("*", src) and pd in ("*", dst):
                    pol.down = True
            for ps, pd, spec in self._spec_patterns:
                if ps in ("*", src) and pd in ("*", dst):
                    pol.spec = spec if spec is not None else pol.base_spec
            self._policies[key] = pol
        return pol

    def link_pair(
        self, initiator: str, target: str
    ) -> Optional[Tuple[LinkPolicy, LinkPolicy]]:
        """(egress, ingress) policies for a connection ``initiator ->
        target`` — what the transport attaches at its frame seams.  Also
        arms the event schedule lazily: standalone postures (a
        ``MochiDBClient(netsim=...)`` against live servers, a bare
        ``MochiReplica``) reach here from loop context on first connect,
        so partition/heal schedules fire without a VirtualCluster ever
        calling :meth:`ensure_started`."""
        if not self.enabled:
            return None
        self.ensure_started()
        return self.policy(initiator, target), self.policy(target, initiator)

    # ------------------------------------------------------------- schedule

    def ensure_started(self) -> None:
        """Arm the event schedule on the running loop (idempotent).  Event
        times are relative to the FIRST arming — the cluster's t=0.  Off
        the loop (unit tests building topologies) this is a no-op and the
        schedule arms at the first on-loop :meth:`link_pair` instead."""
        if self._started or not self.schedule:
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return  # no loop yet; armed from loop context later
        self._started = True
        for event in self.schedule:
            self._timers.append(
                loop.call_later(event.at_s, self.apply_event, event)
            )

    def apply_event(self, event: LinkEvent) -> None:
        """Apply one link-state change now (schedule timers land here;
        tests and chaos harnesses may call it directly)."""
        self.metrics.mark("netsim.events")
        if event.kind == "down":
            self._down_patterns.append((event.src, event.dst))
        elif event.kind == "up":
            # An `up` clears every active down pattern it COVERS
            # (component-wise: its src/dst is "*" or equal), so a
            # heal-all ("*", "*") heals specific partitions and a node
            # heal clears that node's per-link downs.  The inverse — a
            # specific up against a broader down — is not expressible
            # (partially healing ("*", "*") would need per-link set
            # semantics); such downs stay until a covering up.
            self._down_patterns = [
                (ds, dd) for ds, dd in self._down_patterns
                if not (event.src in ("*", ds) and event.dst in ("*", dd))
            ]
        elif event.kind in ("set", "reset"):
            spec = event.spec if event.kind == "set" else None
            self._spec_patterns.append((event.src, event.dst, spec))
        else:
            raise ValueError(f"unknown link event kind: {event.kind!r}")
        for (src, dst), pol in self._policies.items():
            if not event.matches(src, dst):
                continue
            if event.kind == "down":
                pol.down = True
            elif event.kind == "up":
                pol.down = any(
                    ps in ("*", src) and pd in ("*", dst)
                    for ps, pd in self._down_patterns
                )
            elif event.kind == "set":
                pol.spec = event.spec if event.spec is not None else pol.base_spec
            else:  # reset
                pol.spec = pol.base_spec

    # convenience schedule builders -----------------------------------------

    @staticmethod
    def partition(node: str, at_s: float, heal_at_s: Optional[float] = None) -> List[LinkEvent]:
        """Isolate ``node`` (uplink + downlink) at ``at_s``; heal later."""
        events = [
            LinkEvent(at_s, "down", node, "*"),
            LinkEvent(at_s, "down", "*", node),
        ]
        if heal_at_s is not None:
            events.append(LinkEvent(heal_at_s, "up", node, "*"))
            events.append(LinkEvent(heal_at_s, "up", "*", node))
        return events

    @staticmethod
    def heal(node: str) -> List[LinkEvent]:
        """The ``up`` twin of :meth:`partition`: events clearing ``node``'s
        uplink+downlink downs, for harnesses applying events directly
        (``apply_event``) instead of scheduling heal_at_s up front."""
        return [
            LinkEvent(0.0, "up", node, "*"),
            LinkEvent(0.0, "up", "*", node),
        ]

    @staticmethod
    def degrade_uplink(
        node: str, at_s: float, spec: LinkSpec, until_s: Optional[float] = None
    ) -> List[LinkEvent]:
        """Replace ``node``'s egress spec (slow/lossy uplink) at ``at_s``;
        restore the base spec at ``until_s``."""
        events = [LinkEvent(at_s, "set", node, "*", spec)]
        if until_s is not None:
            events.append(LinkEvent(until_s, "reset", node, "*"))
        return events

    # ------------------------------------------------------------ lifecycle

    def close(self) -> None:
        """Cancel schedule timers + in-flight frames and reset the
        link-state machine (down patterns, spec overrides, ``_started``)
        so a sim reused for a second cluster re-arms its schedule from a
        fresh t=0 instead of silently running with a dead one.  Counters
        survive — evidence is often read after teardown — and stay
        cumulative across reuses."""
        for handle in self._timers:
            handle.cancel()
        self._timers.clear()
        self._down_patterns.clear()
        self._spec_patterns.clear()
        for pol in self._policies.values():
            pol.close()
            pol.down = False
            pol.spec = pol.base_spec
        self._started = False

    def stats(self, endpoint: Optional[str] = None) -> Dict[str, object]:
        """Per-link stats; ``endpoint`` restricts to links that node
        terminates (src or dst) — what one replica's admin surface should
        export when several replicas share a cluster-global sim, so a
        multi-replica scrape never double-counts a link."""
        return {
            "seed": self.seed,
            "enabled": self.enabled,
            "links": {
                pol.name: pol.stats()
                for _, pol in sorted(self._policies.items())
                if endpoint is None or endpoint in (pol.src, pol.dst)
            },
        }

    def totals(self) -> Dict[str, float]:
        """Cluster-wide counter totals (benchmark evidence records)."""
        out: Dict[str, float] = {
            "frames": 0, "delivered": 0, "dropped": 0,
            "delayed": 0, "reordered": 0, "lost": 0,
        }
        for pol in self._policies.values():
            s = pol.stats()
            for k in out:
                out[k] += s[k]
        return out
