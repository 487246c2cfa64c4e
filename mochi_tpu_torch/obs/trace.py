"""Per-transaction causal tracing: trace contexts, span rings, cost cards.

The repo's observability before this round was all AGGREGATE — stage
timers, occupancy histograms, per-peer counters.  Those answer "what does
the fleet look like" but not "where did THIS commit's 43 verifies, 2 RTTs
and 1 fsync actually go", and ROADMAP item 1 (amortize authentication)
needs that per-transaction attribution as its meter.  This module is the
causal record:

* :class:`TraceContext` — ``(trace_id, span_id, parent_id, sampled)``,
  minted once per client transaction (``client/txn.py``) and propagated
  through every envelope hop as a tolerated new wire field
  (``protocol/messages.py``).
* :class:`Tracer` — one per process role (client SDK, replica): spans land
  in a BOUNDED ring buffer (old evidence ages out; memory is O(ring), never
  O(traffic)), exported as Chrome trace-event JSON (``chrome://tracing`` /
  Perfetto load it directly) via the ``/trace`` admin endpoints and the
  ``python -m mochi_tpu_torch.tools.trace`` merge CLI.
* **Head-based seeded sampling** — the client decides at mint time with a
  seeded RNG (``MOCHI_TRACE_SAMPLE``; seed via ``MOCHI_TRACE_SEED`` for
  reproducible benchmark traces).  Only SAMPLED contexts ride the wire, so
  unsampled traffic keeps the exact untraced frame bytes and the native
  codec fast path — the tracing A/B's ≤3% overhead bound leans on this.
* **Always-sample upgrades** — errors, sheds, suspicion marks and
  invariant convictions force-record their spans even for head-unsampled
  traces (``force=True``): the trace that MATTERS is never the one that
  was sampled away.  A forced span for an unsampled trace yields a partial
  tree (the wire did not carry the context to other processes); the flight
  recorder below still captures the local evidence.
* **Flight recorder** — ``dump_flight`` drives the ring to disk with the
  conviction attached; replica conviction paths and the SIGTERM drain call
  it when ``MOCHI_TRACE_DIR`` is set, so a Byzantine verdict ships with
  the convicted message's causal path instead of just a counter.

Lazy-label discipline (enforced by the ``span-lazy-label`` analysis rule):
span names are CONSTANTS and args are built only behind a ``wants(ctx)``
gate — a span-record call on the drain hot loop must not pay string
formatting for the ~95% of traffic that head-based sampling skips.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
import weakref
from collections import deque
from contextvars import ContextVar
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# Default head-sampling rate when tracing is enabled without an explicit
# rate (MOCHI_TRACE=1): 1-in-20 transactions carry spans.  The committed
# config-7 A/B (benchmarks/results_r15.json) bounds the write-p50 cost of
# exactly this default at ≤3%.
DEFAULT_SAMPLE_RATE = 0.05

# Ring bound: spans kept per process.  At ~200 bytes/span this is ~1 MB —
# the config-9 open-loop shape (1,200 sessions, minutes of traffic) stays
# at this bound (pinned in tests/test_trace.py).
DEFAULT_RING = 4096

FLAG_SAMPLED = 1

# The per-task propagation slot: set by the client around each transaction
# (and by any caller that wants its spans parented), read by the envelope
# layer when attaching the wire field.
CURRENT: "ContextVar[Optional[TraceContext]]" = ContextVar(
    "mochi_trace_ctx", default=None
)


def current_ctx() -> "Optional[TraceContext]":
    return CURRENT.get()


def _env_rate() -> float:
    raw = os.environ.get("MOCHI_TRACE_SAMPLE")
    if raw:
        try:
            return max(0.0, min(1.0, float(raw)))
        except ValueError:
            return 0.0
    if os.environ.get("MOCHI_TRACE") == "1":
        return DEFAULT_SAMPLE_RATE
    return 0.0


def _env_seed() -> Optional[int]:
    raw = os.environ.get("MOCHI_TRACE_SEED")
    if raw:
        try:
            return int(raw)
        except ValueError:
            return None
    return None


def _env_ring() -> int:
    try:
        return max(64, int(os.environ.get("MOCHI_TRACE_RING", str(DEFAULT_RING))))
    except ValueError:
        return DEFAULT_RING


class TraceContext:
    """One hop's view of a transaction's causal identity.

    ``trace_id`` names the transaction end to end; ``span_id`` is the span
    the NEXT hop should parent under; ``parent_id`` is where this hop's own
    spans hang; ``sampled`` is the head-based verdict minted by the client.
    Ids are 16-hex strings (8 random bytes — collision-safe at ring scale,
    compact on the wire).
    """

    __slots__ = ("trace_id", "span_id", "parent_id", "sampled")

    def __init__(
        self,
        trace_id: str,
        span_id: str,
        parent_id: Optional[str] = None,
        sampled: bool = True,
    ):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.sampled = sampled

    def child(self, span_id: str) -> "TraceContext":
        """Context for work parented under ``span_id`` (same trace)."""
        return TraceContext(self.trace_id, span_id, self.span_id, self.sampled)

    # ------------------------------------------------------------- wire form

    def to_wire(self) -> Tuple[bytes, bytes, int]:
        """The tolerated envelope field: (trace_id, span_id, flags)."""
        return (
            bytes.fromhex(self.trace_id),
            bytes.fromhex(self.span_id),
            FLAG_SAMPLED if self.sampled else 0,
        )

    @classmethod
    def from_wire(cls, obj) -> "Optional[TraceContext]":
        """Decode the envelope field; None for anything malformed — the
        field is advisory observability, so a garbled one must never cost
        the (validly signed) envelope that carried it."""
        try:
            tid, sid, flags = obj
            if not (
                isinstance(tid, (bytes, bytearray))
                and isinstance(sid, (bytes, bytearray))
                and isinstance(flags, int)
                and 0 < len(tid) <= 16
                and 0 < len(sid) <= 16
            ):
                return None
            return cls(
                bytes(tid).hex(), bytes(sid).hex(), None, bool(flags & FLAG_SAMPLED)
            )
        except (TypeError, ValueError):
            return None


# Process-global tracer registry (weak — a closed cluster's tracers are
# collectable) behind run_all's ``trace_summary`` harness-rot probe.
# Counters ALSO aggregate into _GLOBAL as they happen: a benchmark
# summarizes after its cluster is closed, by which time the weak refs may
# already be collected — the evidence must outlive the tracers.
_TRACERS: "weakref.WeakSet" = weakref.WeakSet()
_REG_LOCK = threading.Lock()
_GLOBAL = {
    "traces_started": 0,
    "traces_sampled": 0,
    "spans_recorded": 0,
    "spans_forced": 0,
    "flight_dumps": 0,
}


# ------------------------------------------------------------- run stamp
#
# Round 16 (scenario engine): a violation artifact must be SELF-DESCRIBING
# — a flight dump or invariant report found on disk has to name the seed
# that regenerates the exact scenario that produced it.  The run stamp is
# a process-global dict the active harness sets (testing/scenario.py:
# scenario_seed, generator_version, spec_hash, injected flag); dump_flight
# merges it into every flight document and InvariantChecker.report()
# embeds it.  Child server processes inherit it via MOCHI_SCENARIO_SEED /
# MOCHI_SCENARIO_SPEC_HASH, so cross-process dumps carry the seed too.

_RUN_STAMP: Dict[str, object] = {}


def set_run_stamp(**fields) -> None:
    """Merge fields into the process-global run stamp (None deletes)."""
    for k, v in fields.items():
        if v is None:
            _RUN_STAMP.pop(k, None)
        else:
            _RUN_STAMP[k] = v


def clear_run_stamp() -> None:
    _RUN_STAMP.clear()


def run_stamp() -> Dict[str, object]:
    """The current stamp, merged over any env-inherited scenario identity
    (explicit set_run_stamp fields win).  Empty dict = no harness active."""
    out: Dict[str, object] = {}
    raw = os.environ.get("MOCHI_SCENARIO_SEED")
    if raw:
        try:
            out["scenario_seed"] = int(raw)
        except ValueError:
            pass
    h = os.environ.get("MOCHI_SCENARIO_SPEC_HASH")
    if h:
        out["spec_hash"] = h
    out.update(_RUN_STAMP)
    return out


class Tracer:
    """Bounded span recorder for one process role.

    ``process`` labels every span (Chrome trace ``pid``) so multi-process
    dumps merge unambiguously.  ``sample_rate`` / ``ring`` / ``seed`` /
    ``flight_dir`` default from the ``MOCHI_TRACE*`` env knobs
    (docs/OPERATIONS.md §4j), so real server processes inherit the
    harness's tracing posture with zero plumbing.
    """

    def __init__(
        self,
        process: str,
        sample_rate: Optional[float] = None,
        ring: Optional[int] = None,
        seed: Optional[int] = None,
        flight_dir: Optional[str] = None,
    ):
        self.process = process
        self.sample_rate = _env_rate() if sample_rate is None else sample_rate
        self.ring: deque = deque(maxlen=ring if ring is not None else _env_ring())
        # Seeded + derived from the process label: every process gets a
        # deterministic-but-distinct stream under one MOCHI_TRACE_SEED
        # (crc32, not hash() — PYTHONHASHSEED must not break run-over-run
        # reproducibility of benchmark traces).
        base_seed = seed if seed is not None else _env_seed()
        if base_seed is not None:
            import zlib

            self._rng = random.Random(
                (base_seed << 32) ^ zlib.crc32(process.encode())
            )
        else:
            self._rng = random.Random()
        self.flight_dir = (
            flight_dir if flight_dir is not None else os.environ.get("MOCHI_TRACE_DIR")
        )
        self.traces_started = 0
        self.traces_sampled = 0
        self.spans_recorded = 0
        self.spans_forced = 0
        self.flight_dumps = 0
        with _REG_LOCK:
            _TRACERS.add(self)

    # --------------------------------------------------------------- minting

    @property
    def enabled(self) -> bool:
        return self.sample_rate > 0.0

    def new_span_id(self) -> str:
        return "%016x" % self._rng.getrandbits(64)

    def mint(self) -> "Optional[TraceContext]":
        """Per-transaction context mint (the head-based sampling point).
        None when tracing is off — every downstream site then takes its
        zero-cost early exit."""
        if not self.enabled:
            return None
        self.traces_started += 1
        _GLOBAL["traces_started"] += 1
        sampled = self._rng.random() < self.sample_rate
        if sampled:
            self.traces_sampled += 1
            _GLOBAL["traces_sampled"] += 1
        return TraceContext(self.new_span_id(), self.new_span_id(), None, sampled)

    def wants(self, ctx: "Optional[TraceContext]") -> bool:
        """The lazy-label gate: build span args/labels only behind this."""
        return ctx is not None and ctx.sampled

    # ------------------------------------------------------------- recording

    def record(
        self,
        name: str,
        ctx: "Optional[TraceContext]",
        t0: float,
        dur_s: float,
        args: Optional[Dict] = None,
        span_id: Optional[str] = None,
        force: bool = False,
    ) -> Optional[str]:
        """Append one completed span; returns its span id (None = skipped).

        ``t0`` is ``time.time()`` epoch seconds (NOT perf_counter: spans
        from different processes must merge on one clock); ``dur_s`` should
        come from a perf_counter delta.  ``force=True`` records even for a
        head-unsampled (or absent) context — the error/shed/suspicion/
        conviction upgrade path.
        """
        if ctx is None:
            if not force:
                return None
            ctx = TraceContext(self.new_span_id(), self.new_span_id(), None, False)
        elif not ctx.sampled and not force:
            return None
        sid = span_id if span_id is not None else self.new_span_id()
        # Recording the context's OWN span (span_id == ctx.span_id) hangs it
        # under the context's parent; any other id is a child of the context.
        parent = ctx.parent_id if sid == ctx.span_id else ctx.span_id
        ev = {
            "name": name,
            "ph": "X",
            "ts": int(t0 * 1e6),
            "dur": max(0, int(dur_s * 1e6)),
            "pid": self.process,
            "tid": ctx.trace_id,
            "args": {
                "trace_id": ctx.trace_id,
                "span_id": sid,
                "parent_id": parent,
            },
        }
        if args:
            ev["args"].update(args)
        if force and not ctx.sampled:
            ev["args"]["forced"] = True
            self.spans_forced += 1
            _GLOBAL["spans_forced"] += 1
        self.ring.append(ev)
        self.spans_recorded += 1
        _GLOBAL["spans_recorded"] += 1
        return sid

    def force_mark(
        self, name: str, ctx: "Optional[TraceContext]", args: Optional[Dict] = None
    ) -> Optional[str]:
        """Zero-duration forced span at 'now' — the conviction/evidence
        marker (always recorded, whatever the sampling verdict was)."""
        return self.record(name, ctx, time.time(), 0.0, args=args, force=True)

    # --------------------------------------------------------------- exports

    def events(self) -> List[Dict]:
        return list(self.ring)

    def export_chrome(self, trace_id: Optional[str] = None) -> Dict:
        """Chrome trace-event JSON (the /trace endpoint body)."""
        evs = [
            ev
            for ev in list(self.ring)
            if trace_id is None or ev["args"].get("trace_id") == trace_id
        ]
        return {
            "traceEvents": evs,
            "displayTimeUnit": "ms",
            "otherData": {
                "process": self.process,
                "sample_rate": self.sample_rate,
                "ring": self.ring.maxlen,
                "spans_recorded": self.spans_recorded,
                "traces_started": self.traces_started,
                "traces_sampled": self.traces_sampled,
            },
        }

    def summary(self) -> Dict:
        return {
            "process": self.process,
            "enabled": self.enabled,
            "sample_rate": self.sample_rate,
            "ring": self.ring.maxlen,
            "ring_len": len(self.ring),
            "traces_started": self.traces_started,
            "traces_sampled": self.traces_sampled,
            "spans_recorded": self.spans_recorded,
            "spans_forced": self.spans_forced,
            "flight_dumps": self.flight_dumps,
        }

    # -------------------------------------------------------- flight recorder

    def dump_flight(
        self, reason: str, attach: Optional[Dict] = None, path: Optional[str] = None
    ) -> Optional[str]:
        """Drive the ring to disk with the conviction/reason attached.

        ``path=None`` writes ``flight-<process>-<pid>-<n>.json`` under
        ``flight_dir`` (no-op returning None when unset — tracing must
        never make a replica without a dump dir start touching disk).
        Synchronous file I/O by design: callers on an event loop hand it
        to an executor (``MochiReplica.drain``); conviction paths accept
        the one-off write — a Byzantine verdict is worth a millisecond.
        """
        if path is None:
            if not self.flight_dir:
                return None
            os.makedirs(self.flight_dir, exist_ok=True)
            path = os.path.join(
                self.flight_dir,
                f"flight-{self.process}-{os.getpid()}-{self.flight_dumps}.json",
            )
        doc = {
            "process": self.process,
            "reason": reason,
            "at_ms": int(time.time() * 1e3),
            "attach": attach or {},
            # scenario identity (round 16): the seed/spec-hash that
            # regenerates the run this evidence came from, when a
            # harness stamped one — a dump alone is then a reproducer
            "run": run_stamp(),
            **self.export_chrome(),
        }
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(doc, fh)
        os.replace(tmp, path)
        self.flight_dumps += 1
        _GLOBAL["flight_dumps"] += 1
        return path


# ---------------------------------------------------------------- aggregation


def merge_events(dumps: Iterable[Dict]) -> List[Dict]:
    """Flatten Chrome-trace/flight documents into one event list (the
    multi-process merge the tools CLI builds on)."""
    out: List[Dict] = []
    for doc in dumps:
        out.extend(doc.get("traceEvents", ()))
    out.sort(key=lambda ev: ev.get("ts", 0))
    return out


def span_tree_connected(events: Sequence[Dict], trace_id: str) -> bool:
    """True when every span of ``trace_id`` parents onto another span of
    the same trace (or is the root minted by the client) — the acceptance
    check for cross-process propagation: a broken hop shows up as an
    orphan parent_id no merged dump contains."""
    evs = [ev for ev in events if ev.get("args", {}).get("trace_id") == trace_id]
    if not evs:
        return False
    ids = {ev["args"].get("span_id") for ev in evs}
    roots = 0
    for ev in evs:
        parent = ev["args"].get("parent_id")
        if parent is None:
            roots += 1
        elif parent not in ids:
            return False
    return roots >= 1


# Span-args keys the cost card sums per trace.  ``verify_unique`` /
# ``verify_memoized`` slice the shared verify_batch round trip back to
# member transactions (the live verifies/txn meter); ``wire_bytes`` counts
# encoded frames sent on the transaction's behalf; ``fsyncs`` is the
# group-commit share; ``rtt`` counts fan-out round trips; ``queue_us`` is
# ingress-to-drain wait.
_CARD_SUMS = (
    "verify_items",
    "verify_unique",
    "verify_memoized",
    "verify_share_us",
    "wire_bytes",
    "fsyncs",
    "rtt",
    "queue_us",
)


def cost_cards(events: Iterable[Dict]) -> Dict[str, Dict]:
    """Per-transaction cost cards from an event stream (one process's ring
    or a multi-process merge): trace_id -> {verifies unique/memoized, wire
    bytes, fsyncs, RTTs, queue wait, per-stage durations}."""
    cards: Dict[str, Dict] = {}
    for ev in events:
        args = ev.get("args", {})
        tid = args.get("trace_id")
        if tid is None:
            continue
        card = cards.get(tid)
        if card is None:
            card = cards[tid] = {
                "spans": 0,
                "processes": set(),
                "stages_us": {},
                **{k: 0 for k in _CARD_SUMS},
            }
        card["spans"] += 1
        card["processes"].add(ev.get("pid"))
        name = ev.get("name", "?")
        card["stages_us"][name] = card["stages_us"].get(name, 0) + ev.get("dur", 0)
        for k in _CARD_SUMS:
            v = args.get(k)
            if isinstance(v, (int, float)):
                card[k] += v
    for card in cards.values():
        card["processes"] = sorted(p for p in card["processes"] if p is not None)
        for k in ("verify_unique", "verify_memoized", "verify_share_us",
                  "queue_us", "fsyncs"):
            card[k] = round(card[k], 3)
    return cards


def global_summary() -> Dict:
    """Process-wide tracing evidence — the benchmark harness's
    ``trace_summary`` stamp (non-empty even with tracing off, so the key's
    PRESENCE is what tier-1 smoke pins).  Counters come from the module
    aggregate, NOT the live tracer set: benchmarks summarize after their
    clusters close, when the weakly-registered tracers may already be
    collected; ``enabled``/``sample_rate`` reflect the env posture at call
    time."""
    with _REG_LOCK:
        tracers = list(_TRACERS)
    return {
        "enabled": _env_rate() > 0.0 or any(t.enabled for t in tracers),
        "sample_rate": max(
            (t.sample_rate for t in tracers), default=_env_rate()
        ),
        "tracers": len(tracers),
        **dict(_GLOBAL),
    }
