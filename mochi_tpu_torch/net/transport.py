"""Async TCP transport: length-prefixed frames, msg-id-correlated RPC.

Capability parity with the reference's messaging layer
(``server/messaging/``): connection pool per initiator
(``MochiMessaging.java:33-45``), lazy connect with retry
(``MochiClient.java:76-129``), request fan-out
(``Utils.sendMessageToServers``, ``Utils.java:113-123``), server listener with
restart-on-crash (``MochiServer.java:75-110``).  Two deliberate upgrades:

* responses are correlated by ``reply_to`` msg-id instead of the reference's
  FIFO promise queue ("TODO: that assumes that message order is correct",
  ``MochiClientHandler.java:67-75``) — out-of-order replies are fine;
* frames are 4-byte big-endian length + mcode envelope (the reference uses
  protobuf varint framing, ``MochiClientInitializer.java:14-26``).

Implementation: ``asyncio.Protocol`` on both sides (the reference's analog
is Netty's event-loop pipeline, ``MochiServer.java:83-96``) rather than the
stream API — framing is parsed synchronously out of ``data_received`` with
no per-read futures, and writes go straight to the transport buffer with
no per-response ``drain()``.  On this workload's single host core that is
worth ~15% cluster throughput over the stream-reader formulation.

Flow control: when a peer stops reading and the socket's write buffer
fills, ``pause_writing`` pauses the connection's *read* side too — a slow
consumer throttles its own request stream instead of growing our buffers
without bound.

The server runs MAC'd inline-type envelopes (reads, write1s — handlers
that never await external work, see ``INLINE_TYPES``) to completion
synchronously inside ``data_received``: no task, no scheduling, request
to response in one call frame.  ``_run_handler_sync`` enforces the
no-suspension contract loudly rather than silently degrading.
"""

from __future__ import annotations

import asyncio
import logging
import os
import random
import struct
import time

from typing import Awaitable, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from ..cluster.config import ServerInfo
from ..obs import trace as obs_trace
from ..utils.metrics import LATENCY_BOUNDS_S, STRAGGLER_BOUNDS_MS
from ..protocol import (
    Envelope,
    HelloToServer,
    ReadToServer,
    Write1ToServer,
    decode_envelope,
    encode_envelope,
)

LOG = logging.getLogger(__name__)

_LEN = struct.Struct(">I")
MAX_FRAME = 64 * 1024 * 1024

# Coalesced-write flush budget (server side).  A response frame first lands
# in its connection's output buffer; the buffer is flushed with ONE
# transport.write per drain unit.  With a non-zero delay budget and the
# server mid-burst (more work known in flight when a flush comes due), the
# flush may be deferred further — up to FLUSH_MAX_BYTES of buffered frames
# or FLUSH_MAX_DELAY_S of added latency, whichever lands first — so
# consecutive drain units merge their responses into one syscall.  The
# delay budget defaults to 0 (deferral OFF): cross-unit merging only pays
# when one CONNECTION carries several in-flight requests, and every
# measured workload here is strictly one-in-flight per connection (a
# histogram of 9320/9320 single-frame deliveries), where deferral is pure
# added latency.  Enable it for pipelined clients.  Both knobs env-tunable
# (docs/OPERATIONS.md "Batched hot path").
FLUSH_MAX_BYTES = int(os.environ.get("MOCHI_FLUSH_MAX_BYTES", str(64 * 1024)))
FLUSH_MAX_DELAY_S = float(os.environ.get("MOCHI_FLUSH_MAX_DELAY_MS", "0")) / 1e3

# Histogram bounds for flushed-bytes-per-write (powers of ~4 up to 1 MiB).
_BYTES_BOUNDS = (64, 256, 1024, 4096, 16384, 65536, 262144, 1048576)

# Reconnect policy (ref: MochiClient.checkChannelIsOpened retries 3×100ms,
# MochiClient.java:110-129), env-tunable so WAN-shaped deployments can
# widen the budget, with jittered exponential backoff so a cluster-wide
# blip doesn't thundering-herd every client's reconnect onto one instant.
# MOCHI_CONN_JITTER_SEED pins the jitter stream for reproducible runs
# (netsim/config-7); unset, each process draws its own stream — identical
# backoff schedules across processes would BE the herd.
CONN_RETRIES = int(os.environ.get("MOCHI_CONN_RETRIES", "3"))
CONN_BACKOFF_S = float(os.environ.get("MOCHI_CONN_BACKOFF_MS", "100")) / 1e3
_jitter_seed = os.environ.get("MOCHI_CONN_JITTER_SEED")
_CONN_RNG = random.Random(int(_jitter_seed)) if _jitter_seed else random.Random()


def _backoff_delay_s(attempt: int, base_s: float, rng: Optional[random.Random] = None) -> float:
    """attempt-th reconnect wait: ``base * 2^attempt * uniform(0.5, 1.5)``
    (exponent capped so a long outage never waits unboundedly)."""
    r = _CONN_RNG if rng is None else rng
    return base_s * (1 << min(attempt, 6)) * (0.5 + r.random())


# Request-timeout RTT floor: callers size timeouts for loopback (where a
# round trip is microseconds); under a 13 ms WAN link a tight budget times
# out a perfectly healthy request and the retry doubles the load.  With
# MOCHI_RTT_FLOOR_MS set, every send_and_receive/fan_out budget is raised
# to at least RTT_TIMEOUT_MULT round trips (connect + request + verify
# queueing all ride the same links).  Default 0: behavior unchanged.
RTT_FLOOR_S = float(os.environ.get("MOCHI_RTT_FLOOR_MS", "0")) / 1e3
RTT_TIMEOUT_MULT = float(os.environ.get("MOCHI_RTT_TIMEOUT_MULT", "8"))

# Per-connection send-queue watermarks (server side).  The transport's
# write buffer is the ONLY place response bytes for a slow reader can
# accumulate (the app-level ``_out`` buffer self-flushes at
# flush_max_bytes): past the high watermark asyncio calls pause_writing,
# which our protocol turns into pause_reading — a peer that won't drain
# responses stops being allowed to feed requests, so per-connection memory
# is bounded at ~high + flush_max_bytes regardless of peer behavior.
# Resume fires at the low mark (hysteresis: no pause/resume flapping at
# the boundary).
SENDQ_HIGH = int(os.environ.get("MOCHI_SENDQ_HIGH", str(256 * 1024)))
SENDQ_LOW = int(os.environ.get("MOCHI_SENDQ_LOW", str(64 * 1024)))

# Client-side pending-map bound: correlation futures per connection.  Every
# entry IS an in-flight request (resolved entries are popped), so the bound
# is a back-pressure valve, not an eviction policy — a send past the cap
# fails typed (the caller's retry/backoff path absorbs it) and NOTHING
# in-flight is ever evicted: evicting a live future would orphan its
# response and surface as a spurious timeout (pinned in
# tests/test_overload.py).
PENDING_MAX = int(os.environ.get("MOCHI_PENDING_MAX", "4096"))

# Request-timeout wakeup coalescing (utils/wakeup.TimerWheel): thousands of
# concurrent request timeouts share one coarse loop timer instead of one
# TimerHandle each.  Quantum = max added latency on a TIMEOUT (never on a
# response); 0 disables (per-request asyncio.wait_for, the old path).
TIMEOUT_WHEEL_QUANTUM_S = float(
    os.environ.get("MOCHI_TIMEOUT_WHEEL_MS", "20")
) / 1e3


class PendingLimitExceeded(ConnectionError):
    """Connection's in-flight correlation map is full (MOCHI_PENDING_MAX):
    the caller is outrunning the peer — back off, don't buffer more."""


def apply_rtt_floor(timeout_s: float) -> float:
    """Raise a caller's timeout to the configured multiple of the RTT
    floor (no-op at the default floor of 0).  A non-positive timeout means
    "no waiting" and is never raised."""
    if timeout_s <= 0:
        return timeout_s
    floor = RTT_FLOOR_S * RTT_TIMEOUT_MULT
    return timeout_s if timeout_s >= floor else floor


class ConnectionNotReady(Exception):
    """Peer unreachable (ref: ``ConnectionNotReadyException.java``)."""


Handler = Callable[[Envelope], Awaitable[Optional[Envelope]]]


def _run_handler_sync(coro) -> Optional[Envelope]:
    """Run a handler coroutine that is contractually await-free.

    The MAC'd inline fast path (session auth + in-memory store op) never
    suspends, so one ``send(None)`` reaches ``StopIteration`` and yields the
    return value with zero event-loop involvement.  If a future edit makes
    the path suspend, this raises immediately (and the partially-run
    coroutine is closed) — a loud regression beats a silent hang.
    """
    try:
        coro.send(None)
    except StopIteration as stop:
        return stop.value
    coro.close()
    raise RuntimeError(
        "inline handler suspended; its payload type must not be in INLINE_TYPES"
    )


class _FramedProtocol(asyncio.Protocol):
    """Length-prefixed framing shared by both transport roles.

    History: per-SOCKET response coalescing was measured and rejected in
    round 5 — a frames-per-delivery histogram showed **9320 of 9320**
    deliveries carry exactly ONE complete frame, because every hot edge is
    strictly one-in-flight request-response (a client blocks on each txn
    phase; fan-out targets are distinct sockets), so a per-socket parse
    batch never has a second frame to merge.  The batched hot path
    therefore aggregates ACROSS connections instead: the server enqueues
    every decoded frame of one event-loop scheduling tick — 5 concurrent
    clients' Write2s land in one selector poll — into a per-tick drain
    (``RpcServer._drain``), and responses coalesce per connection in
    ``_RpcServerProtocol`` output buffers with one ``transport.write``
    per drain unit.  That cross-connection axis is what a
    single-socket A/B cannot see.
    """

    def __init__(self) -> None:
        self._buf = bytearray()
        self.transport: Optional[asyncio.Transport] = None
        # netsim seams (mochi_tpu_torch.netsim.LinkPolicy or None).  The
        # INITIATOR of a connection owns both directions of its logical
        # link: egress conditions the frames we send (A->B), ingress
        # conditions the frames we receive (B->A) — so server responses
        # are WAN-shaped too, with zero server-side peer labeling.  None
        # (the default everywhere outside a conditioned cluster) keeps the
        # hot path a single attribute test.
        self.egress_link = None
        self.ingress_link = None

    # -- subclass surface
    def frame_received(self, frame: bytes) -> None:  # pragma: no cover
        raise NotImplementedError

    def connection_made(self, transport) -> None:
        self.transport = transport

    def send_frame(self, payload: bytes) -> None:
        assert self.transport is not None
        data = _LEN.pack(len(payload)) + payload
        link = self.egress_link
        if link is None:
            self.transport.write(data)
        else:
            link.send(self._conditioned_write, data)

    def _conditioned_write(self, data: bytes) -> bool:
        """Delayed-egress delivery: the link may fire after this
        connection died — a frame for a closed transport is simply lost
        (exactly what the modeled network would have done with it).
        Returns False for that case so the link counts it ``lost``, not
        ``delivered`` (the evidence records lean on delivered==frames)."""
        t = self.transport
        if t is None or t.is_closing():
            return False
        t.write(data)
        return True

    # -- flow control: a peer that won't read our responses stops being
    # allowed to feed us requests (bounded memory per connection).
    def pause_writing(self) -> None:
        if self.transport is not None:
            try:
                self.transport.pause_reading()
            except RuntimeError:  # already closing
                pass

    def resume_writing(self) -> None:
        if self.transport is not None:
            try:
                self.transport.resume_reading()
            except RuntimeError:
                pass

    def data_received(self, data: bytes) -> None:
        buf = self._buf
        buf += data
        pos = 0
        n = len(buf)
        ingress = self.ingress_link
        while n - pos >= 4:
            (length,) = _LEN.unpack_from(buf, pos)
            if length > MAX_FRAME:
                LOG.warning("oversized frame (%d bytes); closing connection", length)
                if self.transport is not None:
                    self.transport.close()
                return
            end = pos + 4 + length
            if end > n:
                break
            frame = bytes(buf[pos + 4 : end])
            pos = end
            # Ingress conditioning happens at FRAME granularity (parse
            # first, then delay/drop/reorder delivery): the sim sits above
            # a real ordered socket, so dropping raw bytes would corrupt
            # framing rather than model message loss.
            if ingress is None:
                self.frame_received(frame)
            else:
                ingress.send(self.frame_received, frame)
            if self.transport is None or self.transport.is_closing():
                break
        if pos:
            del buf[:pos]


class _RpcServerProtocol(_FramedProtocol):
    """Server-side connection: decoded frames enqueue into the server's
    per-tick drain; responses coalesce in ``_out`` and leave with one
    ``transport.write`` per drain unit (``queue_frame``/``flush_now``)."""

    def __init__(self, server: "RpcServer") -> None:
        super().__init__()
        self.server = server
        self._out = bytearray()
        self._flush_timer: Optional[asyncio.TimerHandle] = None
        # Per-envelope handler tasks owned by THIS connection (legacy
        # posture only): cancelled on connection_lost so a disconnected
        # client's expensive request stops computing for a dead socket.
        # Batch tasks span connections and outlive any one of them — they
        # are server-owned (RpcServer._tasks) by design.
        self._conn_tasks: set = set()
        self._flow_paused = False  # write-buffer high-water reached

    def connection_made(self, transport) -> None:
        super().connection_made(transport)
        # Backpressure watermarks: past `high` buffered response bytes the
        # loop calls pause_writing -> we pause_reading (base class), so a
        # slow reader self-throttles; resume at `low`.
        try:
            transport.set_write_buffer_limits(
                high=self.server.sendq_high, low=self.server.sendq_low
            )
        except (AttributeError, NotImplementedError):
            pass  # exotic transports keep their defaults
        self.server._protocols.add(self)

    # flow-control accounting rides the base class's pause/resume-reading
    # behavior: the server-wide paused count is the admission controller's
    # "peers not draining" load component.
    def pause_writing(self) -> None:
        if not self._flow_paused:
            self._flow_paused = True
            self.server._paused_conns += 1
            metrics = self.server.metrics
            if metrics is not None:
                metrics.mark("transport.sendq-paused")
        super().pause_writing()

    def resume_writing(self) -> None:
        if self._flow_paused:
            self._flow_paused = False
            self.server._paused_conns -= 1
        super().resume_writing()

    def frame_received(self, frame: bytes) -> None:
        try:
            env = decode_envelope(frame)
        except Exception:
            peer = self.transport.get_extra_info("peername") if self.transport else None
            LOG.exception("undecodable frame from %s; closing", peer)
            if self.transport is not None:
                self.transport.close()
            return
        self.server._enqueue(self, env)

    # -- coalesced response writes

    def queue_frame(self, payload: bytes, touched: List["_RpcServerProtocol"]) -> None:
        """Buffer one response frame; the caller flushes every touched
        protocol once at the end of its drain unit."""
        if self.transport is None or self.transport.is_closing():
            return
        if not self._out:
            touched.append(self)
        self._out += _LEN.pack(len(payload))
        self._out += payload
        self.server._sendq_out_bytes += len(payload) + 4
        if len(self._out) >= self.server.flush_max_bytes:
            self.flush_now()  # byte budget exceeded mid-unit: bound memory

    def flush_now(self) -> None:
        if self._flush_timer is not None:
            self._flush_timer.cancel()
            self._flush_timer = None
        if not self._out:
            return
        buf, self._out = self._out, bytearray()
        self.server._sendq_out_bytes -= len(buf)
        if self.transport is None or self.transport.is_closing():
            return
        metrics = self.server.metrics
        if metrics is not None:
            metrics.histogram("transport.flush-bytes", _BYTES_BOUNDS).observe(len(buf))
        self.transport.write(bytes(buf))

    def _arm_flush(self, delay_s: float) -> None:
        if self._flush_timer is None and self._out:
            self._flush_timer = asyncio.get_running_loop().call_later(
                delay_s, self.flush_now
            )

    def connection_lost(self, exc: Optional[Exception]) -> None:
        self.server._protocols.discard(self)
        if self._flow_paused:  # paused count must not leak a dead conn
            self._flow_paused = False
            self.server._paused_conns -= 1
        self.server._sendq_out_bytes -= len(self._out)
        for task in self._conn_tasks:
            task.cancel()
        if self._flush_timer is not None:
            self._flush_timer.cancel()
            self._flush_timer = None
        self._out.clear()
        self.transport = None


InlineBatchHandler = Callable[[Sequence[Envelope]], List[Optional[Envelope]]]
BatchHandler = Callable[[Sequence[Envelope]], Awaitable[List[Optional[Envelope]]]]


class RpcServer:
    """Accepts connections and feeds decoded envelopes to an async handler;
    the handler's response (if any) is written back on the same connection
    (ref: ``MochiServer`` + ``RequestHandlerDispatcher``).

    Batched hot path: every frame decoded during one event-loop scheduling
    tick — across ALL connections — lands in ``_ingress``, and a single
    ``call_soon`` drain processes the whole tick's worth together.  With
    batch handlers installed (the replica), the drain splits the batch into

    * an INLINE subset (MAC'd ``INLINE_TYPES``) handed synchronously to
      ``inline_batch_handler`` — zero tasks, request to response in the
      drain's call frame, store entry points invoked once per batch; and
    * the rest, shipped as ONE task to the async ``batch_handler`` —
      signature checks for the whole batch share one verifier round trip.

    Responses coalesce per connection and leave with one ``transport.write``
    per drain unit (adaptive: immediate when the server is idle, deferred up
    to a byte/deadline budget while more ingress is already queued).
    Without batch handlers (verifier service, bare tests) the drain
    degrades to the per-envelope semantics this class always had, keeping
    the write coalescing.
    """

    # Payload types whose handlers never block on external work (no device
    # batches, no peer RPC): handled synchronously inside the drain tick,
    # saving a Task allocation + schedule per message.  Only taken for
    # MAC'd envelopes — session-MAC auth is synchronous, while signed
    # envelopes may await the batch verifier (suspending there would raise
    # in _run_handler_sync).
    INLINE_TYPES = (ReadToServer, Write1ToServer, HelloToServer)

    def __init__(
        self,
        host: str,
        port: int,
        handler: Handler,
        inline_batch_handler: Optional[InlineBatchHandler] = None,
        batch_handler: Optional[BatchHandler] = None,
        metrics=None,
        flush_max_bytes: int = FLUSH_MAX_BYTES,
        flush_max_delay_s: float = FLUSH_MAX_DELAY_S,
        sendq_high: int = SENDQ_HIGH,
        sendq_low: int = SENDQ_LOW,
    ):
        self.host = host
        self.port = port
        self.handler = handler
        self.inline_batch_handler = inline_batch_handler
        self.batch_handler = batch_handler
        self.metrics = metrics
        self.flush_max_bytes = flush_max_bytes
        self.flush_max_delay_s = flush_max_delay_s
        self.sendq_high = sendq_high
        self.sendq_low = sendq_low
        # single source of the "unix:" scheme logic
        self._unix_path: Optional[str] = (
            host[len("unix:"):] if host.startswith("unix:") else None
        )
        self._bound_ino: Optional[tuple] = None
        self._server: Optional[asyncio.base_events.Server] = None
        self._protocols: set = set()
        self._ingress: List[Tuple[_RpcServerProtocol, Envelope]] = []
        self._drain_scheduled = False
        self._tasks: set = set()
        # -- deterministic load signal (the admission controller's inputs;
        # all event-counted, none wall-clock: a loop stall can only inflate
        # these by the requests actually queued behind it, never by the
        # stall duration itself — the flake mode that kept the old
        # loop-lag shed OFF in every in-process harness).
        self._paused_conns = 0        # connections past the send-queue high-water
        self._sendq_out_bytes = 0     # response bytes buffered pre-flush
        self._inflight_envs = 0       # envelopes inside async batch tasks
        self._batch_ewma = 0.0        # EWMA of frames per drain tick
        self._last_drain_t = 0.0      # idle-gap detector for the EWMA reset

    # ------------------------------------------------------- per-tick drain

    def load_stats(self) -> Dict[str, float]:
        """O(1) snapshot of the transport-side load signal (the inputs to
        ``server.admission.AdmissionController``; also the /status
        "overload" surface)."""
        return {
            "ingress_depth": len(self._ingress),
            "inflight_envs": self._inflight_envs,
            "batch_ewma": round(self._batch_ewma, 2),
            "sendq_out_bytes": self._sendq_out_bytes,
            "paused_conns": self._paused_conns,
            "connections": len(self._protocols),
        }

    def send_queue_bytes(self) -> int:
        """Total buffered response bytes: pre-flush ``_out`` buffers plus
        the transports' own write buffers.  O(connections) — admin-surface
        freshness, not hot-path accounting (load_stats is the O(1) view)."""
        total = self._sendq_out_bytes
        for proto in self._protocols:
            t = proto.transport
            if t is not None:
                try:
                    total += t.get_write_buffer_size()
                except (AttributeError, NotImplementedError):
                    pass
        return total

    def _enqueue(self, proto: _RpcServerProtocol, env: Envelope) -> None:
        if env.trace is not None:
            # Traced (head-sampled) envelope: stamp ingress so the handler
            # can attribute queue/drain wait to the transaction.  Stashed in
            # __dict__ exactly like the payload's _mcode cache; untraced
            # traffic pays one attribute test.
            env.__dict__["_rx_perf"] = time.perf_counter()
        self._ingress.append((proto, env))
        if not self._drain_scheduled:
            self._drain_scheduled = True
            # call_soon lands AFTER every data_received callback of the
            # current selector poll (asyncio runs a len-snapshot of the
            # ready queue), so the drain sees the whole tick's frames.
            asyncio.get_running_loop().call_soon(self._drain)

    def _drain(self) -> None:
        self._drain_scheduled = False
        batch = self._ingress
        if not batch:
            return
        self._ingress = []
        t0 = time.perf_counter()
        # Congestion EWMA: frames-per-tick grows with backlog (arrivals
        # outpacing service stack up in kernel buffers and land together on
        # the next poll), and is bounded by what peers actually sent — the
        # deterministic load signal the shed controller reads.  The EWMA is
        # only folded when frames arrive, so it would otherwise FREEZE at
        # its last value across an idle gap and shed the first writes of
        # the next burst; an idle gap resets it.  Using wall time here is
        # safe in a way the retired lag signal was not: absence of traffic
        # can only decay the signal — a stall still cannot inflate it.
        if t0 - self._last_drain_t > 1.0:
            self._batch_ewma = 0.0
        self._last_drain_t = t0
        self._batch_ewma += 0.2 * (len(batch) - self._batch_ewma)
        metrics = self.metrics
        if metrics is not None:
            metrics.histogram("transport.drain-frames").observe(len(batch))
        touched: List[_RpcServerProtocol] = []
        try:
            if self.inline_batch_handler is not None or self.batch_handler is not None:
                inline: List[Tuple[_RpcServerProtocol, Envelope]] = []
                rest: List[Tuple[_RpcServerProtocol, Envelope]] = []
                take_inline = self.inline_batch_handler is not None
                for pe in batch:
                    env = pe[1]
                    if (
                        take_inline
                        and env.mac is not None
                        and isinstance(env.payload, self.INLINE_TYPES)
                    ):
                        inline.append(pe)
                    else:
                        rest.append(pe)
                if inline:
                    try:
                        responses = self.inline_batch_handler(
                            [env for _, env in inline]
                        )
                    except Exception:
                        LOG.exception(
                            "inline batch handler failed for %d envelopes",
                            len(inline),
                        )
                        responses = []
                    self._queue_responses(inline, responses, touched)
                if rest:
                    if self.batch_handler is not None:
                        task = asyncio.ensure_future(self._run_batch(rest))
                        self._tasks.add(task)
                        task.add_done_callback(self._tasks.discard)
                    else:
                        for proto, env in rest:
                            task = asyncio.ensure_future(
                                self._handle_async(proto, env)
                            )
                            self._track(proto, task)
            else:
                # Legacy posture (no batch handlers): per-envelope dispatch
                # with the original inline fast path, plus coalesced writes.
                for proto, env in batch:
                    if env.mac is not None and isinstance(
                        env.payload, self.INLINE_TYPES
                    ):
                        try:
                            response = _run_handler_sync(self.handler(env))
                        except Exception:
                            LOG.exception(
                                "handler failed for %s", type(env.payload).__name__
                            )
                            continue
                        if response is not None:
                            self._queue_responses(
                                [(proto, env)], [response], touched
                            )
                    else:
                        task = asyncio.ensure_future(self._handle_async(proto, env))
                        self._track(proto, task)
        finally:
            # always flush what was queued — see the invariant note in
            # _run_batch (a unit that dies pre-flush would strand frames)
            self._finish_unit(touched)
        if metrics is not None:
            metrics.histogram(
                "transport.drain-latency", LATENCY_BOUNDS_S
            ).observe(time.perf_counter() - t0)

    def _finish_unit(self, touched: List[_RpcServerProtocol]) -> None:
        """End of one drain unit: flush every touched connection — now when
        idle; deferred (up to the byte/deadline budget) while more work is
        known to be in flight, so back-to-back units share writes.

        "In flight" = undrained ingress exists (``_ingress`` non-empty: an
        async unit completed while new frames piled up) or a drain is
        already scheduled.  The SYNC drain itself always sees an empty
        ingress (its frames were snapshotted at entry and this poll's
        ``data_received`` callbacks ran before it), so MAC'd inline
        responses flush at unit end — the deadline budget engages on
        async-completion units under load, never on idle traffic.
        """
        if not touched:
            return
        defer = self.flush_max_delay_s > 0 and (
            bool(self._ingress) or self._drain_scheduled
        )
        for proto in touched:
            if defer and len(proto._out) < self.flush_max_bytes:
                proto._arm_flush(self.flush_max_delay_s)
            else:
                proto.flush_now()

    def _track(self, proto: _RpcServerProtocol, task) -> None:
        """Register a per-envelope handler task with BOTH owners: the
        server (close() sweep) and its connection (cancelled on
        connection_lost, so work for a dead socket stops)."""
        self._tasks.add(task)
        proto._conn_tasks.add(task)

        def _done(t, proto=proto):
            self._tasks.discard(t)
            proto._conn_tasks.discard(t)

        task.add_done_callback(_done)

    async def _run_batch(self, batch: List[Tuple[_RpcServerProtocol, Envelope]]) -> None:
        # counted from the coroutine's FIRST step, not the spawn site: a
        # task cancelled before it ever runs (connection churn, shutdown)
        # never enters this frame — increment-at-spawn would leak the
        # counter permanently and drift the admission load signal upward
        self._inflight_envs += len(batch)
        try:
            responses = await self.batch_handler([env for _, env in batch])
        except asyncio.CancelledError:
            raise  # server close() cancels us; don't treat it as a handler bug
        except Exception:
            # Per-envelope failures are the batch handler's business (one
            # bad envelope must not poison its batchmates); reaching here is
            # a handler BUG — log and drop, client timeouts recover.
            LOG.exception("batch handler failed for %d envelopes", len(batch))
            return
        finally:
            self._inflight_envs -= len(batch)
        touched: List[_RpcServerProtocol] = []
        try:
            self._queue_responses(batch, responses, touched)
        finally:
            # _finish_unit MUST run for every unit that queued anything:
            # queue_frame only registers a protocol in `touched` while its
            # buffer is empty, so a unit that dies between queueing and
            # flushing would strand those frames forever (no later unit
            # would re-register the connection).
            self._finish_unit(touched)

    @staticmethod
    def _queue_responses(batch, responses, touched) -> None:
        """Encode + buffer each response; one unencodable response (a
        handler bug) is dropped alone rather than aborting the unit."""
        for (proto, _), response in zip(batch, responses):
            if response is None:
                continue
            try:
                frame = encode_envelope(response)
            except Exception:
                LOG.exception(
                    "unencodable response %s", type(response.payload).__name__
                )
                continue
            proto.queue_frame(frame, touched)

    async def _handle_async(self, proto: _RpcServerProtocol, env: Envelope) -> None:
        self._inflight_envs += 1  # first-step counting; see _run_batch
        try:
            response = await self.handler(env)
        except asyncio.CancelledError:
            raise  # close() cancels us; don't treat it as a handler bug
        except Exception:
            # The reference swallows handler exceptions and sends nothing,
            # hanging the client future (RequestHandlerDispatcher.java:63-83).
            # We log and drop too — client timeouts are the recovery path —
            # but the failure taxonomy (RequestFailedFromServer) is preferred.
            LOG.exception("handler failed for %s", type(env.payload).__name__)
            return
        finally:
            self._inflight_envs -= 1
        if response is not None:
            touched: List[_RpcServerProtocol] = []
            try:
                self._queue_responses([(proto, env)], [response], touched)
            finally:
                self._finish_unit(touched)

    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        if self._unix_path is not None:
            # Unix-domain socket: same framed protocol, no TCP/IP stack —
            # the kernel loopback send path is the measured cost floor for
            # single-host clusters.  Only a DEAD
            # leftover socket is unlinked: stealing a live server's path
            # would strand it running-but-unreachable, where TCP fails
            # loudly with EADDRINUSE.
            import socket as _socket

            path = self._unix_path
            if os.path.exists(path):
                # Only a refused connect (or a path that vanished under us)
                # proves the previous owner is dead.  A timeout or EAGAIN can
                # mean a LIVE server with a momentarily full accept backlog —
                # unlinking then would steal its path and strand it
                # running-but-unreachable.
                probe = _socket.socket(_socket.AF_UNIX)
                probe.settimeout(0.2)
                stale = False
                try:
                    probe.connect(path)
                except (ConnectionRefusedError, FileNotFoundError):
                    stale = True
                except OSError:
                    pass  # timeout / EAGAIN / anything else: assume live
                finally:
                    probe.close()
                if not stale:
                    raise OSError(f"unix socket {path} is in use by a live server")
                try:
                    os.unlink(path)  # stale socket from a dead process
                except FileNotFoundError:
                    pass
            self._server = await loop.create_unix_server(
                lambda: _RpcServerProtocol(self), path
            )
            try:
                st = os.stat(path)
                self._bound_ino = (st.st_dev, st.st_ino)
            except OSError:
                self._bound_ino = None
        else:
            self._server = await loop.create_server(
                lambda: _RpcServerProtocol(self), self.host, self.port
            )

    @property
    def bound_port(self) -> int:
        assert self._server is not None
        if self._unix_path is not None:
            return self.port  # UDS has no port; identity stays the path
        return self._server.sockets[0].getsockname()[1]

    async def quiesce(self, timeout_s: float = 5.0) -> None:
        """Graceful drain before ``close()``: stop accepting new
        connections, let in-flight handler/batch work finish (bounded by
        ``timeout_s``), then flush every connection's coalesced output
        buffer so responses already computed actually reach their clients.

        This is the SIGTERM path's half of deterministic teardown
        (``server/__main__.py``): ``close()`` alone cancels in-flight
        batches and aborts connections, which is right for a crash-style
        stop but loses the tail of admitted work on a supervisor's TERM.
        Past the deadline, whatever is still running is handed to
        ``close()``'s cancel sweep — drain bounds shutdown time, it does
        not wait forever on a wedged handler.
        """
        if self._server is not None:
            # Stop accepting; existing connections stay up for the drain.
            # asyncio's Server.close() is idempotent, so the later close()
            # call repeating it is harmless.
            self._server.close()
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout_s
        # _tasks empties as batches finish; undrained ingress respawns
        # tasks via call_soon, so poll both until quiet or deadline.
        while self._tasks or self._ingress or self._drain_scheduled:
            remaining = deadline - loop.time()
            if remaining <= 0:
                break
            tasks = list(self._tasks)
            if tasks:
                await asyncio.wait(tasks, timeout=remaining)
            else:
                await asyncio.sleep(0.005)  # let a scheduled drain run
        for proto in list(self._protocols):
            if proto.transport is not None:
                proto.flush_now()

    async def close(self) -> None:
        # In-flight drain batches die with the server (their connections are
        # about to be aborted anyway); ingress enqueued but never drained is
        # dropped the same way a killed per-connection task used to be.
        for task in list(self._tasks):
            task.cancel()
        self._ingress.clear()
        if self._server is not None:
            self._server.close()
            # Drop live connections first: Server.wait_closed() waits for
            # every connection to finish, and peers hold theirs open.
            # abort(), not close(): a graceful close waits to flush, and a
            # connection whose peer has stopped reading (e.g. another
            # replica's cancelled resync worker mid-state-transfer after a
            # reconfiguration) can keep the flush — and therefore
            # wait_closed() and the whole replica shutdown — pending
            # forever.  Shutdown wants connections DROPPED.
            for proto in list(self._protocols):
                if proto.transport is not None:
                    proto.transport.abort()
            # Belt-and-braces: a connection accepted between the snapshot
            # above and wait_closed() would hang us the same way, so sweep
            # until the server reports fully closed.
            while True:
                try:
                    await asyncio.wait_for(self._server.wait_closed(), timeout=1.0)
                    break
                except asyncio.TimeoutError:
                    for proto in list(self._protocols):
                        if proto.transport is not None:
                            proto.transport.abort()
            self._server = None
            if self._unix_path is not None:
                # a stale socket file accepts nothing but still looks alive
                # to path-probing consumers — ENOENT beats ECONNREFUSED.
                # Unlink ONLY our own inode: a newer server may have
                # (legitimately, after our socket died) bound a fresh
                # socket at this path.
                try:
                    st = os.stat(self._unix_path)
                    if (st.st_dev, st.st_ino) == self._bound_ino:
                        os.unlink(self._unix_path)
                except OSError:
                    pass


class _RpcClientProtocol(_FramedProtocol):
    def __init__(self, conn: "_Connection") -> None:
        super().__init__()
        self.conn = conn

    def frame_received(self, frame: bytes) -> None:
        try:
            env = decode_envelope(frame)
        except Exception:
            LOG.exception("undecodable response from %s; closing", self.conn.info.url)
            if self.transport is not None:
                self.transport.close()
            return
        fut = self.conn.pending.pop(env.reply_to or "", None)
        if fut is not None and not fut.done():
            fut.set_result(env)
        else:
            LOG.warning(
                "uncorrelated response reply_to=%s from %s", env.reply_to, self.conn.info.url
            )

    def connection_lost(self, exc: Optional[Exception]) -> None:
        self.transport = None
        self.conn._on_connection_lost()


class _Connection:
    def __init__(self, info: ServerInfo, links=None, pending_max: int = 0):
        self.info = info
        # (egress, ingress) LinkPolicy pair from NetSim.link_pair, or None:
        # attached to every protocol this connection (re)creates.
        self.links = links
        self.pending: Dict[str, asyncio.Future] = {}
        self.pending_max = pending_max if pending_max > 0 else PENDING_MAX
        self._proto: Optional[_RpcClientProtocol] = None
        self._connect_lock = asyncio.Lock()

    def register_pending(self, msg_id: str, fut: asyncio.Future) -> None:
        """Correlation-map insert behind the in-flight bound.  At the cap,
        already-resolved leftovers are swept (futures a raced caller never
        popped); live in-flight entries are NEVER evicted — past the cap
        the NEW request fails typed instead (the map's entries each back an
        awaiting caller; evicting one manufactures a spurious timeout)."""
        pending = self.pending
        if len(pending) >= self.pending_max:
            done = [mid for mid, f in pending.items() if f.done()]
            for mid in done:
                del pending[mid]
            if len(pending) >= self.pending_max:
                raise PendingLimitExceeded(
                    f"{self.info.url}: {len(pending)} requests in flight "
                    f"(MOCHI_PENDING_MAX={self.pending_max})"
                )
        pending[msg_id] = fut

    @property
    def connected(self) -> bool:
        return (
            self._proto is not None
            and self._proto.transport is not None
            and not self._proto.transport.is_closing()
        )

    async def ensure_connected(
        self, retries: Optional[int] = None, delay_s: Optional[float] = None
    ) -> None:
        # ref: MochiClient.checkChannelIsOpened retries 3×100ms then throws
        # (MochiClient.java:110-129); count/backoff env-tunable
        # (MOCHI_CONN_RETRIES / MOCHI_CONN_BACKOFF_MS) with jittered
        # exponential backoff — see _backoff_delay_s.
        if retries is None:
            retries = CONN_RETRIES
        base_s = CONN_BACKOFF_S if delay_s is None else delay_s
        async with self._connect_lock:
            if self.connected:
                return
            loop = asyncio.get_running_loop()
            last_exc: Optional[Exception] = None
            for attempt in range(retries):
                try:
                    if self.info.is_unix:
                        _, proto = await loop.create_unix_connection(
                            lambda: _RpcClientProtocol(self), self.info.unix_path
                        )
                    else:
                        _, proto = await loop.create_connection(
                            lambda: _RpcClientProtocol(self),
                            self.info.host,
                            self.info.port,
                        )
                    if self.links is not None:
                        proto.egress_link, proto.ingress_link = self.links
                    self._proto = proto
                    return
                except OSError as exc:
                    last_exc = exc
                    if attempt + 1 < retries:  # no dead-time sleep after the
                        # final attempt — the exception is the next step
                        await asyncio.sleep(_backoff_delay_s(attempt, base_s))
            raise ConnectionNotReady(f"cannot reach {self.info.url}") from last_exc

    def _on_connection_lost(self) -> None:
        self._fail_pending(ConnectionNotReady(f"connection to {self.info.url} lost"))

    def _fail_pending(self, exc: Exception) -> None:
        # ref: MochiClientHandler.channelInactive fails all pending promises
        # (MochiClientHandler.java:90-101).
        for fut in self.pending.values():
            if not fut.done():
                fut.set_exception(exc)
        self.pending.clear()
        if self._proto is not None and self._proto.transport is not None:
            self._proto.transport.close()
            self._proto = None

    async def send_and_receive(self, env: Envelope, timeout_s: float) -> Envelope:
        await self.ensure_connected()
        assert self._proto is not None
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        self.register_pending(env.msg_id, fut)
        timeout = apply_rtt_floor(timeout_s)
        try:
            self._proto.send_frame(encode_envelope(env))
            if TIMEOUT_WHEEL_QUANTUM_S > 0 and timeout > 0:
                # Coalesced timeout: one coarse wheel tick covers every
                # request expiring in the same quantum (a timeout may fire
                # up to one quantum late; responses are unaffected).
                from ..utils.wakeup import wheel_for_loop

                def _expire() -> None:
                    if not fut.done():
                        fut.set_exception(
                            asyncio.TimeoutError(
                                f"no response from {self.info.url} in {timeout}s"
                            )
                        )

                entry = wheel_for_loop(TIMEOUT_WHEEL_QUANTUM_S).call_at(
                    loop.time() + timeout, _expire
                )
                try:
                    return await fut
                finally:
                    entry.cancel()
            return await asyncio.wait_for(fut, timeout)
        finally:
            self.pending.pop(env.msg_id, None)

    async def close(self) -> None:
        if self._proto is not None and self._proto.transport is not None:
            self._proto.transport.close()
        self._fail_pending(ConnectionNotReady("closed"))
        self._proto = None


class RpcClientPool:
    """One connection per target server, created lazily
    (ref: ``MochiMessaging.java:33-45``).

    ``netsim``/``local_label``: when this pool belongs to a conditioned
    cluster (mochi_tpu_torch.netsim), each new connection gets the (egress,
    ingress) policy pair for the directed links ``local_label ->
    info.server_id`` and back — WAN shaping, loss and partitions then
    apply to every request this pool sends and every response it awaits.
    """

    def __init__(
        self,
        default_timeout_s: float = 10.0,
        netsim=None,
        local_label: Optional[str] = None,
    ):
        self.default_timeout_s = default_timeout_s
        self.netsim = netsim
        self.local_label = local_label
        self._connections: Dict[str, _Connection] = {}
        # Background straggler drains spawned by early-quorum fan_outs:
        # pool-owned so close() can cancel them (and so the tasks hold a
        # strong reference — a GC'd drain would silently stop feeding the
        # straggler metrics and leak pending-future entries).
        self._straggler_tasks: set = set()

    def _track_straggler(self, task) -> None:
        self._straggler_tasks.add(task)
        task.add_done_callback(self._straggler_tasks.discard)

    def _conn(self, info: ServerInfo) -> _Connection:
        conn = self._connections.get(info.url)
        if conn is None:
            links = None
            if self.netsim is not None:
                links = self.netsim.link_pair(
                    self.local_label or "client", info.server_id
                )
            conn = _Connection(info, links=links)
            self._connections[info.url] = conn
        return conn

    async def send_and_receive(
        self, info: ServerInfo, env: Envelope, timeout_s: Optional[float] = None
    ) -> Envelope:
        return await self._conn(info).send_and_receive(
            env, self.default_timeout_s if timeout_s is None else timeout_s
        )

    async def close(self) -> None:
        # Drain to quiescence: a fan-out running concurrently with close()
        # can register a NEW straggler while the gather is suspended, and
        # a connection can appear in _connections mid-close the same way.
        # The old blanket clear() orphaned such a straggler un-cancelled
        # (and the live-dict iteration could raise "changed size during
        # iteration"); looping until empty closes late arrivals too.
        # Outer loop over BOTH tables: a straggler spawned while a
        # conn.close() below is suspended must still get a cancellation
        # round, so re-check stragglers after the connection phase too.
        while self._straggler_tasks or self._connections:
            while self._straggler_tasks:
                pending = list(self._straggler_tasks)
                for task in pending:
                    task.cancel()
                await asyncio.gather(*pending, return_exceptions=True)
                self._straggler_tasks.difference_update(pending)
            while self._connections:
                _, conn = self._connections.popitem()
                await conn.close()


_MSG_ID_POOL = bytearray()
_MSG_ID_POS = 0


def new_msg_id() -> str:
    # Pooled entropy: one os.urandom SYSCALL per 256 ids instead of per id
    # (hot path: one id per request per target; the per-call getrandom(2)
    # was ~30 us on this host — 4% of config-1 wall).  Correlation ids need
    # uniqueness, not forward secrecy, so buffering entropy is sound; the
    # pool is process-local (never survives a fork boundary: children
    # inherit COW copies only if forked mid-run, and every server/bench
    # entry point spawns, not forks, its workers).
    global _MSG_ID_POOL, _MSG_ID_POS
    if _MSG_ID_POS + 16 > len(_MSG_ID_POOL):
        _MSG_ID_POOL = bytearray(os.urandom(4096))
        _MSG_ID_POS = 0
    out = bytes(_MSG_ID_POOL[_MSG_ID_POS : _MSG_ID_POS + 16])
    _MSG_ID_POS += 16
    return out.hex()


async def _drain_stragglers(
    fut_info: Dict[asyncio.Future, Tuple[str, Optional[str], Optional[_Connection]]],
    deadline: float,
    metrics,
    t_quorum: float,
) -> None:
    """Background half of an early-quorum fan-out: keep awaiting the
    targets the caller no longer needs, so late responses are observed —
    never silently dropped.  Each arrival feeds the per-replica
    ``fanout-straggler-ms.<sid>`` histogram (lateness past the quorum
    point) and a ``fanout.late-response.<sid>`` counter; a target that
    never answers inside the original budget is cancelled and counted as
    ``fanout.straggler-timeout.<sid>``.  Keeping the futures registered in
    ``conn.pending`` until they resolve is also connection health: the
    eventual response frame correlates normally instead of tripping the
    uncorrelated-response warning path."""
    loop = asyncio.get_running_loop()
    pending = set(fut_info)
    cancelled = False
    try:
        while pending:
            remaining = deadline - loop.time()
            if remaining <= 0:
                break
            done, pending = await asyncio.wait(
                pending, timeout=remaining, return_when=asyncio.FIRST_COMPLETED
            )
            if not done:
                break
            late_ms = (loop.time() - t_quorum) * 1e3
            for fut in done:
                sid, msg_id, conn = fut_info[fut]
                if conn is not None:
                    conn.pending.pop(msg_id, None)
                if metrics is None:
                    continue
                exc = None if fut.cancelled() else fut.exception()
                if fut.cancelled() or exc is not None:
                    # connection died / leg failed — the failure already
                    # counts toward reconnect health; tag it here too so
                    # "slowest replica" vs "dead replica" is answerable
                    metrics.mark(f"fanout.straggler-error.{sid}")
                else:
                    metrics.mark(f"fanout.late-response.{sid}")
                    metrics.histogram(
                        f"fanout-straggler-ms.{sid}", STRAGGLER_BOUNDS_MS
                    ).observe(late_ms)
    except asyncio.CancelledError:
        cancelled = True  # pool.close() mid-drain, NOT a replica fault
        raise
    finally:
        for fut in pending:
            sid, msg_id, conn = fut_info[fut]
            if conn is not None:
                conn.pending.pop(msg_id, None)
            # a future that completed while the interrupted wait was
            # resuming is an answer, not a timeout
            answered = fut.done() and not fut.cancelled()
            answered_ok = answered and fut.exception() is None
            fut.cancel()
            if metrics is None:
                continue
            if answered_ok:
                metrics.mark(f"fanout.late-response.{sid}")
            elif cancelled and not answered:
                # clean shutdown cancelled the drain: in-flight targets
                # must NOT accrue "never answered in budget" evidence —
                # operators read straggler-timeout as replica health
                metrics.mark(f"fanout.straggler-drain-cancelled.{sid}")
            elif answered:
                metrics.mark(f"fanout.straggler-error.{sid}")
            else:
                metrics.mark(f"fanout.straggler-timeout.{sid}")


async def fan_out(
    pool: RpcClientPool,
    targets: Iterable[Tuple[str, ServerInfo]],
    make_envelope: Callable[..., Envelope],
    timeout_s: Optional[float] = None,
    metrics=None,
    quorum_done: Optional[Callable[[str, object], bool]] = None,
    tracer=None,
) -> Dict[str, "Envelope | Exception"]:
    """Send one envelope per target concurrently; gather results or exceptions
    per server id (ref: ``Utils.sendMessageToServers`` + ``busyWaitForFutures``,
    ``Utils.java:65-123`` — awaiting real futures instead of 5 ms poll loops).

    ``make_envelope`` is called as ``(msg_id, server_id)`` so callers can
    authenticate per target (session MACs).  ``metrics`` (a
    :class:`~mochi_tpu_torch.utils.metrics.Metrics`) times the synchronous
    build+serialize+send loop as ``fanout-serialize-send`` — the "fan-out
    serialization" slice of the commit breakdown, distinct from the
    response wait that follows.

    ``quorum_done`` makes the fan-out QUORUM-bound instead of straggler-
    bound: it is called once per arrival as ``(server_id, envelope_or_
    exception)`` and when it returns True the fan-out returns immediately
    with everything received so far.  The still-outstanding targets are
    handed to a pool-owned background drain (:func:`_drain_stragglers`)
    that records their lateness — late responses feed metrics and resolve
    their pending-map entries; they are never silently dropped.  The
    predicate sees raw transport results (the caller authenticates inside
    it), and its verdict is advisory for LIVENESS only: callers re-tally
    the returned dict, so a buggy predicate can slow a caller down or
    return extra responses, never forge agreement.
    """
    targets = list(targets)
    # `is None` (not falsy-or): an explicit timeout_s=0 means "no waiting",
    # not "use the default".  The RTT floor then raises
    # loopback-sized budgets to >= RTT_TIMEOUT_MULT round trips under
    # conditioned/WAN links (no-op at the default floor of 0).
    timeout = pool.default_timeout_s if timeout_s is None else timeout_s
    timeout = apply_rtt_floor(timeout)
    out: Dict[str, Envelope | Exception] = {}

    # Steady state: every target connection is open, so each request is a
    # synchronous frame write plus one bare future — the whole fan-out then
    # parks on asyncio.wait (no per-target task).  The per-target
    # task/wait_for formulation costs ~10 scheduled callbacks per
    # transaction at cluster rates.
    loop = asyncio.get_running_loop()
    # future/task -> (sid, msg_id or None, connection or None): msg_id+conn
    # only for fast-path bare futures, whose pending-map entry we own.
    fut_info: Dict[asyncio.Future, Tuple[str, Optional[str], Optional[_Connection]]] = {}
    slow: List[Tuple[str, ServerInfo]] = []
    # Per-txn wire accounting (round 15): only for a head-SAMPLED trace
    # context — the lazy-label discipline: no span bookkeeping, no arg
    # building, for the ~95% of traffic the sampler skips.
    ctx = None
    if tracer is not None and tracer.enabled:
        c = obs_trace.current_ctx()
        if c is not None and c.sampled:
            ctx = c
    wire_bytes = 0
    fan_wall0 = time.time() if ctx is not None else 0.0
    fan_t0 = time.perf_counter() if ctx is not None else 0.0
    send_t0 = time.perf_counter() if metrics is not None else 0.0
    for sid, info in targets:
        conn = pool._conn(info)
        if not conn.connected:
            slow.append((sid, info))
            continue
        env = make_envelope(new_msg_id(), sid)
        fut = loop.create_future()
        try:
            # the same in-flight bound as send_and_receive: a full map
            # fails THIS leg typed (the caller's quorum math sees one more
            # error) instead of growing without bound
            conn.register_pending(env.msg_id, fut)
            assert conn._proto is not None
            frame = encode_envelope(env)
            if ctx is not None:
                wire_bytes += len(frame) + 4  # + length prefix
            conn._proto.send_frame(frame)
        except Exception as exc:
            conn.pending.pop(env.msg_id, None)
            out[sid] = exc
            continue
        fut_info[fut] = (sid, env.msg_id, conn)
    if metrics is not None:
        metrics.timers["fanout-serialize-send"].record(
            time.perf_counter() - send_t0
        )

    async def one(sid: str, info: ServerInfo) -> Envelope:
        # wait_for bounds the WHOLE leg including the TCP connect inside
        # ensure_connected — a black-holed host (dropped SYNs) otherwise
        # holds create_connection for the kernel's ~2 min connect timeout,
        # far past this fan-out's budget.
        env = make_envelope(new_msg_id(), sid)
        if ctx is not None:
            # charge the slow-path leg's frame too (encode here is cheap:
            # the envelope's _six_bytes/payload caches make it pure
            # concatenation, and send_and_receive reuses the same caches)
            nonlocal wire_bytes
            wire_bytes += len(encode_envelope(env)) + 4
        return await asyncio.wait_for(
            pool.send_and_receive(info, env, timeout),
            timeout=timeout,
        )

    # Slow path (unconnected targets: dial + handshake + request, each leg
    # bounded by `timeout` inside send_and_receive) runs CONCURRENTLY with
    # the fast-path wait — serially, one down replica would stretch the
    # whole fan-out to ~2x the budget.
    for sid, info in slow:
        fut_info[asyncio.ensure_future(one(sid, info))] = (sid, None, None)

    # Results already in `out` (send failures) can satisfy a predicate too
    # — same exception posture as the arrival loop: a predicate bug must
    # never break the fan-out itself.
    early = False
    if quorum_done is not None:
        for sid, res in out.items():
            try:
                if quorum_done(sid, res):
                    early = True
                    break
            except Exception:
                LOG.exception("fan-out predicate failed for %s", sid)

    deadline = loop.time() + timeout
    pending = set(fut_info)
    handed_off = False
    try:
        while pending and not early:
            remaining = deadline - loop.time()
            if remaining <= 0:
                break
            done, pending = await asyncio.wait(
                pending, timeout=remaining, return_when=asyncio.FIRST_COMPLETED
            )
            if not done:
                break
            for fut in done:
                sid, msg_id, conn = fut_info[fut]
                if conn is not None:
                    conn.pending.pop(msg_id, None)
                if fut.cancelled():  # e.g. a concurrent connection close
                    res: object = ConnectionNotReady(f"request to {sid} cancelled")
                else:
                    exc = fut.exception()
                    res = exc if exc is not None else fut.result()
                out[sid] = res
                # Verify-as-arrived: the predicate runs per arrival, so
                # authentication overlaps the remaining targets' network
                # wait instead of queueing behind the full fan-out.
                if not early and quorum_done is not None:
                    try:
                        if quorum_done(sid, res):
                            early = True
                    except Exception:
                        LOG.exception("fan-out predicate failed for %s", sid)
        if pending and early:
            # Quorum satisfied: hand the stragglers to the background
            # drain and return what we have.
            if metrics is not None:
                metrics.mark("fanout.early-return")
            task = loop.create_task(
                _drain_stragglers(
                    {f: fut_info[f] for f in pending},
                    deadline,
                    metrics,
                    loop.time(),
                )
            )
            pool._track_straggler(task)
            handed_off = True
        else:
            for fut in pending:
                sid, msg_id, conn = fut_info[fut]
                if conn is not None:
                    conn.pending.pop(msg_id, None)
                fut.cancel()
                out[sid] = TimeoutError(f"no response from {sid} in {timeout}s")
        pending = set()
        if ctx is not None:
            # One span per fan-out = one protocol round trip: the cost
            # card's RTT counter and wire-byte ledger (obs/trace.py).
            tracer.record(
                "client.fanout",
                ctx,
                fan_wall0,
                time.perf_counter() - fan_t0,
                args={
                    "targets": len(targets),
                    "wire_bytes": wire_bytes,
                    "rtt": 1,
                    "early": early,
                },
            )
        return out
    finally:
        # Structured concurrency: if the fan-out itself is cancelled
        # (caller deadline, shutdown), outstanding sends must not keep
        # dialing replicas in the background — unless they were already
        # handed to the pool-owned straggler drain, which owns them now.
        if pending and not handed_off:
            for fut in pending:
                sid, msg_id, conn = fut_info[fut]
                if conn is not None:
                    conn.pending.pop(msg_id, None)
                fut.cancel()
