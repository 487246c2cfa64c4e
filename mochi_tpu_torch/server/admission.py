"""Admission control: deterministic load signal, bounded session state,
handshake rate limiting.

Replaces the earlier wall-clock loop-lag shed signal (``_lag_monitor``),
which was OFF by default in every harness because an event-loop stall the
*harness* caused (first-use JAX compiles, multi-ms pure-Python crypto) was
indistinguishable from real overload — the monitor shed Write1s in response
to the test environment and flaked raw-envelope tests at random.

The replacement reads only EVENT-COUNTED state, so a stall can inflate the
signal by at most the requests actually queued behind it (bounded by the
client population), never by the stall's duration:

* **dispatch pressure** — envelopes inside in-flight async batch tasks plus
  the EWMA of frames-per-drain-tick (``RpcServer.load_stats``): arrivals
  outpacing service stack up in kernel buffers and land together on the
  next poll, so the per-tick batch grows with backlog;
* **verify occupancy** — signature-check items currently awaiting the
  verifier (the write path's real service center);
* **send-queue pressure** — response bytes buffered for slow readers plus
  connections paused at the transport high-water mark.

Each component is normalized by its high-water knob; the overall load
factor ``L`` is the worst of them.  The shed probability tracks the classic
excess-demand fraction ``1 - 1/L`` (at L=2x capacity, shed half), smoothed
per *update event* — not per wall-clock tick — and capped at 0.9 so a
diagnosable trickle always survives.  ``retry_after_ms`` scales with L so
shed clients back off harder the deeper the overload.

:class:`SessionTable` bounds the replica's ``sender_id -> MAC key`` map
(LRU + idle TTL; an evicted client transparently re-handshakes), with a
pin refcount so a sender whose request is mid-batch is never evicted
between its auth check and its response.  :class:`TokenBucket` bounds the
handshake rate: X25519+Ed25519 handshakes are the most expensive
unauthenticated work a replica performs, so a handshake storm must not be
able to buy unbounded CPU (the client side already TTL-caches failures —
the client's ``SESSION_FAILURE_TTL_S``; this is the server half).
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

# High-water knobs (env-tunable; docs/OPERATIONS.md §4g).  Defaults sized
# so no existing in-process test can trip them by accident: a 5-client
# closed-loop harness tops out near batch_ewma ~5 and inflight ~10.
SHED_BATCH_HW = float(os.environ.get("MOCHI_SHED_BATCH_HW", "64"))
SHED_INFLIGHT_HW = float(os.environ.get("MOCHI_SHED_INFLIGHT_HW", "384"))
SHED_VERIFY_HW = float(os.environ.get("MOCHI_SHED_VERIFY_HW", "384"))
SHED_SENDQ_HW = float(os.environ.get("MOCHI_SHED_SENDQ_HW", str(2 * 1024 * 1024)))

SESSION_MAX = int(os.environ.get("MOCHI_SESSION_MAX", "8192"))
SESSION_TTL_S = float(os.environ.get("MOCHI_SESSION_TTL_S", "1800"))

HANDSHAKE_RATE = float(os.environ.get("MOCHI_HANDSHAKE_RATE", "512"))
HANDSHAKE_BURST = float(os.environ.get("MOCHI_HANDSHAKE_BURST", "1024"))


class SessionTable:
    """LRU + idle-TTL bounded ``sender_id -> session MAC key`` map.

    Supports the dict surface the replica already used (``get``/``pop``/
    ``__setitem__``/``__len__``/``__contains__``) so call sites stay
    unchanged, plus:

    * ``get`` refreshes recency (a live session is never the LRU victim
      while it keeps authenticating traffic);
    * ``pin``/``unpin`` refcount a sender across an await (handle_batch
      pins each MAC'd sender for the batch's lifetime) — eviction skips
      pinned entries, so a session can never vanish between its envelope's
      auth check and its response's seal;
    * eviction is capacity- and TTL-driven only, counted in ``evictions``
      (the bounded-memory observable config-9 publishes).
    """

    def __init__(self, max_entries: int = SESSION_MAX, ttl_s: float = SESSION_TTL_S):
        self.max_entries = max_entries
        self.ttl_s = ttl_s
        self._entries: Dict[str, tuple] = {}  # sender -> (key, last_used)
        self._pins: Dict[str, int] = {}
        # senders whose policy eviction arrived while they were pinned
        # mid-batch: dropped at final unpin, never between auth and seal
        self._deferred_evictions: set = set()
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, sender: str) -> bool:
        return sender in self._entries

    def __getitem__(self, sender: str) -> bytes:
        key = self.get(sender)
        if key is None:
            raise KeyError(sender)
        return key

    def get(self, sender: str, default=None):
        entry = self._entries.get(sender)
        if entry is None:
            return default
        # refresh recency: del+reinsert keeps dict insertion order = LRU
        del self._entries[sender]
        self._entries[sender] = (entry[0], time.monotonic())
        return entry[0]

    def __setitem__(self, sender: str, key: bytes) -> None:
        now = time.monotonic()
        # a fresh handshake supersedes any pending policy eviction — the
        # ban (replica._client_bans) is what keeps an evicted client out
        self._deferred_evictions.discard(sender)
        if sender in self._entries:
            del self._entries[sender]
        elif len(self._entries) >= self.max_entries:
            self._evict_one(now)
        self._entries[sender] = (key, now)

    def pop(self, sender: str, default=None):
        entry = self._entries.pop(sender, None)
        return default if entry is None else entry[0]

    def pin(self, sender: str) -> None:
        self._pins[sender] = self._pins.get(sender, 0) + 1

    def unpin(self, sender: str) -> None:
        n = self._pins.get(sender, 0) - 1
        if n <= 0:
            self._pins.pop(sender, None)
            if sender in self._deferred_evictions:
                self._deferred_evictions.discard(sender)
                if self._entries.pop(sender, None) is not None:
                    self.evictions += 1
        else:
            self._pins[sender] = n

    def evict(self, sender: str) -> str:
        """Policy eviction (replica ``evict_client`` hook) that cannot
        reintroduce the pin bug: a pinned (mid-batch) sender is marked for
        deferred drop at its final unpin — its in-flight responses still
        seal under the live session — while an unpinned one drops now.
        Returns ``"evicted"``, ``"deferred"``, or ``"absent"``; purely
        synchronous, so a caller's check-then-act stays in one loop turn.
        """
        if sender not in self._entries:
            return "absent"
        if sender in self._pins:
            self._deferred_evictions.add(sender)
            return "deferred"
        del self._entries[sender]
        self.evictions += 1
        return "evicted"

    def _evict_one(self, now: float) -> None:
        """Capacity eviction: the first unpinned entry in dict order.
        ``get`` re-inserts on every hit, so dict order IS last-use order —
        the first unpinned entry is the most idle one, which also means a
        TTL-expired entry (if any exists) is necessarily chosen before any
        still-fresh entry.  A fully pinned table (every entry mid-batch —
        requires max_entries concurrent senders in one drain) admits one
        entry over cap rather than corrupt a batch."""
        victim = None
        for sender, (_, last) in self._entries.items():  # insertion = LRU order
            if sender in self._pins:
                continue
            victim = sender
            break
        if victim is not None:
            del self._entries[victim]
            self.evictions += 1

    def sweep(self, now: Optional[float] = None) -> int:
        """Drop unpinned entries idle past the TTL (called opportunistically
        from the replica's admission updates, not a timer — idle-session
        memory is reclaimed when there is traffic to pay for the sweep)."""
        if self.ttl_s <= 0:
            return 0
        now = time.monotonic() if now is None else now
        cutoff = now - self.ttl_s
        dead = [
            s
            for s, (_, last) in self._entries.items()
            if last < cutoff and s not in self._pins
        ]
        for s in dead:
            del self._entries[s]
        self.evictions += len(dead)
        return len(dead)

    def stats(self) -> Dict[str, int]:
        return {
            "size": len(self._entries),
            "max": self.max_entries,
            "pinned": len(self._pins),
            "evictions": self.evictions,
        }


class TokenBucket:
    """Monotonic-clock token bucket (handshake-storm valve).  Rate limiting
    is inherently time-based; unlike the old lag signal a *stall* only ever
    ADDS tokens (the bucket refills while the loop is busy), so the failure
    mode is admitting a burst after a stall — never spuriously refusing."""

    def __init__(self, rate_per_s: float = HANDSHAKE_RATE, burst: float = HANDSHAKE_BURST):
        self.rate = rate_per_s
        self.burst = burst
        self._tokens = burst
        self._last = time.monotonic()
        self.refused = 0

    def admit(self, n: float = 1.0) -> bool:
        if self.rate <= 0:
            return True  # disabled
        now = time.monotonic()
        self._tokens = min(self.burst, self._tokens + (now - self._last) * self.rate)
        self._last = now
        if self._tokens >= n:
            self._tokens -= n
            return True
        self.refused += 1
        return False

    def retry_after_ms(self) -> int:
        if self.rate <= 0:
            return 0
        deficit = max(0.0, 1.0 - self._tokens)
        return max(10, int(deficit / self.rate * 1e3))


class AdmissionController:
    """Shed-probability controller over the deterministic load signal.

    ``update()`` is called at each Write1 batch (the only shed point) and
    from the admin surfaces; it is O(1).  ``pin(p)`` freezes the output for
    tests (the old tests cancelled the lag task to the same end)."""

    def __init__(
        self,
        rpc,
        enabled: bool = True,
        batch_hw: float = SHED_BATCH_HW,
        inflight_hw: float = SHED_INFLIGHT_HW,
        verify_hw: float = SHED_VERIFY_HW,
        sendq_hw: float = SHED_SENDQ_HW,
        max_shed_p: float = 0.9,
    ):
        self.rpc = rpc
        self.enabled = enabled
        self.batch_hw = batch_hw
        self.inflight_hw = inflight_hw
        self.verify_hw = verify_hw
        self.sendq_hw = sendq_hw
        self.max_shed_p = max_shed_p
        self.shed_p = 0.0
        self.load = 0.0
        self.overloaded = False
        self.retry_after_ms = 0
        self.verify_inflight = 0  # maintained by the replica around verify awaits
        self._pinned: Optional[float] = None

    def pin(self, p: Optional[float]) -> None:
        """Freeze shed_p (tests); ``pin(None)`` unfreezes."""
        self._pinned = p
        if p is not None:
            self.shed_p = p

    def update(self) -> None:
        t = self.rpc.load_stats()
        load = max(
            t["batch_ewma"] / self.batch_hw,
            t["inflight_envs"] / self.inflight_hw,
            self.verify_inflight / self.verify_hw,
            # a few flow-paused peers are their own (bounded) problem; a
            # crowd of them means responses aren't leaving this process
            t["sendq_out_bytes"] / self.sendq_hw + t["paused_conns"] / 16.0,
        )
        self.load = load
        self.overloaded = load > 1.0
        # Backlog-drain hint: one quantum per unit of excess load, jittered
        # client-side.  Bounded so a transient spike cannot park clients.
        self.retry_after_ms = (
            min(2000, int(25 * load)) if load > 1.0 else 0
        )
        if self._pinned is not None:
            self.shed_p = self._pinned
            return
        if not self.enabled:
            self.shed_p = 0.0
            return
        target = 0.0 if load <= 1.0 else min(self.max_shed_p, 1.0 - 1.0 / load)
        # Event-smoothed (per update, not per wall-clock tick): halves the
        # distance each Write1 batch, fast enough to engage within a burst,
        # slow enough not to slam to max on one outlier tick.
        self.shed_p += 0.5 * (target - self.shed_p)
        if self.shed_p < 1e-3:
            self.shed_p = 0.0

    def stats(self) -> Dict[str, object]:
        t = self.rpc.load_stats()
        return {
            "enabled": self.enabled,
            "shed_p": round(self.shed_p, 4),
            "load": round(self.load, 4),
            "overloaded": self.overloaded,
            "retry_after_ms": self.retry_after_ms,
            "verify_inflight": self.verify_inflight,
            **t,
        }
