"""Coalesced wakeups: one coarse timer services thousands of deadlines.

asyncio gives every ``sleep``/``wait_for`` its own ``TimerHandle`` on the
loop's heap.  At benchmark front-end scale (``benchmarks/config9_overload``:
thousands of concurrent client sessions, each with a request timeout and a
backoff sleep in flight) that is thousands of heap entries and — worse —
thousands of *distinct wakeups*: the loop gets scheduled once per expiring
timer, paying a full poll/dispatch cycle to fire one callback.

:class:`TimerWheel` rounds deadlines up to a coarse quantum (default 20 ms)
and keeps ONE pending loop timer — the earliest non-empty bucket.  A tick
fires every deadline of its bucket in one wakeup.  Cancellation is lazy and
O(1): entries carry a ``cancelled`` flag and are skipped at fire time, so
the hot path (schedule + cancel on completion, the fate of ~every request
timeout) never touches the loop's timer heap at all.

Coarseness is the contract: a wheel deadline fires up to ``quantum_s``
LATE, never early.  That is exactly right for timeouts and backoff jitter
(both already tolerate far larger skew) and exactly wrong for anything
needing sub-quantum precision — don't route benchmark timing through it.
"""

from __future__ import annotations

import asyncio
from typing import Callable, Dict, List, Optional


class _Entry:
    __slots__ = ("callback", "cancelled")

    def __init__(self, callback: Callable[[], None]) -> None:
        self.callback = callback
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True


class TimerWheel:
    """``wheel.call_at(deadline, cb)`` / ``await wheel.sleep(delay)`` with
    one loop timer total.  Bound to the running loop on first use; a wheel
    must not be shared across loops (``asyncio.run`` per test creates a
    fresh loop — use :func:`wheel_for_loop` for a per-loop instance)."""

    def __init__(self, quantum_s: float = 0.02) -> None:
        self.quantum_s = quantum_s
        self._buckets: Dict[int, List[_Entry]] = {}
        self._handle: Optional[asyncio.TimerHandle] = None
        self._armed_tick: Optional[int] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        # observability (admin "overload" surface / benchmark record)
        self.scheduled = 0
        self.fired = 0
        self.lapsed = 0  # entries already cancelled when their tick fired

    def _tick_of(self, deadline: float) -> int:
        # round UP: never fire early (a timeout firing before its deadline
        # would fail a healthy in-budget request)
        q = self.quantum_s
        return -int(-deadline // q)  # ceil(deadline / q) without float drift

    def call_at(self, deadline: float, callback: Callable[[], None]) -> _Entry:
        """Schedule ``callback`` for (at most one quantum after) ``deadline``
        (loop-monotonic seconds).  Returns a handle with ``.cancel()``."""
        loop = asyncio.get_running_loop()
        if self._loop is None:
            self._loop = loop
        entry = _Entry(callback)
        tick = self._tick_of(deadline)
        bucket = self._buckets.get(tick)
        if bucket is None:
            self._buckets[tick] = [entry]
            if self._armed_tick is None or tick < self._armed_tick:
                self._arm(tick)
        else:
            bucket.append(entry)
        self.scheduled += 1
        return entry

    def call_later(self, delay_s: float, callback: Callable[[], None]) -> _Entry:
        return self.call_at(
            asyncio.get_running_loop().time() + max(0.0, delay_s), callback
        )

    async def sleep(self, delay_s: float) -> None:
        """Coalesced ``asyncio.sleep`` (may oversleep by one quantum)."""
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        entry = self.call_at(
            loop.time() + max(0.0, delay_s),
            lambda: fut.done() or fut.set_result(None),
        )
        try:
            await fut
        finally:
            entry.cancel()

    def _arm(self, tick: int) -> None:
        if self._handle is not None:
            self._handle.cancel()
        self._armed_tick = tick
        assert self._loop is not None
        self._handle = self._loop.call_at(
            tick * self.quantum_s, self._fire, tick
        )

    def _fire(self, tick: int) -> None:
        self._handle = None
        self._armed_tick = None
        now_tick = self._tick_of(self._loop.time()) if self._loop else tick
        # fire every bucket that is due (a long loop stall may owe several)
        due = sorted(t for t in self._buckets if t <= max(tick, now_tick))
        for t in due:
            for entry in self._buckets.pop(t):
                if entry.cancelled:
                    self.lapsed += 1
                    continue
                self.fired += 1
                try:
                    entry.callback()
                except Exception:  # a timeout callback bug must not kill the wheel
                    import logging

                    logging.getLogger(__name__).exception("wheel callback failed")
        if self._buckets:
            self._arm(min(self._buckets))

    def close(self) -> None:
        if self._handle is not None:
            self._handle.cancel()
            self._handle = None
        self._armed_tick = None
        self._buckets.clear()

    def stats(self) -> Dict[str, int]:
        return {
            "pending": sum(len(b) for b in self._buckets.values()),
            "buckets": len(self._buckets),
            "scheduled": self.scheduled,
            "fired": self.fired,
            "lapsed": self.lapsed,
        }


_WHEELS: "Dict[int, TimerWheel]" = {}


def wheel_for_loop(quantum_s: float = 0.02) -> TimerWheel:
    """Per-event-loop shared wheel (keyed by loop id; the wheel's strong
    ``_loop`` reference keeps the id stable for its lifetime).  Wheels of
    CLOSED loops are pruned when the registry grows — never wheels of
    other live loops, whose armed timers and buckets must survive."""
    loop = asyncio.get_running_loop()
    key = id(loop)
    wheel = _WHEELS.get(key)
    if wheel is None or (wheel._loop is not None and wheel._loop is not loop):
        if len(_WHEELS) > 8:
            for k, w in list(_WHEELS.items()):
                if w._loop is not None and w._loop.is_closed():
                    w.close()
                    del _WHEELS[k]
        wheel = TimerWheel(quantum_s)
        _WHEELS[key] = wheel
    return wheel
