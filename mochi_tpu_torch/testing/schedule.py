"""Deterministic schedule explorer: seeded wake-order perturbation + replay.

A loom-style sanitizer that DRIVES interleavings.  The replica's
concurrency discipline is "the event loop is the lock": correctness must not
depend on the ORDER tasks happen to wake at a suspension point, because the
stock event loop's FIFO ready queue explores exactly one order per run.
:class:`ExplorerLoop` replaces that single order with a seeded permutation:

* every event-loop tick, the ready queue (all callbacks scheduled since the
  last tick — task wakeups, future resolutions, ``call_soon``\\ s) is
  shuffled by a ``random.Random(seed)`` stream before it drains, so each
  seed explores one reproducible wake order at every await point;
* every executed callback is appended to ``loop.trace`` under a
  deterministic label (tasks are renamed ``t0, t1, ...`` by creation order
  by the loop's task factory), so two runs can be compared byte-for-byte;
* timers keep their deadline order (perturbing TIME would just test the
  clock); ties and same-tick wakeups are where the permutation bites.

Determinism contract: for a workload whose external inputs are themselves
deterministic (no real sockets, no wall-clock branching, no completions
arriving from other threads), ``same seed ⇒ byte-identical trace AND
identical verdict``.  That is what makes a failing seed a *reproduction*, not
an anecdote: re-run it and watch the same interleaving fail the same way
(``tests/test_torch_schedule.py`` pins this).  Real network IO
(VirtualCluster over UDS/TCP) and a verifier whose batches complete on an
executor thread (``BatchingVerifier`` over the card) still get meaningful
wake-order perturbation, but kernel readiness and thread completion timing
keep byte-identity off the table — the socket-free drives in the tests
exist precisely so the Write1→reclaim→Write2 and handle_batch→
session-eviction windows explore deterministically.

Reproducing a failure:

    report = schedule.explore(make_case, seeds=range(64))
    # report.failures -> [ScheduleResult(seed=17, error="KeyError: ...")]
    again = schedule.run_case(make_case, seed=17)
    assert again.error == report.failures[0].error          # same crash
    assert again.trace == report.failures[0].trace          # same schedule

``MOCHI_SCHED_SEEDS`` widens the exploration range in the slow legs without
editing tests; a failing seed printed by a CI run is replayed locally with
``run_case(make_case, seed=N)``.
"""

from __future__ import annotations

import asyncio
import functools
import itertools
import os
import random
import weakref
from dataclasses import dataclass, field
from typing import Awaitable, Callable, Iterable, List, Optional


def exploration_seeds(default: int = 16) -> range:
    """Seed range for the slow exploration legs: ``MOCHI_SCHED_SEEDS``
    overrides the count (more seeds = more interleavings = more wall time)."""
    return range(int(os.environ.get("MOCHI_SCHED_SEEDS", str(default))))


class ExplorerLoop(asyncio.SelectorEventLoop):
    """A selector event loop whose ready-queue drain order is a seeded
    permutation and whose every executed callback is traced.

    The perturbation point is :meth:`_run_once` — the single place the
    stock loop commits to FIFO.  Shuffling there reorders all same-tick
    wakeups (which is where await-interleaving races live) while leaving
    the loop's own bookkeeping untouched; expired timers are appended by
    the base class after the shuffle, in deadline order, which keeps
    virtual-duration reasoning intact.
    """

    def __init__(self, seed: int):
        super().__init__()
        self.seed = seed
        self._rng = random.Random(seed)
        self.trace: List[str] = []
        self._task_counter = itertools.count()
        # Handles whose callback is the LOOP'S OWN bookkeeping (bound
        # methods of this loop, e.g. ``_sock_write_done`` scheduled as a
        # sock_connect future's done-callback): these must keep their
        # exact FIFO slots.  Found by the scenario engine, which drives
        # real socket clusters on this loop: shuffling ``_sock_write_done``
        # AFTER the task wakeup that creates the connection's transport
        # makes ``remove_writer`` trip
        # ``_ensure_fd_no_transport`` ("File descriptor N is used by
        # transport...") and leaves the connect watcher registered.  The
        # perturbation thesis is about APPLICATION wake order; the loop's
        # internal fd bookkeeping is the machinery underneath it.
        self._internal: "weakref.WeakSet" = weakref.WeakSet()
        self.set_task_factory(self._deterministic_task_factory)

    # ---------------------------------------------------------- determinism

    def _deterministic_task_factory(self, loop, coro, **kwargs):
        # Replace the process-global "Task-N" counter (it keeps counting
        # across runs, so run 2's trace would never match run 1's) with a
        # per-loop one.
        kwargs.pop("name", None)
        return asyncio.Task(coro, loop=loop, name=f"t{next(self._task_counter)}")

    def _label(self, callback) -> str:
        owner = getattr(callback, "__self__", None)
        if owner is not None:
            get_name = getattr(owner, "get_name", None)
            base = get_name() if callable(get_name) else type(owner).__name__
            return f"{base}.{getattr(callback, '__name__', 'step')}"
        fn = callback
        while isinstance(fn, functools.partial):
            fn = fn.func
        return getattr(fn, "__qualname__", type(fn).__name__)

    def _traced(self, callback):
        def run_traced(*args):
            self.trace.append(self._label(callback))
            return callback(*args)

        return run_traced

    # ------------------------------------------------------------ overrides

    def _is_asyncio_internal(self, callback) -> bool:
        """asyncio's own plumbing — loop fd bookkeeping, transport/stream
        protocol callbacks like ``SubprocessStreamProtocol.connection_
        made`` — assumes the FIFO ready order it was written against
        (e.g. ``_sock_write_done`` before the connect's task wakeup,
        ``connection_made`` before ``subprocess_exec``'s waiter wakeup).
        Task wakeups/steps are the exception: they are exactly what the
        explorer exists to perturb, so they stay shuffled even though
        they live in ``asyncio.tasks``."""
        fn = callback
        while isinstance(fn, functools.partial):
            fn = fn.func
        owner = getattr(fn, "__self__", None)
        if owner is self:
            return True
        mod = getattr(fn, "__module__", None) or ""
        if not mod.startswith("asyncio"):
            return False
        return not isinstance(owner, asyncio.Task)

    def call_soon(self, callback, *args, context=None):
        if self._is_asyncio_internal(callback):
            # untraced AND a shuffle barrier: loop/transport bookkeeping
            # keeps its FIFO slot (see _internal above) and stays out of
            # the trace — it is the machinery, not a schedulable wakeup
            handle = super().call_soon(callback, *args, context=context)
            self._internal.add(handle)
            return handle
        return super().call_soon(self._traced(callback), *args, context=context)

    def call_at(self, when, callback, *args, context=None):
        return super().call_at(
            when, self._traced(callback), *args, context=context
        )

    def _run_once(self):
        ready = self._ready
        if len(ready) > 1:
            batch = list(ready)
            ready.clear()
            # Loop-internal bookkeeping handles are BARRIERS: application
            # callbacks shuffle freely within each segment between them,
            # but never cross one (a sock_connect's task wakeup scheduled
            # after ``_sock_write_done`` must stay after it — fd
            # bookkeeping happens-before the wakeups it unblocks).
            start = 0
            for i, h in enumerate(batch):
                if h in self._internal:
                    seg = batch[start:i]
                    self._rng.shuffle(seg)
                    batch[start:i] = seg
                    start = i + 1
            seg = batch[start:]
            self._rng.shuffle(seg)
            batch[start:] = seg
            ready.extend(batch)
        super()._run_once()


@dataclass
class ScheduleResult:
    """One seeded run: the verdict and the schedule that produced it."""

    seed: int
    error: Optional[str]  # "ExcType: message", or None on a clean pass
    trace: List[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return self.error is None

    def trace_bytes(self) -> bytes:
        """The canonical byte form two runs are compared in (the
        replayability property is *byte*-identity, not list equality,
        so the pin survives any future trace-entry formatting drift)."""
        return "\n".join(self.trace).encode()


@dataclass
class ExplorationReport:
    results: List[ScheduleResult]

    @property
    def failures(self) -> List[ScheduleResult]:
        return [r for r in self.results if not r.ok]

    @property
    def ok(self) -> bool:
        return not self.failures

    def summary(self) -> str:
        bad = self.failures
        return (
            f"{len(self.results)} seeds explored, {len(bad)} failing"
            + (f" (replay with run_case(make_case, seed={bad[0].seed}))" if bad else "")
        )


def run_case(
    make_case: Callable[[], Awaitable[None]],
    seed: int,
    timeout_s: float = 60.0,
) -> ScheduleResult:
    """Run one seeded schedule of ``make_case`` on a fresh ExplorerLoop.

    The case factory is called INSIDE the new loop's context and must build
    everything it touches (clusters, stores, tasks) itself — state reused
    across seeds would let one schedule contaminate the next and break
    replay.  Any exception (assertion failures included) becomes the
    result's ``error``; the loop is torn down completely either way.
    """
    loop = ExplorerLoop(seed)
    asyncio.set_event_loop(loop)
    error: Optional[str] = None
    try:
        loop.run_until_complete(asyncio.wait_for(make_case(), timeout_s))
    except (KeyboardInterrupt, SystemExit):
        raise
    except BaseException as exc:
        error = f"{type(exc).__name__}: {exc}"
    finally:
        try:
            pending = asyncio.all_tasks(loop)
            for task in pending:
                task.cancel()
            if pending:
                loop.run_until_complete(
                    asyncio.gather(*pending, return_exceptions=True)
                )
            loop.run_until_complete(loop.shutdown_asyncgens())
        finally:
            asyncio.set_event_loop(None)
            loop.close()
    return ScheduleResult(seed=seed, error=error, trace=list(loop.trace))


def explore(
    make_case: Callable[[], Awaitable[None]],
    seeds: Iterable[int],
    timeout_s: float = 60.0,
) -> ExplorationReport:
    """Run ``make_case`` once per seed; collect every verdict.  Failures
    carry their full trace — hand the seed to :func:`run_case` to replay."""
    return ExplorationReport([run_case(make_case, s, timeout_s) for s in seeds])
