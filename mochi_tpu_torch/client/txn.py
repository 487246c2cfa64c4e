"""Transaction-level client helpers: the fluent builder
(ref: ``client/TransactionBuilder.java:14-57``) plus the incremental
quorum-tracking state machines behind the early-quorum write path —
:class:`GrantAssembler` (Write1 certificate assembly as grants arrive) and
:class:`QuorumTally` (per-op 2f+1 agreement as read/Write2 answers arrive).

Both trackers are LIVENESS devices only: they decide when the client may
stop *waiting*.  The authoritative safety checks — the timestamp-consistent
grant subset and the per-op >= 2f+1 tally — are re-run by
``client.MochiDBClient`` over the returned responses, so a tracker bug can
delay a transaction but can never commit one on thin evidence.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Set

from ..obs import trace as obs_trace
from ..protocol import Action, MultiGrant, Operation, Transaction


class _NoopStage:
    """Shared do-nothing stage span (tracing off / head-unsampled): the
    hot path pays one attribute test and zero allocations."""

    __slots__ = ()

    def __enter__(self) -> "_NoopStage":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pass


_NOOP_STAGE = _NoopStage()


class _StageSpan:
    """One client txn stage as a span: picks its span id up front and
    points ``obs.trace.CURRENT`` at a child context for its duration, so
    every envelope the stage fans out parents the remote side's spans
    under THIS stage (write1-phase / write2-fanout-wait / ...)."""

    __slots__ = ("tracer", "ctx", "name", "sid", "_t0", "_wall0", "_tok")

    def __init__(self, tracer: "obs_trace.Tracer", ctx, name: str):
        self.tracer = tracer
        self.ctx = ctx
        self.name = name
        self.sid = tracer.new_span_id()
        self._tok = None

    def __enter__(self) -> "_StageSpan":
        self._wall0 = time.time()
        self._t0 = time.perf_counter()
        self._tok = obs_trace.CURRENT.set(self.ctx.child(self.sid))
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._tok is not None:
            obs_trace.CURRENT.reset(self._tok)
        self.tracer.record(
            self.name,
            self.ctx,
            self._wall0,
            time.perf_counter() - self._t0,
            span_id=self.sid,
            args={"error": exc_type.__name__} if exc_type is not None else None,
            force=exc_type is not None,  # always-sample upgrade on error
        )


class TxnTrace:
    """Per-transaction causal-trace handle — the MINT POINT of
    causal tracing: one :class:`~mochi_tpu_torch.obs.trace.TraceContext`
    (trace_id, span_id, parent_id, sampled) per client transaction, with
    head-based seeded sampling decided here and nowhere else.

    Used as a context manager around the whole transaction: ``CURRENT``
    carries the context across every await of the txn's task (so error
    paths can force-sample even when the head verdict was "skip"), stages
    open child spans via :meth:`stage`, and the root span records at exit
    (name ``txn.write`` / ``txn.read``, error-forced when the transaction
    raised).  With tracing disabled the whole object costs one ``None``
    check per call site.
    """

    __slots__ = ("tracer", "ctx", "kind", "_t0", "_wall0", "_tok")

    def __init__(self, tracer: "Optional[obs_trace.Tracer]", kind: str):
        self.tracer = tracer
        self.kind = kind
        self.ctx = tracer.mint() if tracer is not None else None
        self._tok = None

    def __enter__(self) -> "TxnTrace":
        if self.ctx is not None:
            self._wall0 = time.time()
            self._t0 = time.perf_counter()
            self._tok = obs_trace.CURRENT.set(self.ctx)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self.ctx is None:
            return
        if self._tok is not None:
            obs_trace.CURRENT.reset(self._tok)
        self.tracer.record(
            self.kind,
            self.ctx,
            self._wall0,
            time.perf_counter() - self._t0,
            span_id=self.ctx.span_id,  # the root span records itself
            args={"error": exc_type.__name__} if exc_type is not None else None,
            force=exc_type is not None,
        )

    def stage(self, name: str):
        """Child span for one protocol stage; no-op unless head-sampled."""
        if self.ctx is None or not self.ctx.sampled:
            return _NOOP_STAGE
        return _StageSpan(self.tracer, self.ctx, name)


class GrantAssembler:
    """Incremental write-certificate assembly (the Write1 half of the
    pipelined write path): MultiGrants feed in as responses arrive, and
    :meth:`add` reports the moment a timestamp-consistent per-key 2f+1
    subset exists — the signal to dispatch Write2 immediately instead of
    waiting out the full replica set.

    ``subset_fn`` is the client's authoritative subset computation
    (``MochiDBClient._quorum_grant_subset`` closed over the transaction),
    so assembly-time and tally-time consistency can never diverge.  Grants
    dedup by issuing server (latest wins) — a replica re-answering after a
    session retry must not double its timestamp vote.
    """

    def __init__(self, subset_fn: Callable[[List[MultiGrant]], Optional[List[MultiGrant]]]):
        self._subset_fn = subset_fn
        self._by_server: Dict[str, MultiGrant] = {}
        self.chosen: Optional[List[MultiGrant]] = None

    def add(self, grant: MultiGrant) -> bool:
        """Feed one authenticated MultiGrant; True once a consistent
        quorum subset exists (recorded in ``chosen``)."""
        self._by_server[grant.server_id] = grant
        if self.chosen is None:
            self.chosen = self._subset_fn(list(self._by_server.values()))
        return self.chosen is not None


class QuorumTally:
    """Incremental per-operation agreement counter for read / Write2
    responses: one vote per replica, restricted to each operation's
    replica set, grouped by a caller-supplied result fingerprint.
    :meth:`add` returns True once EVERY operation has some fingerprint
    with >= ``quorum`` votes — the earliest moment the caller's own
    authoritative tally over the same responses can possibly succeed."""

    def __init__(self, rsets: Sequence[Set[str]], quorum: int):
        self.rsets = list(rsets)
        self.quorum = quorum
        self._counts = [defaultdict(int) for _ in self.rsets]
        self._seen: Set[str] = set()
        self._op_done = [False] * len(self.rsets)
        self._pending_ops = len(self.rsets)

    def add(self, sid: str, operations: Sequence, fingerprint: Callable) -> bool:
        """Tally one replica's per-op results.  ``fingerprint(op_result)``
        returns a hashable agreement key, or None to skip the op (e.g. a
        WRONG_SHARD filler)."""
        if sid in self._seen:
            return self.satisfied
        self._seen.add(sid)
        for i, rset in enumerate(self.rsets):
            if sid not in rset or i >= len(operations):
                continue
            fp = fingerprint(operations[i])
            if fp is None:
                continue
            counts = self._counts[i]
            counts[fp] += 1
            if not self._op_done[i] and counts[fp] >= self.quorum:
                self._op_done[i] = True
                self._pending_ops -= 1
        return self._pending_ops == 0

    @property
    def satisfied(self) -> bool:
        return self._pending_ops == 0


class TransactionBuilder:
    def __init__(self) -> None:
        self._ops: List[Operation] = []

    def write(self, key: str, value: bytes | str) -> "TransactionBuilder":
        if isinstance(value, str):
            value = value.encode("utf-8")
        self._ops.append(Operation(Action.WRITE, key, value))
        return self

    def write_without_value(self, key: str) -> "TransactionBuilder":
        self._ops.append(Operation(Action.WRITE, key, None))
        return self

    def read(self, key: str) -> "TransactionBuilder":
        self._ops.append(Operation(Action.READ, key))
        return self

    def delete(self, key: str) -> "TransactionBuilder":
        self._ops.append(Operation(Action.DELETE, key))
        return self

    def build(self) -> Transaction:
        if not self._ops:
            raise ValueError("empty transaction")
        return Transaction(tuple(self._ops))
