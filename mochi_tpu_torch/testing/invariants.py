"""Continuous safety-invariant checking for adversarial scenarios.

The paper's quorum protocol claims safety under f Byzantine replicas.  This
module turns that claim into a harness observable: an
:class:`InvariantChecker` samples the HONEST replicas' stores while an
adversarial workload runs and accumulates violations of these invariants:

1. **Certificate agreement** — no two conflicting certificates commit for
   the same object timestamp: every honest replica holding a committed
   certificate for ``(key, certified_ts, configstamp)`` must have committed
   the SAME transaction there (checked across replicas per sample, and
   against every previous sample — an overwrite at an already-committed
   timestamp is a violation even if the replicas momentarily agree).

2. **Epoch monotonicity** — per (honest replica, key), ``current_epoch``
   and the certified timestamp never move backwards (a replayed stale
   certificate regressing a commit would trip this immediately).

3. **Acked durability** — every write the workload saw acknowledged is
   readable afterwards: :meth:`final_check` re-reads each acked key
   through a real client (quorum read, with the SDK's recovery machinery —
   that IS the system's contract) and requires the latest acked value.

4. **Reclaimed-slot integrity** (grant reclamation) — a
   replica that reclaimed a slot never re-grants it (the superseding
   grant sits at a strictly higher timestamp), so that replica's own
   validly-signed OK grant for the reclaimed (key, timestamp) may only
   ever appear inside a committed certificate carrying the ORIGINAL
   grantee's transaction hash (the withheld write legitimately
   committing late).  Finding it under a DIFFERENT hash proves the slot
   was double-granted.  Deliberately scoped to the reclaiming replica's
   own grant: slot ownership is per-replica (epochs bump independently),
   so an honest certificate built from OTHER replicas' grants may
   legally occupy the same (key, ts) a laggard reclaimed — that
   coexistence is not a violation.

5. **Durable-replay integrity** (``mochi_tpu_torch/storage``) — a
   replica recovered from disk never silently serves tampered log state:
   every conviction its replay verifier attributed (forged grant
   signature, reordered sequence, torn non-final segment, rejected
   snapshot entry) is surfaced per entry in the report, and for the
   conviction classes where the entry was REFUSED adoption outright the
   checker asserts the replica's live store is not serving the convicted
   transaction (adoption-refused state showing up anyway would mean the
   replay verifier was bypassed).  Convictions themselves are the system
   WORKING — they count as evidence, not violations.

The checker never looks inside Byzantine replicas: the invariants
constrain what the HONEST side of the cluster may do while <= f members
behave arbitrarily.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Dict, List, Optional, Sequence, Tuple

from ..protocol import transaction_hash

LOG = logging.getLogger(__name__)


class InvariantChecker:
    """``checker = InvariantChecker(vc.honest_replicas()); checker.start()``

    ``record_ack(key, value)`` is called by the workload after every
    acknowledged write (last ack per key wins — the protocol's last-write
    semantics).  ``check_now()`` runs the store-level invariants once;
    ``start()`` runs it on an interval until ``stop()``.  ``report()``
    returns the verdict dict embedded in benchmark records.
    """

    def __init__(self, replicas: Sequence, byzantine_ids: Sequence[str] = ()):
        self.replicas = [r for r in replicas if r.server_id not in set(byzantine_ids)]
        self.byzantine_ids = sorted(set(byzantine_ids))
        self.violations: List[str] = []
        self.samples = 0
        # (key, certified_ts, configstamp) -> txn hash, accumulated over
        # every sample of every honest replica: invariant 1's memory.
        self._committed: Dict[Tuple[str, int, int], bytes] = {}
        # (server_id, key) -> (current_epoch, certified_ts): invariant 2.
        self._progress: Dict[Tuple[str, str], Tuple[int, int]] = {}
        # (key, ts) slots already convicted under invariant 4 — one
        # conviction per slot, not one per sample.
        self._reclaim_convicted: set = set()
        # (server_id, seq, reason) replay convictions already accounted
        # under invariant 5 — sampled once, not once per tick.
        self._storage_convicted: set = set()
        # per-replica replay-conviction evidence for the report (the
        # tamper-attribution record)
        self.storage_convictions: Dict[str, List[Dict]] = {}
        # key -> latest acked value (None = acked delete): invariant 3.
        self.acked: Dict[str, Optional[bytes]] = {}
        self.acked_writes = 0
        self._flight_dumps = 0
        # key -> values of writes whose client call failed AFTER dispatch
        # (timeout, tally shortfall on a lossy link): outcome indeterminate
        # — the write may have committed even though the workload saw an
        # error.  final_check accepts these at read-back; a later ack for
        # the key clears them (an older-timestamp write can no longer
        # legally win).
        self._in_doubt: Dict[str, set] = {}
        self.in_doubt_accepted = 0
        self._task: Optional[asyncio.Task] = None

    # ------------------------------------------------------------- workload

    def record_ack(self, key: str, value: Optional[bytes]) -> None:
        self.acked[key] = value
        self.acked_writes += 1
        self._in_doubt.pop(key, None)

    def record_attempt(self, key: str, value: Optional[bytes]) -> None:
        """A write the client dispatched but saw FAIL (exception after the
        protocol may have reached replicas): its value is in doubt — under
        frame loss the cluster can have committed it even though the
        caller got an error.  Reading it back later is NOT acked-write
        loss (the acked value was superseded by a later, newer-timestamp
        write); reading anything outside acked+in-doubt still is."""
        if value is not None:
            self._in_doubt.setdefault(key, set()).add(value)

    def note_restart(self, fresh) -> None:
        """Swap in the reborn replica object after a ``restart_replica``
        (scenario harnesses): keep sampling the fresh runtime, but
        forget the OLD incarnation's per-replica progress memory — a
        recovered replica legally re-derives epochs/timestamps from its
        certificates (non-durable restarts resync from peers; epochs held
        only in the grant book do not survive), so comparing the reborn
        store against the dead one's high-water marks would convict a
        legal recovery.  Invariant 1's cross-replica/cross-time slot
        memory is deliberately KEPT: a recovered replica serving a
        conflicting committed certificate still convicts."""
        sid = fresh.server_id
        self.replicas = [
            fresh if r.server_id == sid else r for r in self.replicas
        ]
        for key in [k for k in self._progress if k[0] == sid]:
            del self._progress[key]

    # ------------------------------------------------------------- sampling

    # Flight-recorder dumps per run: a conviction storm must write bounded
    # evidence, not a disk flood — the first few violations carry the
    # causal record; the rest are counted in ``violations``.
    _MAX_FLIGHT_DUMPS = 8

    def _violate(self, msg: str) -> None:
        if len(self.violations) < 256:  # bounded evidence, not a log flood
            self.violations.append(msg)
        LOG.error("SAFETY INVARIANT VIOLATED: %s", msg)
        # Conviction flight recorder: drive every honest
        # replica's span ring to disk with the violation attached, so the
        # verdict ships with the causal record of the traffic around it.
        # No-op unless a flight dir is configured (MOCHI_TRACE_DIR).
        if self._flight_dumps < self._MAX_FLIGHT_DUMPS:
            self._flight_dumps += 1
            for replica in self.replicas:
                tracer = getattr(replica, "tracer", None)
                if tracer is None or not tracer.flight_dir:
                    continue
                try:
                    tracer.dump_flight("invariant-violation", {"violation": msg})
                except OSError:
                    LOG.exception("invariant flight dump failed")

    def check_now(self) -> None:
        """One pass of invariants 1 + 2 over the honest replicas' stores.
        Synchronous by design: it runs between event-loop turns, where the
        single-threaded stores are consistent."""
        self.samples += 1
        for replica in self.replicas:
            sid = replica.server_id
            cfg = replica.store.config
            for key, sv in replica.store.data.items():
                if sv.current_certificate is None or sv.last_transaction is None:
                    continue
                rset = set(cfg.replica_set_for_key(key))
                cert_ts = sv.certificate_timestamp(rset)
                if cert_ts is None:
                    continue
                txh = transaction_hash(sv.last_transaction)
                stamp = cfg.configstamp
                prev = self._committed.get((key, cert_ts, stamp))
                if prev is None:
                    self._committed[(key, cert_ts, stamp)] = txh
                elif prev != txh:
                    self._violate(
                        f"conflicting commits for {key!r} at ts={cert_ts} "
                        f"cs={stamp}: {prev.hex()[:16]} vs {txh.hex()[:16]} "
                        f"(seen at {sid})"
                    )
                last = self._progress.get((sid, key))
                if last is not None and (
                    sv.current_epoch < last[0] or cert_ts < last[1]
                ):
                    self._violate(
                        f"epoch/timestamp regression at {sid} for {key!r}: "
                        f"epoch {last[0]}->{sv.current_epoch}, "
                        f"cert_ts {last[1]}->{cert_ts}"
                    )
                self._progress[(sid, key)] = (sv.current_epoch, cert_ts)
        # Invariant 4: reclaimed-slot integrity.  A reclaiming replica
        # never re-grants the slot, so ITS validly-signed OK grant for
        # (key, ts) inside any committed certificate must carry the
        # original grantee's hash — a different hash proves the slot was
        # double-granted.  Scoped to the reclaimer's own grant (see the
        # module docstring): certificates from OTHER replicas' grants may
        # legally share the timestamp.
        from ..protocol import Status

        for replica in self.replicas:
            reclaimed = getattr(replica.store, "reclaimed", None)
            if not reclaimed:
                continue
            rid = replica.server_id
            for (key, ts), granted_hash in list(reclaimed.items()):
                if (rid, key, ts) in self._reclaim_convicted:
                    continue
                for peer in self.replicas:
                    sv = peer.store._get(key)
                    if (
                        sv is None
                        or sv.current_certificate is None
                        or sv.last_transaction is None
                    ):
                        continue
                    mg = sv.current_certificate.grants.get(rid)
                    g = mg.grants.get(key) if mg is not None else None
                    if (
                        g is None
                        or g.status != Status.OK
                        or g.timestamp != ts
                    ):
                        continue
                    txh = transaction_hash(sv.last_transaction)
                    if txh != granted_hash:
                        self._reclaim_convicted.add((rid, key, ts))
                        self._violate(
                            f"reclaimed slot {key!r}@{ts} (reclaimed at "
                            f"{rid}, granted {granted_hash.hex()[:16]}) "
                            f"appears in a committed certificate for "
                            f"{txh.hex()[:16]} at {peer.server_id} — the "
                            f"slot was double-granted"
                        )
                        break

        # Invariant 5: durable-replay integrity.  Conviction reasons where
        # the replay verifier REFUSED adoption outright — the convicted
        # transaction must therefore never show up in the live store (a
        # duplicate/stale "did not advance" conviction is excluded: its
        # transaction IS legitimately served via the earlier honest apply).
        _REFUSED = ("signature", "reorder", "torn non-final", "rejected",
                    "undecodable", "unknown record")
        for replica in self.replicas:
            storage = getattr(replica, "storage", None)
            if storage is None:
                continue
            for conv in storage.convictions:
                sid = replica.server_id
                mark = (sid, conv.get("seq"), conv.get("reason"), conv.get("key"))
                if mark in self._storage_convicted:
                    continue
                self._storage_convicted.add(mark)
                bucket = self.storage_convictions.setdefault(sid, [])
                if len(bucket) < 64:
                    bucket.append(dict(conv))
                reason = str(conv.get("reason") or "")
                key, txh = conv.get("key"), conv.get("txh")
                if (
                    key is None
                    or not txh
                    or not any(tag in reason for tag in _REFUSED)
                ):
                    continue
                sv = replica.store._get(key)
                if sv is not None and sv.last_transaction is not None:
                    served = transaction_hash(sv.last_transaction).hex()
                    if served.startswith(str(txh)):
                        self._violate(
                            f"replay-convicted entry for {key!r} "
                            f"(seq={conv.get('seq')}, {reason}) is being "
                            f"SERVED at {sid}: the replay verifier was "
                            f"bypassed"
                        )

    async def _loop(self, interval_s: float) -> None:
        while True:
            await asyncio.sleep(interval_s)
            try:
                self.check_now()
            except asyncio.CancelledError:
                raise
            except Exception:
                LOG.exception("invariant sample failed")

    def start(self, interval_s: float = 0.05) -> None:
        if self._task is None or self._task.done():
            self._task = asyncio.ensure_future(self._loop(interval_s))

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass  # the cancellation we just requested
            except Exception:
                pass
            self._task = None

    # ---------------------------------------------------------------- final

    async def final_check(self, client) -> None:
        """Invariant 3 (acked durability), end to end: every acked key must
        read back its latest acked value through a real quorum read —
        client-side recovery (nudge + poll) is allowed; it is part of the
        system under test."""
        from ..client.txn import TransactionBuilder

        self.check_now()
        for key, value in sorted(self.acked.items()):
            # Bounded retry before convicting unreadability: a single
            # quorum read can time out for reasons durability does not
            # answer for (host overload stalling 2 of 4 responders past
            # the client budget).  Retrying IS the system's contract (the SDK's
            # recovery machinery); a key that stays unreadable through
            # the retries still convicts.
            res = None
            last_exc: Optional[BaseException] = None
            for attempt in range(3):
                try:
                    res = await client.execute_read_transaction(
                        TransactionBuilder().read(key).build()
                    )
                    break
                except asyncio.CancelledError:
                    raise
                except Exception as exc:
                    last_exc = exc
                    if attempt < 2:  # no dead sleep after the final try
                        await asyncio.sleep(0.2 * (attempt + 1))
            if res is None:
                self._violate(
                    f"acked write {key!r} unreadable from honest quorum: "
                    f"{type(last_exc).__name__}: {last_exc}"
                )
                continue
            op = res.operations[0]
            got = bytes(op.value) if op.value is not None else None
            if value is None:
                if op.existed:
                    self._violate(f"acked delete of {key!r} resurfaced {got!r}")
            elif got != value:
                if got in self._in_doubt.get(key, ()):
                    # an indeterminate (failed-at-client, committed-at-
                    # cluster) later write won — durability held
                    self.in_doubt_accepted += 1
                else:
                    self._violate(
                        f"acked write {key!r} lost: read {got!r}, acked {value!r}"
                    )

    # --------------------------------------------------------------- report

    @property
    def ok(self) -> bool:
        return not self.violations

    def report(self) -> Dict:
        # Liveness observables alongside the safety verdict:
        # the worst closed per-key wedge window and the reclaim totals
        # across the honest stores — the benchmark record's evidence that
        # grant reclamation actually bounded contention.
        max_wedge_ms = 0.0
        reclaims = 0
        for r in self.replicas:
            max_wedge_ms = max(
                max_wedge_ms, getattr(r.store, "max_wedge_ms", 0.0)
            )
            reclaims += getattr(r.store, "reclaims", 0)
        # Scenario identity: when a harness stamped a run
        # (testing/scenario.py sets seed + generator version + spec hash),
        # the verdict carries it — a report found in a benchmark record or
        # CI log then names the seed that regenerates its exact scenario.
        from ..obs.trace import run_stamp

        stamp = run_stamp()
        return {
            **({"run": stamp} if stamp else {}),
            "ok": self.ok,
            "samples": self.samples,
            "keys_tracked": len(self.acked),
            "acked_writes": self.acked_writes,
            "in_doubt_reads_accepted": self.in_doubt_accepted,
            "honest_replicas": [r.server_id for r in self.replicas],
            "byzantine_replicas": self.byzantine_ids,
            "max_wedge_ms": round(max_wedge_ms, 2),
            "grant_reclaims": reclaims,
            # invariant 5 evidence: per-replica replay convictions (the
            # tampered-WAL attribution)
            "storage_replay_convictions": sum(
                len(v) for v in self.storage_convictions.values()
            ),
            "storage_convictions": {
                sid: list(entries)
                for sid, entries in sorted(self.storage_convictions.items())
            },
            "violations": list(self.violations),
        }
