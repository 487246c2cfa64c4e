"""Replica datastore: the quorum-BFT protocol state machine.

Re-implements the semantics of the reference's
``server/datastrore/InMemoryDataStore.java`` + ``StoreValueObjectContainer.java``
(SVOC) in a single-threaded, asyncio-friendly form: the reference guards every
object with a ``ReentrantReadWriteLock`` and sorted lock acquisition
(``InMemoryDataStore.java:333-335``); here every datastore call runs to
completion on the replica's event loop, so the whole transaction is naturally
atomic with no locks and no deadlock ordering.

Protocol semantics preserved (with reference cites):

* Write1 grant issuance at ``prospective_ts = current_epoch + seed``; existing
  grant at that ts → idempotent return on matching transaction hash, refusal
  otherwise (``InMemoryDataStore.java:105-155``).
* Write2: coalesce per-object grants across servers, requiring equal
  timestamps (``:613-640``); quorum ``>= 2f+1`` (fixing the strict ``>``
  off-by-one at ``:590``); per-object transaction-hash check (``:580,591``,
  returning a typed BAD_CERTIFICATE failure instead of the reference's
  ``UnsupportedOperationException`` TODO at ``:601-607``); stale-timestamp
  objects are read back instead of written (``:594-598``).
* Apply: store certificate, consume the grant, advance the epoch, set/clear
  value (``:521-554``; ``StoreValueObjectContainer.java:83-88,146-156``).
* Grant GC: the reference defines ``truncateGivenWrite1Grants`` but never
  calls it (``StoreValueObjectContainer.java:158-169``); here it runs on every
  epoch advance.
* ``_CONFIG_``-prefixed keys live in a separate, always-locally-owned keyspace
  (``InMemoryDataStore.java:44,56-73``).
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass, field as dc_field
from typing import Dict, Iterable, List, Optional, Tuple, Union

from ..cluster.config import (
    CONFIG_ARCHIVE_PREFIX,
    CONFIG_CLIENT_PREFIX,
    CONFIG_CLUSTER_KEY,
    CONFIG_KEY_PREFIX,
    ClusterConfig,
    config_archive_key,
)
from ..protocol import (
    Action,
    FailType,
    Grant,
    MultiGrant,
    Operation,
    OperationResult,
    RequestFailedFromServer,
    Status,
    SyncEntry,
    Transaction,
    TransactionResult,
    Write1OkFromServer,
    Write1RefusedFromServer,
    Write1ToServer,
    Write2AnsFromServer,
    Write2ToServer,
    WriteCertificate,
    transaction_hash,
)

LOG = logging.getLogger(__name__)

# Epoch granularity: seeds are drawn from [0, EPOCH_UNIT) and prospective
# timestamps are epoch+seed (ref: StoreValueObjectContainer.java:83-88,
# MochiDBClient.java:262).
EPOCH_UNIT = 1000
# Grant-book GC horizon: epochs this far behind current are dropped
# (ref: StoreValueObjectContainer.java:158-169).
GRANT_GC_EPOCHS = 2 * EPOCH_UNIT

# ---------------------------------------------------------------------------
# Byzantine-client defenses (docs/OPERATIONS.md §4h).  The reference — and
# HQ replication, whose contention/cleanup weakness the paper inherits —
# has NO grant expiry: a client that collects grants and never sends Write2
# parks the slot forever, and one that sweeps every subEpoch seed of a
# key's current epoch wedges all conflicting writers indefinitely (the
# epoch only advances on apply, and nothing ever applies).  Two knobs:
#
# * MOCHI_GRANT_TTL_MS — uncommitted-grant reclamation age (0 = off).  A
#   conflicting Write1 that collides with a grant older than the effective
#   TTL SUPERSEDES it: the stale grant is dropped, the key's epoch is
#   bumped past the contested slot, and the new transaction is granted at
#   a strictly HIGHER timestamp (see process_write1 for the safety
#   argument).  The effective TTL is floored at 8x MOCHI_RTT_FLOOR_MS so
#   WAN postures never reclaim a merely-slow live client mid-Write2 (the
#   whole honest write path spans ~2 RTT plus retries).
# * MOCHI_CLIENT_GRANT_QUOTA — outstanding OK grants one client identity
#   may hold across this replica's whole keyspace (0 = off).  Past it,
#   Write1 gets a typed QUOTA_EXCEEDED refusal with a retry-after hint
#   (the admission plumbing), so grant-hoarding sweeps are capped at
#   quota slots instead of the full seed space.  Config-keyspace-only
#   transactions are exempt: an operator reconfiguring an attacked
#   cluster must get through (same posture as shed exemption for admin
#   ops).
GRANT_TTL_MS = float(os.environ.get("MOCHI_GRANT_TTL_MS", "5000"))
CLIENT_GRANT_QUOTA = int(os.environ.get("MOCHI_CLIENT_GRANT_QUOTA", "128"))
# Bounded evidence/bookkeeping: per-client stat entries and reclaimed-slot
# ledger age out FIFO (entries with outstanding grants are never evicted —
# the quota must not be evadable by stat-table churn).
CLIENT_STATS_MAX = 1024
RECLAIM_LEDGER_MAX = 4096
WEDGE_TABLE_MAX = 4096


def effective_grant_ttl_ms() -> float:
    """The reclaim age actually enforced: ``GRANT_TTL_MS`` floored at
    8x the transport's RTT floor.  On a conditioned WAN (config 7/10/11
    set ``MOCHI_RTT_FLOOR_MS`` to the mesh RTT) a live-but-slow honest
    client's Write1->Write2 window is ~2 RTT plus the retry ladder;
    reclaiming inside that window would turn ordinary slowness into
    contention churn, so the floor keeps the TTL comfortably outside it.
    0 = reclamation off (the earlier behavior)."""
    if GRANT_TTL_MS <= 0:
        return 0.0
    try:
        from ..net import transport

        floor_ms = transport.RTT_FLOOR_S * 1e3
    except Exception:  # pragma: no cover - transport always importable
        floor_ms = 0.0
    return max(GRANT_TTL_MS, 8.0 * floor_ms)


@dataclass
class StoreValue:
    """Per-object container (ref: ``StoreValueObjectContainer.java:24-53``)."""

    key: str
    value: Optional[bytes] = None
    exists: bool = False
    current_certificate: Optional[WriteCertificate] = None
    # epoch -> timestamp -> Grant (ref: givenWrite1Grants, SVOC.java:38-40)
    grants: Dict[int, Dict[int, Grant]] = dc_field(default_factory=dict)
    current_epoch: int = 0
    # The transaction the current certificate committed — kept so this
    # replica can serve trustless state transfer (SyncEntry carries
    # (transaction, certificate); receivers re-validate via the Write2
    # checks).  The reference stores only the certificate (SVOC.java:24-53)
    # and therefore cannot implement the paper's UptoSpeed resync.
    last_transaction: Optional["Transaction"] = None

    @staticmethod
    def epoch_of(ts: int) -> int:
        return (ts // EPOCH_UNIT) * EPOCH_UNIT

    def grant_at(self, ts: int) -> Optional[Grant]:
        return self.grants.get(self.epoch_of(ts), {}).get(ts)

    def add_grant(self, grant: Grant) -> None:
        self.grants.setdefault(self.epoch_of(grant.timestamp), {})[grant.timestamp] = grant

    def delete_grant(self, ts: int) -> None:
        epoch = self.epoch_of(ts)
        bucket = self.grants.get(epoch)
        if bucket is not None:
            bucket.pop(ts, None)
            if not bucket:
                del self.grants[epoch]

    def advance_epoch(self, applied_ts: int) -> List[int]:
        """Move past the applied timestamp's epoch and GC stale grant epochs
        (ref: ``moveToNextEpochIfNecessary``, SVOC.java:83-88 — plus the GC the
        reference never wired up, SVOC.java:158-169).  Returns the GC'd
        grant timestamps so the store can release their per-client
        quota/ownership bookkeeping."""
        nxt = self.epoch_of(applied_ts) + EPOCH_UNIT
        if nxt > self.current_epoch:
            self.current_epoch = nxt
        horizon = self.current_epoch - GRANT_GC_EPOCHS
        dropped: List[int] = []
        for epoch in [e for e in self.grants if e < horizon]:
            dropped.extend(self.grants[epoch])
            del self.grants[epoch]
        return dropped

    def certificate_timestamp(self, replica_set: Optional[set] = None) -> Optional[int]:
        """Timestamp certified for this key by the current certificate
        (ref: ``getCurrentTimestampFromCurrentCertificate``, SVOC.java:175-198).

        Counts only OK-status grants and takes the majority timestamp: the
        quorum check at apply time guarantees >= 2f+1 OK grants agreed on the
        winning timestamp, but a stored certificate may ALSO carry validly
        signed non-OK (refused/wrong-shard) or minority grants from Byzantine
        in-set peers — those must not be able to poison this accessor (a
        raise here would brick the key for every later Write2/resync).

        When ``replica_set`` is given (the normal server path), only grants
        from servers inside the key's replica set contribute, one vote per
        server — the same in-set restriction ``_coalesce_grants`` enforces.
        Without it, out-of-set signers colluding with a Byzantine client
        could out-vote the legitimate 2f+1 in-set quorum and flip the stored
        timestamp (poisoning the staleness check in ``process_write2``).
        """
        if self.current_certificate is None:
            return None
        counts: Dict[int, int] = {}
        voted: set = set()
        for mg in self.current_certificate.grants.values():
            grant = mg.grants.get(self.key)
            if grant is None or grant.status != Status.OK:
                continue
            if replica_set is not None and (
                mg.server_id not in replica_set or mg.server_id in voted
            ):
                continue
            voted.add(mg.server_id)
            counts[grant.timestamp] = counts.get(grant.timestamp, 0) + 1
        if not counts:
            return None
        return max(counts.items(), key=lambda kv: kv[1])[0]


Write1Response = Union[Write1OkFromServer, Write1RefusedFromServer]
Write2Response = Union[Write2AnsFromServer, RequestFailedFromServer]


class DataStore:
    """The protocol state machine for one replica.

    Synchronous and lock-free by design; the surrounding replica runtime
    serializes calls on its event loop.  Signature verification happens
    *before* these entry points (the ``SignatureVerifier`` seam — SURVEY.md
    §2.4); the store trusts its inputs' signatures but still enforces quorum
    shape, hash agreement and timestamp agreement.
    """

    def __init__(self, server_id: str, config: ClusterConfig):
        self.server_id = server_id
        self.config = config
        self.data: Dict[str, StoreValue] = {}
        self.data_config: Dict[str, StoreValue] = {}  # _CONFIG_ keyspace
        # Fired (post-apply, same event-loop turn) when a write commits to
        # CONFIG_CLUSTER_KEY — the replica installs the new membership
        # (paper's configuration change, mochiDB.tex:184-199).
        self.on_config_value = None  # Optional[Callable[[bytes], None]]
        # Fired when a client registry entry (_CONFIG_CLIENT_<id>) changes:
        # the replica must drop any live session for that client, else a
        # revoked/rotated key keeps transacting through its old MAC session.
        self.on_client_key_change = None  # Optional[Callable[[str], None]]
        # configstamp -> config, for validating certificates formed under
        # PREVIOUS configurations (resync replays them; their quorum shape
        # is the one they were granted under).  Live replicas accumulate
        # entries as they witness installs; fresh members fall back to the
        # archived config documents (CONFIG_ARCHIVE_PREFIX keys, written by
        # the reconfiguration transaction itself).
        self.config_history: Dict[int, ClusterConfig] = {config.configstamp: config}
        # Per-shard traffic accounting (token-ring ownership, the paper's L2
        # layer): how many operations this replica served as an OWNER vs
        # answered WRONG_SHARD because the client's routing (or a stale
        # config) sent them here.  In a healthy shard-routed deployment the
        # *_foreign counters stay at ~0 — a growing foreign count is the
        # operator signal that clients hold a stale configstamp or a
        # benchmark fans out wider than the replica sets it should target.
        # Surfaced on the admin shell (/status "shard", mochi_shard gauges).
        self.shard_counters: Dict[str, int] = {
            "read_owned": 0,
            "read_foreign": 0,
            "write1_owned": 0,
            "write1_foreign": 0,
            "write2_applied": 0,
            "write2_foreign": 0,
        }
        # ---- Byzantine-client accounting (docs/OPERATIONS.md §4h)
        # (key, ts) -> (client_id, issued_monotonic) for every OUTSTANDING
        # OK grant: the issue tick the reclaim rule ages against, and the
        # ownership record the per-client quota counts.  Size is bounded by
        # the grant books themselves (GC horizon per key) plus the quota.
        self._grant_meta: Dict[Tuple[str, int], Tuple[str, float]] = {}
        # client_id -> {(key, ts), ...} inverse index over _grant_meta: the
        # expiry sweep and the quota's already-held credit must be O(that
        # client's grants), never a scan of the global table (an attacker
        # sitting at quota would otherwise buy a full-table scan per
        # refused Write1).
        self._client_slots: Dict[str, set] = {}
        # client_id -> {"outstanding", "issued", "reclaimed_from",
        # "quota_refused"} — the replica-side per-client suspicion ledger
        # (mirrors the client SDK's per-peer suspicion counters): a client
        # whose grants keep getting reclaimed is a withholder; one bouncing
        # off the quota is a hoarder.  FIFO-bounded; entries still holding
        # outstanding grants are never evicted (quota must not be evadable
        # by churning the stat table).
        self.client_stats_map: Dict[str, Dict[str, int]] = {}
        # (key, ts) -> transaction hash the reclaimed grant was issued to:
        # the slot ledger the InvariantChecker audits — a COMMITTED
        # certificate at a reclaimed slot must carry exactly this hash
        # (the original grantee's; see the safety argument in
        # process_write1).  FIFO-bounded evidence.
        self.reclaimed: Dict[Tuple[str, int], bytes] = {}
        self.reclaims = 0
        self.quota_refusals = 0
        # Liveness metric: per-key wedge clock, key -> (opened_monotonic,
        # refused client).  A conflict refusal opens the key's wedge
        # window; it closes when THAT writer obtains a grant (per-writer:
        # the attacker re-acquiring slots must not truncate an honest
        # writer's window) or when any commit applies.  The max closed
        # window is the published "max wedge time" — with reclamation on
        # it is bounded near the TTL; without it a withholding client
        # keeps windows open indefinitely (visible as open_wedges +
        # max_open_wedge_ms on the admin surfaces).
        self._wedge_start: Dict[str, Tuple[float, str]] = {}
        self.max_wedge_ms = 0.0
        # Storage SPI (mochi_tpu_torch/storage): every durable event —
        # applied transactions (self-certifying (keys, txn, certificate)
        # triples) and reclaim epoch bumps — is STAGED synchronously here;
        # the replica awaits the engine's flush at the batched-write2 seam
        # before acknowledging.  None/MemoryStorage = the reference's
        # in-memory posture (the default for the test matrix).
        self.storage = None  # Optional[mochi_tpu_torch.storage.StorageEngine]

    def shard_stats(self) -> Dict[str, int]:
        """Token-ring ownership summary + per-phase owned/foreign counters.

        ``tokens_primary`` counts ring tokens this replica is the first
        owner of; ``tokens_in_replica_set`` counts tokens whose RF-member
        walk includes it (= the share of the key space it serves).  Both
        are derived from the live config, so a reconfiguration changes
        them on the next scrape.
        """
        primary = sum(1 for sid in self.config.token_owners if sid == self.server_id)
        in_set = sum(
            1
            for t in range(len(self.config.token_owners))
            if self.server_id in self.config.replica_set_for_token(t)
        )
        return {
            "tokens_primary": primary,
            "tokens_in_replica_set": in_set,
            **self.shard_counters,
        }

    # ------------------------------------------ per-client grant accounting

    def _client_entry(self, client_id: str) -> Dict[str, int]:
        entry = self.client_stats_map.get(client_id)
        if entry is None:
            if len(self.client_stats_map) >= CLIENT_STATS_MAX:
                # FIFO-evict the first entry holding no outstanding
                # grants; failing that, expire the OLDEST entry's aged
                # grants and evict it if that freed it.  A table full of
                # genuinely-live holders still admits over cap rather
                # than forget a quota obligation (same posture as the
                # session table's pins), so under an identity flood the
                # bound is cap + (flood rate x TTL) — each over-cap
                # entry's single grant ages out within one TTL and the
                # entry becomes evictable (registry-gated clusters bound
                # identities outright; open-mode Sybil hardening is the
                # ROADMAP's remaining frontier).
                victim = None
                for cid, st in self.client_stats_map.items():
                    if st["outstanding"] <= 0:
                        victim = cid
                        break
                if victim is None:
                    oldest = next(iter(self.client_stats_map))
                    self._sweep_expired_grants(oldest, time.monotonic())
                    if self.client_stats_map[oldest]["outstanding"] <= 0:
                        victim = oldest
                if victim is not None:
                    del self.client_stats_map[victim]
            entry = {
                "outstanding": 0,
                "issued": 0,
                "reclaimed_from": 0,
                "quota_refused": 0,
            }
            self.client_stats_map[client_id] = entry
        return entry

    def _track_grant(self, key: str, ts: int, client_id: str, now: float) -> None:
        self._grant_meta[(key, ts)] = (client_id, now)
        self._client_slots.setdefault(client_id, set()).add((key, ts))
        entry = self._client_entry(client_id)
        entry["outstanding"] += 1
        entry["issued"] += 1

    def _untrack_grant(self, key: str, ts: int) -> Optional[Tuple[str, float]]:
        meta = self._grant_meta.pop((key, ts), None)
        if meta is not None:
            slots = self._client_slots.get(meta[0])
            if slots is not None:
                slots.discard((key, ts))
                if not slots:
                    del self._client_slots[meta[0]]
            entry = self.client_stats_map.get(meta[0])
            if entry is not None and entry["outstanding"] > 0:
                entry["outstanding"] -= 1
        return meta

    def _reclaim_slot(self, sv: StoreValue, key: str, ts: int) -> None:
        """Withdraw one aged uncommitted grant — shared by the
        conflict-path reclaim and the quota-pressure expiry sweep: ledger
        the slot (InvariantChecker audit trail), drop the grant, release
        its quota, and bump the key's epoch past the slot so it can never
        be re-granted (the safety argument on :meth:`process_write1`)."""
        existing = sv.grant_at(ts)
        if existing is not None:
            if len(self.reclaimed) >= RECLAIM_LEDGER_MAX:
                self.reclaimed.pop(next(iter(self.reclaimed)))
            self.reclaimed[(key, ts)] = existing.transaction_hash
        self.reclaims += 1
        meta = self._untrack_grant(key, ts)
        if meta is not None:
            owner = self.client_stats_map.get(meta[0])
            if owner is not None:
                owner["reclaimed_from"] += 1
        sv.delete_grant(ts)
        for dts in sv.advance_epoch(ts):
            self._untrack_grant(key, dts)
        if self.storage is not None:
            # The one epoch event a commit cannot reconstruct: recovering
            # without it could re-grant the reclaimed slot (the safety
            # argument's "never re-granted" promise must survive restarts).
            self.storage.stage_reclaim(
                key,
                ts,
                existing.transaction_hash if existing is not None else b"",
                sv.current_epoch,
            )

    def _sweep_expired_grants(self, client_id: str, now: float) -> int:
        """Expiry sweep for ONE client's aged grants, run when its quota
        would otherwise refuse (amortized: quota pressure pays for the
        scan, and the per-client slot index keeps it O(that client's
        grants) — never a global-table scan an at-quota attacker could
        buy per refused request).  Without it, an honest client's
        abandoned grants — partial OK rounds from retried contention,
        grants on keys no writer ever touches again — would pin its
        quota forever: reclamation is otherwise conflict-triggered, and
        nothing conflicts with an abandoned slot.  Each swept slot goes
        through the full reclaim (ledger + epoch bump), so the safety
        argument is unchanged."""
        ttl_ms = effective_grant_ttl_ms()
        if ttl_ms <= 0:
            return 0
        swept = 0
        for key, ts in list(self._client_slots.get(client_id, ())):
            meta = self._grant_meta.get((key, ts))
            if meta is None or (now - meta[1]) * 1e3 < ttl_ms:
                continue
            sv = self._get(key)
            if sv is None:  # key vanished (snapshot load edge): just untrack
                self._untrack_grant(key, ts)
                continue
            self._reclaim_slot(sv, key, ts)
            swept += 1
        return swept

    def _wedge_open(self, key: str, client_id: str, now: float) -> None:
        if key not in self._wedge_start and len(self._wedge_start) < WEDGE_TABLE_MAX:
            self._wedge_start[key] = (now, client_id)

    def _wedge_close(self, key: str, now: float, client_id: Optional[str] = None) -> None:
        """Close the key's wedge window.  Per-WRITER when ``client_id`` is
        given (grant issuance): only the refused writer obtaining a grant
        ends its own wait — the wedging attacker re-acquiring slots on
        the key must not truncate the honest writer's window into short
        segments that flatter the published max.  A commit
        (``client_id=None``) closes unconditionally: the key made
        progress for everyone."""
        entry = self._wedge_start.get(key)
        if entry is None:
            return
        if client_id is not None and entry[1] != client_id:
            return
        del self._wedge_start[key]
        wedge_ms = (now - entry[0]) * 1e3
        if wedge_ms > self.max_wedge_ms:
            self.max_wedge_ms = wedge_ms

    def client_stats(self) -> Dict[str, object]:
        """Per-client grant/quota/reclaim accounting for the admin surfaces
        (/status "clients", ``mochi_client`` prom family, "/" Clients
        table — docs/OPERATIONS.md §4h)."""
        now = time.monotonic()
        open_ms = (
            (now - min(v[0] for v in self._wedge_start.values())) * 1e3
            if self._wedge_start
            else 0.0
        )
        return {
            "quota": CLIENT_GRANT_QUOTA,
            "ttl_ms": round(effective_grant_ttl_ms(), 1),
            "reclaims": self.reclaims,
            "quota_refused": self.quota_refusals,
            "outstanding_total": len(self._grant_meta),
            "tracked_clients": len(self.client_stats_map),
            "reclaimed_slots": len(self.reclaimed),
            "max_wedge_ms": round(self.max_wedge_ms, 2),
            "open_wedges": len(self._wedge_start),
            "max_open_wedge_ms": round(open_ms, 2),
            "per_client": {
                cid: dict(st) for cid, st in self.client_stats_map.items()
            },
        }

    # ------------------------------------------------------------------ util

    def _map_for(self, key: str) -> Dict[str, StoreValue]:
        return self.data_config if key.startswith(CONFIG_KEY_PREFIX) else self.data

    def _get(self, key: str) -> Optional[StoreValue]:
        m = self._map_for(key)
        sv = m.get(key)
        eng = self.storage
        if eng is not None and eng.pager and m is self.data:
            if sv is None:
                sv = eng.fault_in(self, key)
            else:
                eng.note_access(key)
        return sv

    def _get_or_create(self, key: str) -> StoreValue:
        sv = self._get(key)
        if sv is None:
            sv = StoreValue(key)
            self._map_for(key)[key] = sv
        return sv

    def owns(self, key: str) -> bool:
        return self.config.owns_key(self.server_id, key)

    def _cert_ts(self, sv: StoreValue) -> Optional[int]:
        """``certificate_timestamp`` restricted to the key's replica set."""
        return sv.certificate_timestamp(set(self.config.replica_set_for_key(sv.key)))

    def note_config(self, cfg: ClusterConfig) -> None:
        """Record a configuration in the history (replica install hook)."""
        self.config_history[cfg.configstamp] = cfg

    def config_for_stamp(self, cs: int) -> Optional[ClusterConfig]:
        """The configuration in force at configstamp ``cs`` (or None).

        Order: current, witnessed history, then the committed archive
        document — which is how a freshly-booted member (it never witnessed
        the older installs) validates historical certificates during resync.
        """
        if cs == self.config.configstamp:
            return self.config
        cached = self.config_history.get(cs)
        if cached is not None:
            return cached
        sv = self.data_config.get(config_archive_key(cs))
        if sv is None:
            # pre-zero-padding archive key form (snapshots / mixed versions)
            sv = self.data_config.get(f"{CONFIG_ARCHIVE_PREFIX}{cs}")
        if sv is not None and sv.exists and sv.value:
            try:
                cfg = ClusterConfig.from_json(bytes(sv.value).decode())
            except Exception:
                LOG.exception("archived config cs=%d unparseable", cs)
                return None
            if cfg.configstamp == cs:
                self.config_history[cs] = cfg
                return cfg
        return None

    def nearest_config_for_stamp(self, cs: int) -> ClusterConfig:
        """Best-effort config for a stamp with no exact record: the nearest
        known stamp (preferring the closest at-or-below, then the lowest
        above).  Judging an old certificate with a nearby config relies on
        the bounded-churn-per-epoch property consecutive BFT configurations
        must have anyway (>= 2f+1 member overlap); the further the distance,
        the more likely valid historical certificates fail — a documented
        limit for members that join after many membership-churning
        reconfigurations (boot them from a snapshot instead)."""
        exact = self.config_for_stamp(cs)
        if exact is not None:
            return exact
        known = sorted(self.config_history)
        below = [s for s in known if s <= cs]
        if below:
            return self.config_history[below[-1]]
        return self.config_history[known[0]] if known else self.config

    def stats(self) -> Dict[str, int]:
        """Operator-facing counters (served by the admin HTTP shell)."""
        live = sum(1 for sv in self.data.values() if sv.exists)
        grants = sum(len(e) for sv in self.data.values() for e in sv.grants.values())
        return {
            "keys": len(self.data),
            "keys_live": live,
            "config_keys": len(self.data_config),
            "outstanding_grants": grants,
        }

    # ------------------------------------------------------------------ read

    def process_read(self, transaction: Transaction) -> TransactionResult:
        """1-round-trip read (ref: ``processReadRequest``,
        ``InMemoryDataStore.java:200-231,75-103``)."""
        results: List[OperationResult] = []
        for op in transaction.operations:
            if not self.owns(op.key):
                self.shard_counters["read_foreign"] += 1
                results.append(OperationResult(status=Status.WRONG_SHARD))
                continue
            self.shard_counters["read_owned"] += 1
            sv = self._get(op.key)
            if sv is None:
                results.append(OperationResult(None, None, False, Status.OK))
            else:
                results.append(
                    OperationResult(sv.value, sv.current_certificate, sv.exists, Status.OK)
                )
        return TransactionResult(tuple(results))

    # ---------------------------------------------------------------- write1

    def process_write1(self, req: Write1ToServer) -> Write1Response:
        """Issue (or refuse) grants for every key in the transaction
        (ref: ``tryProcessWriteRegularly``, ``InMemoryDataStore.java:233-310``).

        Round-13 defenses on this path (docs/OPERATIONS.md §4h):

        * **Per-client quota** — a client already holding
          ``CLIENT_GRANT_QUOTA`` outstanding OK grants gets a typed
          ``QuotaExceeded`` (the replica maps it to
          ``FailType.QUOTA_EXCEEDED`` + retry-after) before any grant is
          issued, capping grant-hoarding sweeps at quota slots.

        * **Reclamation** — a conflicting Write1 colliding with an
          UNCOMMITTED grant older than ``effective_grant_ttl_ms()``
          supersedes it: the stale grant is dropped and the key's epoch is
          bumped past the contested slot, so the new transaction is
          granted at a strictly HIGHER timestamp.

        Safety argument for reclamation (why it cannot orphan a
        certificate that ever reached 2f+1 validly):

        1. A write certificate is SELF-CERTIFYING: ``process_write2``
           validates 2f+1 signed in-set grants, hash agreement and
           staleness — it never consults this replica's grant book.
           Reclaiming a grant therefore cannot invalidate any certificate
           already assembled from it; a slow-but-live client whose grants
           were reclaimed mid-flight still commits when its Write2 lands
           (pinned in tests/test_chaos.py).
        2. The reclaimed slot is NEVER re-granted: the superseding grant
           is issued at ``epoch_of(slot) + EPOCH_UNIT + seed``, strictly
           above the reclaimed timestamp, and prospective timestamps only
           ever grow with the epoch — so no two conflicting transactions
           can each hold an honest grant for ONE (key, ts) slot, and the
           certificate-agreement invariant is untouched.
        3. The only interleaving left is two certificates at DIFFERENT
           timestamps racing to commit, which is the protocol's ordinary
           concurrent-writer case: the staleness check orders them by
           timestamp on every honest replica identically.
        4. Auditability: each reclaim records (key, ts) -> granted hash in
           ``self.reclaimed``; the InvariantChecker convicts any committed
           certificate occupying a reclaimed slot with a DIFFERENT hash
           (which per 2 would require a forged or Byzantine grant).
        """
        if not 0 <= req.seed < EPOCH_UNIT:
            # A Byzantine client must not steer prospective timestamps into
            # arbitrary epochs (epoch-jump / grant-GC attacks).
            raise BadRequest(f"seed {req.seed} outside [0, {EPOCH_UNIT})")
        now = time.monotonic()
        quota = CLIENT_GRANT_QUOTA
        ttl_ms = effective_grant_ttl_ms()  # module globals; fixed per request
        # Quota accounting counts the REQUEST's grant demand too, not just
        # prior state: one Write1 issues a grant per distinct owned data
        # key, so checking outstanding alone would let a single wide
        # transaction hoard arbitrarily many slots in one message.  The
        # quota is therefore also the ceiling on distinct keys per write
        # transaction — size MOCHI_CLIENT_GRANT_QUOTA above the widest
        # transaction a workload legitimately issues (config keys exempt).
        owned_keys = {
            op.key
            for op in req.transaction.operations
            if op.key
            and not op.key.startswith(CONFIG_KEY_PREFIX)
            and self.owns(op.key)
        }
        if quota > 0 and owned_keys:
            held = self.client_stats_map.get(req.client_id)
            outstanding = held["outstanding"] if held else 0
            # Demand = keys that would issue a NEW grant: a key already
            # granted to THIS transaction at THIS request's prospective
            # timestamp costs nothing (the idempotent retry of a lost
            # Write1Ok — possibly partial — must never be quota-refused,
            # or the client can't recover its own in-flight write).  The
            # credit is deliberately per-SLOT, not per-key: "already holds
            # some grant on the key" would let one identity sweep the
            # key's whole seed space for the price of one slot — the
            # exact wedge the quota exists to cap.
            demand = 0
            for k in owned_keys:
                sv = self._get(k)
                g = (
                    sv.grant_at(sv.current_epoch + req.seed)
                    if sv is not None
                    else None
                )
                if g is None or g.transaction_hash != req.transaction_hash:
                    demand += 1
            if outstanding + demand > quota:
                # Amortized decay: before refusing, sweep THIS client's
                # TTL-aged grants (abandoned contention rounds would
                # otherwise pin the quota forever — nothing conflicts
                # with an abandoned slot, so the lazy reclaim never runs).
                if held is not None and self._sweep_expired_grants(
                    req.client_id, now
                ):
                    outstanding = held["outstanding"]
                if outstanding + demand > quota:
                    entry = self._client_entry(req.client_id)
                    entry["quota_refused"] += 1
                    self.quota_refusals += 1
                    # Retry-after: the oldest outstanding slots free
                    # within one TTL (the sweep above enforces it); with
                    # reclamation off, hint a modest backoff, not a lie.
                    raise QuotaExceeded(
                        f"client {req.client_id} holds {outstanding} "
                        f"outstanding grants and asks {demand} more "
                        f"(quota {quota})",
                        retry_after_ms=int(ttl_ms) if ttl_ms > 0 else 250,
                    )
        grants: Dict[str, Grant] = {}
        current_certs: Dict[str, WriteCertificate] = {}
        all_ok = True
        for op in req.transaction.operations:
            if not op.key:
                raise BadRequest("empty key in operation")
            if op.key in grants:  # one grant per object per txn
                continue
            if not self.owns(op.key):
                self.shard_counters["write1_foreign"] += 1
                grants[op.key] = Grant(
                    op.key, 0, self.config.configstamp, req.transaction_hash, Status.WRONG_SHARD
                )
                continue
            self.shard_counters["write1_owned"] += 1
            sv = self._get_or_create(op.key)
            prospective_ts = sv.current_epoch + req.seed
            existing = sv.grant_at(prospective_ts)
            if existing is not None and existing.transaction_hash != req.transaction_hash:
                # Conflicting outstanding grant: reclaim it if it has aged
                # past the TTL (see the safety argument above), else refuse.
                meta = self._grant_meta.get((op.key, prospective_ts))
                if (
                    ttl_ms > 0
                    and meta is not None
                    and (now - meta[1]) * 1e3 >= ttl_ms
                ):
                    # Supersede at a strictly higher timestamp: the shared
                    # reclaim ledgers the slot, releases its quota, and
                    # bumps the epoch past it (advance_epoch also GC's
                    # ancient hoarded epochs — their quota frees too).
                    self._reclaim_slot(sv, op.key, prospective_ts)
                    prospective_ts = sv.current_epoch + req.seed
                    existing = sv.grant_at(prospective_ts)
                    # (the bumped epoch is fresh: nothing can be granted
                    # there yet, so existing is None and the issue path
                    # below runs — kept as a lookup, not an assert, so a
                    # future epoch-handling change degrades to a refusal
                    # rather than a double grant)
            if existing is None:
                grant = Grant(
                    op.key, prospective_ts, self.config.configstamp, req.transaction_hash, Status.OK
                )
                sv.add_grant(grant)
                # Config-keyspace grants sit entirely OUTSIDE the
                # quota/reclaim/wedge machinery: that keyspace is
                # admin-gated (its own protection), and an operator's
                # stalled reconfiguration grant must neither consume the
                # identity's data-key quota nor have its epochs bumped by
                # the expiry sweep.
                if not op.key.startswith(CONFIG_KEY_PREFIX):
                    self._track_grant(op.key, prospective_ts, req.client_id, now)
                    self._wedge_close(op.key, now, req.client_id)
                grants[op.key] = grant
            elif existing.transaction_hash == req.transaction_hash:
                # Idempotent retry (ref: InMemoryDataStore.java:141-148)
                grants[op.key] = existing
            else:
                # Timestamp taken by a different transaction → refuse, return
                # the conflicting state (ref: InMemoryDataStore.java:149-154)
                grants[op.key] = Grant(
                    op.key, prospective_ts, self.config.configstamp, req.transaction_hash, Status.REFUSED
                )
                all_ok = False
                if not op.key.startswith(CONFIG_KEY_PREFIX):
                    self._wedge_open(op.key, req.client_id, now)
                # The conflicting CURRENT state rides only the refusal —
                # that is what the echo exists for (the reference's
                # conflicting-state return).  Echoing every granted key's
                # certificate made batched Write1 answers O(K^2): each of
                # K certs carries MultiGrants spanning its whole K-op
                # transaction (a profile: the dominant decode cost).
                if sv.current_certificate is not None:
                    current_certs[op.key] = sv.current_certificate
        multi_grant = MultiGrant(grants=grants, client_id=req.client_id, server_id=self.server_id)
        if all_ok:
            return Write1OkFromServer(multi_grant, current_certs)
        return Write1RefusedFromServer(multi_grant, current_certs, req.client_id)

    def process_write1_batch(
        self, reqs: "Iterable[Write1ToServer]"
    ) -> "List[Union[Write1Response, BadRequest]]":
        """Grant issuance for one drained batch in a single store entry.

        The store has no mutex — the replica's event loop is the lock — so
        the batched analog of "take the lock once per batch" is this: the
        whole batch issues grants in ONE uninterrupted loop turn (no task
        switch, no await, no interleaved Write2 between two Write1s of the
        same drain), paying one call-frame + metrics entry for N requests.
        Per-request failures return as exception VALUES (``BadRequest`` for
        validation, anything else for a processing bug) so one bad request
        cannot poison its batchmates — the caller maps ``BadRequest`` to a
        typed refusal and drops (logs) the rest, exactly the per-message
        blast radius the pre-batch dispatch had.
        """
        out: List[Union[Write1Response, BadRequest]] = []
        for req in reqs:
            try:
                out.append(self.process_write1(req))
            except Exception as exc:  # BadRequest or a processing bug
                out.append(exc)
        return out

    # ---------------------------------------------------------------- write2

    def _cert_stamp(self, wc: WriteCertificate) -> Optional[int]:
        """The certificate's configstamp (from its first OK grant)."""
        for mg in wc.grants.values():
            for g in mg.grants.values():
                if g.status == Status.OK:
                    return g.configstamp
        return None

    def cert_config(self, wc: WriteCertificate) -> ClusterConfig:
        """The configuration a certificate must be judged against: the one
        in force at its configstamp, falling back to the current config for
        unknown stamps.  Single source of truth for BOTH the signature layer
        (which keys signed) and the quorum layer (which sets/quorum count) —
        the two verdicts must never diverge for one certificate."""
        stamp = self._cert_stamp(wc)
        if stamp is None:
            return self.config
        return self.nearest_config_for_stamp(stamp)

    def _coalesce_grants(
        self, wc: WriteCertificate, transaction: Transaction
    ) -> Tuple[Dict[str, Tuple[int, List[Grant]]], ClusterConfig]:
        """Group certificate grants per object; timestamps must agree across
        servers (ref: ``processMultiGrantsFromAllServers``,
        ``InMemoryDataStore.java:613-640``).

        Only grants from servers *inside the object's replica set* count:
        the BFT fault assumption (at most f faulty of the 3f+1 replicas of a
        set) says nothing about servers outside the set, so a grant from an
        out-of-set server — however validly signed — must not contribute to
        the quorum.

        Configstamp gating (the paper's CS check, mochiDB.tex:186-189): a
        certificate must be formed under ONE configuration — mixed
        configstamps are rejected — and a configstamp AHEAD of ours means
        the cluster reconfigured and we haven't caught up (the replica
        schedules a config resync and refuses for now).  Configstamps
        BEHIND ours stay acceptable — resync replays historical
        certificates after a reconfiguration moves keys — and are judged
        against the replica sets and quorum OF THEIR OWN configuration
        (:meth:`config_for_stamp`): a certificate's validity is a fact about
        the configuration it was granted under, not about today's ring.
        """
        stamp_seen = self._cert_stamp(wc)
        if stamp_seen is not None and stamp_seen > self.config.configstamp:
            raise BadCertificate(
                f"configstamp ahead: grant cs={stamp_seen} > "
                f"ours {self.config.configstamp}"
            )
        cert_cfg = self.cert_config(wc)
        coalesced: Dict[str, Tuple[int, List[Grant]]] = {}
        replica_sets = {
            op.key: set(cert_cfg.replica_set_for_key(op.key))
            for op in transaction.operations
        }
        # One vote per (key, server): iterate unique keys, and dedupe
        # contributing servers so a duplicate-key transaction (or a MultiGrant
        # repeated under two server ids) can't inflate the quorum count.
        seen: Dict[str, set] = {key: set() for key in replica_sets}
        for mg in wc.grants.values():
            for key, rset in replica_sets.items():
                grant = mg.grants.get(key)
                if grant is None or grant.status != Status.OK:
                    continue
                if mg.server_id not in rset or mg.server_id in seen[key]:
                    continue
                if grant.configstamp != stamp_seen:
                    raise BadCertificate("mixed configstamps in certificate")
                seen[key].add(mg.server_id)
                entry = coalesced.get(key)
                if entry is None:
                    coalesced[key] = (grant.timestamp, [grant])
                elif entry[0] != grant.timestamp:
                    raise BadCertificate(f"grant timestamps disagree for {key}")
                else:
                    entry[1].append(grant)
        return coalesced, cert_cfg

    def _validate_config_write(self, op: Operation) -> Optional[str]:
        """Structural checks for writes into the cluster-config keyspace.

        Returns an error detail (None = fine).  Prevents the committed
        membership document diverging from what replicas installed: a
        CONFIG_CLUSTER doc must be exactly current-stamp (idempotent
        replay/resync) or current+1 (the next reconfiguration) — a stale
        concurrent admin write with an old stamp is refused instead of
        silently overwriting the document replicas never installed.
        Archive entries must carry the config matching their key's stamp.
        Deletes of config-cluster keys are never allowed.
        """
        if op.key != CONFIG_CLUSTER_KEY and not op.key.startswith(CONFIG_ARCHIVE_PREFIX):
            return None
        if op.action == Action.DELETE:
            return f"delete of {op.key} not permitted"
        if op.action != Action.WRITE:
            return None
        if not op.value:
            return f"empty config document for {op.key}"
        try:
            doc = ClusterConfig.from_json(bytes(op.value).decode())
        except Exception as exc:
            return f"unparseable config document for {op.key}: {exc}"
        current = self.config.configstamp
        if op.key == CONFIG_CLUSTER_KEY:
            if doc.configstamp not in (current, current + 1):
                return (
                    f"non-sequential config: doc cs={doc.configstamp}, "
                    f"ours {current} (want {current} or {current + 1})"
                )
            if doc.configstamp == current and not _same_config(doc, self.config):
                # current-stamp writes are only for idempotent replay: a
                # DIFFERENT doc at the same stamp is a lost admin race — it
                # must not overwrite the membership replicas installed.
                return f"config cs={doc.configstamp} differs from the installed one"
            return None
        try:
            key_stamp = int(op.key[len(CONFIG_ARCHIVE_PREFIX):])
        except ValueError:
            return f"malformed archive key {op.key}"
        if doc.configstamp != key_stamp:
            return f"archive {op.key} holds doc cs={doc.configstamp}"
        if doc.configstamp > current + 1:
            return f"archive cs={doc.configstamp} too far ahead of {current}"
        known = self.config_for_stamp(key_stamp)
        if known is not None and not _same_config(doc, known):
            return f"archive {op.key} differs from the known cs={key_stamp} config"
        return None

    def process_write2(self, req: Write2ToServer) -> Write2Response:
        """Verify certificate shape and apply the transaction
        (ref: ``processWrite2ToServer`` + ``write2apply``,
        ``InMemoryDataStore.java:576-611,641-666``)."""
        transaction = req.transaction
        txn_hash = transaction_hash(transaction)
        try:
            coalesced, cert_cfg = self._coalesce_grants(req.write_certificate, transaction)
        except BadCertificate as exc:
            return RequestFailedFromServer(FailType.BAD_CERTIFICATE, str(exc))

        # Config-write validation runs as a PRE-PASS so a rejection keeps
        # the whole transaction un-applied (inside the loop, earlier data
        # ops would already have committed when a later config op failed).
        for op in transaction.operations:
            config_err = self._validate_config_write(op)
            if config_err is not None:
                return RequestFailedFromServer(FailType.BAD_REQUEST, config_err)

        results: List[OperationResult] = []
        staleness_checked: Dict[str, bool] = {}
        already_current: Dict[str, bool] = {}
        applied: Dict[str, None] = {}  # insertion-ordered applied-key set
        for op in transaction.operations:
            if not self.owns(op.key):
                self.shard_counters["write2_foreign"] += 1
                results.append(OperationResult(status=Status.WRONG_SHARD))
                continue
            entry = coalesced.get(op.key)
            if entry is None:
                return RequestFailedFromServer(
                    FailType.BAD_CERTIFICATE, f"no grants for {op.key}"
                )
            ts, grant_list = entry
            # Quorum: >= 2f+1 distinct-server grants (fixes the strict-'>' at
            # InMemoryDataStore.java:590), measured against the certificate's
            # own configuration (see _coalesce_grants).
            if len(grant_list) < cert_cfg.quorum:
                return RequestFailedFromServer(
                    FailType.BAD_CERTIFICATE,
                    f"{len(grant_list)} grants < quorum {cert_cfg.quorum} for {op.key}",
                )
            if any(g.transaction_hash != txn_hash for g in grant_list):
                return RequestFailedFromServer(
                    FailType.BAD_CERTIFICATE, f"transaction hash mismatch for {op.key}"
                )
            sv = self._get_or_create(op.key)
            # Duplicate keys apply SEQUENTIALLY (last write wins), matching
            # the reference's per-op applyOperation loop
            # (InMemoryDataStore.java:521-554).  The staleness verdict is
            # made once per key — after the first apply the key's
            # certificate IS this transaction's, and re-deciding against it
            # would misclassify the second op.
            stale = staleness_checked.get(op.key)
            if stale is None:
                current_ts = self._cert_ts(sv)
                stale = current_ts is not None and current_ts > ts
                staleness_checked[op.key] = stale
                # Equal-ts re-apply of the SAME transaction (a client
                # Write2 retry, a resync pull of an already-current key):
                # the apply below is an idempotent no-op, so staging it
                # would write a duplicate WAL record that the next
                # recovery's "did not advance" rule falsely convicts as
                # tampering.  Judged per key against the PRE-transaction
                # state, like staleness.
                already_current[op.key] = (
                    not stale
                    and current_ts == ts
                    and sv.last_transaction is not None
                    and transaction_hash(sv.last_transaction) == txn_hash
                )
            if stale:
                # Stale write2: answer with current state instead
                # (ref: InMemoryDataStore.java:594-598).
                result = OperationResult(sv.value, sv.current_certificate, sv.exists, Status.OK)
            else:
                result = self._apply(op, sv, ts, req.write_certificate, transaction)
                self.shard_counters["write2_applied"] += 1
                if op.action in (Action.WRITE, Action.DELETE) and not (
                    already_current.get(op.key)
                ):
                    # READ ops inside a write transaction commit nothing,
                    # and already-current keys re-commit nothing: staging
                    # either would make replay (which re-runs the whole
                    # transaction) see a no-op and convict an honest log
                    # for it.
                    applied.setdefault(op.key)
            results.append(result)
        if applied and self.storage is not None:
            # ONE staged record per applied transaction (the engine's
            # replay applies the whole transaction in one Write2, exactly
            # like this call did) — staged synchronously on this loop
            # turn; the replica flushes before the batch's responses ship.
            self.storage.stage_commit(
                list(applied), transaction, req.write_certificate
            )
        return Write2AnsFromServer(TransactionResult(tuple(results)), rid="")

    def process_write2_batch(
        self, reqs: "Iterable[Write2ToServer]"
    ) -> "List[Write2Response]":
        """Quorum-check + apply one drained batch of Write2s in a single
        store entry: one uninterrupted loop turn for the whole batch (the
        event-loop analog of one lock acquisition — see
        :meth:`process_write1_batch`), with each transaction judged
        independently so one bad certificate fails alone.  Callers have
        already signature-checked every grant (the replica's pooled
        verifier round trip); this layer enforces quorum shape, hash and
        timestamp agreement per request, exactly as the single entry point.
        Unexpected per-request exceptions return as VALUES (same isolation
        contract as :meth:`process_write1_batch`).
        """
        out: List[Write2Response] = []
        for req in reqs:
            try:
                out.append(self.process_write2(req))
            except Exception as exc:  # a processing bug must fail alone
                out.append(exc)  # type: ignore[arg-type]
        return out

    def _apply(
        self,
        op: Operation,
        sv: StoreValue,
        ts: int,
        wc: WriteCertificate,
        transaction: Transaction,
    ) -> OperationResult:
        """Commit one operation (ref: ``applyOperation``,
        ``InMemoryDataStore.java:521-554``)."""
        if op.action not in (Action.WRITE, Action.DELETE):
            # READ inside a write transaction: serve current state.
            return OperationResult(sv.value, sv.current_certificate, sv.exists, Status.OK)
        existed_before = sv.exists
        sv.current_certificate = wc
        sv.last_transaction = transaction
        sv.delete_grant(ts)
        now = time.monotonic()
        self._untrack_grant(op.key, ts)  # grant consumed: quota released
        for dts in sv.advance_epoch(ts):
            self._untrack_grant(op.key, dts)  # GC'd epochs release quota too
        self._wedge_close(op.key, now)  # a commit un-wedges the key
        if op.action == Action.WRITE:
            sv.value = op.value
            sv.exists = True
        else:
            sv.value = None
            sv.exists = False
        if (
            (op.key == CONFIG_CLUSTER_KEY or op.key.startswith(CONFIG_ARCHIVE_PREFIX))
            and op.action == Action.WRITE
            and op.value
            and self.on_config_value is not None
        ):
            # Fires for archive keys too: during resync catch-up the chain
            # rung _CS_<k+1> (not the head document, whose certificate is
            # still "ahead") is what advances a laggard's configstamp.
            # _install_config ignores stale/duplicate stamps.
            try:
                self.on_config_value(op.value)
            except Exception:
                LOG.exception("config install hook failed")
        if op.key.startswith(CONFIG_CLIENT_PREFIX) and self.on_client_key_change:
            try:
                self.on_client_key_change(op.key[len(CONFIG_CLIENT_PREFIX):])
            except Exception:
                LOG.exception("client key change hook failed")
        # certificate=None, deliberately: the client COORDINATED this write
        # — it built ``wc`` and shipped it to us one message ago, and its
        # Write2 tally fingerprints (value, status) only.  Echoing the
        # certificate back multiplies the answer by quorum x batch-size
        # MultiGrant trees: at 16-op batched PUTs that echo alone made the
        # write path O(K^2) on the wire (~45% of all message-decode CPU,
        # a profile).  Reads still return the full certificate — that is
        # where a client learns state it does not already hold.
        return OperationResult(op.value, None, existed_before, Status.OK)

    # ----------------------------------------------------------------- sync

    def export_sync_entries(
        self,
        keys: Optional[Iterable[str]] = None,
        max_entries: int = 1024,
        after_key: Optional[str] = None,
        prefix: Optional[str] = None,
    ) -> List[SyncEntry]:
        """Committed (transaction, certificate) pairs for state transfer.

        Serves the paper's UptoSpeed (``mochiDB.tex:168-169``).  Any key
        with a commit history is exported — deliberately NOT restricted to
        keys this server currently owns: after a reconfiguration re-deals
        the token ring, a moved key's old holders no longer own it, yet they
        are exactly the nodes that must hand it to the new owner.  Safe
        because every entry carries its own (transaction, certificate)
        proof; the receiver enforces its own ownership and re-validates.
        Keys are walked in sorted order so callers can page with
        ``after_key`` (resync loops until a short page); both keyspaces
        (data + ``_CONFIG_``) are covered.
        """
        if keys is None:
            names = set(self.data) | set(self.data_config)
            if self.storage is not None and self.storage.pager:
                # evicted keys still have exportable commit history on
                # disk; _get below faults each one in through the engine
                names |= set(self.storage.paged_keys())
            candidates: Iterable[str] = sorted(names)
        else:
            candidates = sorted(keys)
        out: List[SyncEntry] = []
        for key in candidates:
            if after_key is not None and key <= after_key:
                continue
            if prefix is not None and not key.startswith(prefix):
                continue
            if len(out) >= max_entries:
                break
            sv = self._get(key)
            if sv is None or sv.current_certificate is None or sv.last_transaction is None:
                continue
            out.append(SyncEntry(key, sv.last_transaction, sv.current_certificate))
        return out

    @staticmethod
    def key_digest(key: str, txh: bytes) -> bytes:
        """16-byte anti-entropy digest of one key's last commit.  Derived
        from the quorum-signed transaction hash, so two honest replicas
        that applied the same commit agree byte-for-byte."""
        import hashlib

        return hashlib.sha256(key.encode() + b"\x00" + txh).digest()[:16]

    def _iter_digests(self):
        """(key, token, digest16) for every key with commit history, both
        keyspaces (the ``_CONFIG_`` keys hash onto the ring like any other
        key, so they roll into shard digests uniformly)."""
        for space in (self.data, self.data_config):
            for key, sv in space.items():
                if sv.last_transaction is None or sv.current_certificate is None:
                    continue
                txh = transaction_hash(sv.last_transaction)
                yield key, self.config.token_for_key(key), self.key_digest(key, txh)
        if self.storage is not None and self.storage.pager:
            # evicted keys digest from the page index's footer txh — no
            # fault-in (anti-entropy over a paged keyspace must not drag
            # the whole store resident); a tampered footer txh can at
            # worst force a digest mismatch, i.e. a resync repair
            for key, txh in self.storage.iter_evicted_digests(
                self.data, self.data_config
            ):
                yield key, self.config.token_for_key(key), self.key_digest(key, txh)

    def export_shard_digests(self) -> List[List[object]]:
        """Per-shard rollups ``[token, n_keys, digest]`` — the XOR of the
        shard's per-key digests (order independent: replicas that applied
        the same commits in any interleaving agree).  Shards with no
        committed state are omitted (an empty shard XORs to the absent
        entry on both sides)."""
        acc: Dict[int, List[object]] = {}
        for _key, token, digest in self._iter_digests():
            slot = acc.get(token)
            if slot is None:
                acc[token] = [token, 1, digest]
            else:
                slot[1] += 1
                slot[2] = bytes(a ^ b for a, b in zip(slot[2], digest))
        return [acc[t] for t in sorted(acc)]

    def export_key_digests(
        self,
        tokens: Iterable[int],
        max_entries: int = 4096,
        after_key: Optional[str] = None,
    ) -> List[Tuple[str, bytes]]:
        """Key-level digests for the named shards, key-sorted pages (same
        ``after_key`` protocol as :meth:`export_sync_entries`)."""
        wanted = set(tokens)
        out = sorted(
            (key, digest)
            for key, token, digest in self._iter_digests()
            if token in wanted and (after_key is None or key > after_key)
        )
        return out[:max_entries]

    def apply_sync_entry(self, entry: SyncEntry) -> bool:
        """Apply one state-transfer entry through the full Write2 validation
        (quorum, hash, staleness).  Returns True if state advanced."""
        sv_before = self._get(entry.key)
        ts_before = self._cert_ts(sv_before) if sv_before else None
        response = self.process_write2(
            Write2ToServer(entry.certificate, entry.transaction)
        )
        if not isinstance(response, Write2AnsFromServer):
            return False
        sv_after = self._get(entry.key)
        ts_after = self._cert_ts(sv_after) if sv_after else None
        return ts_after is not None and ts_after != ts_before


def _same_config(a: ClusterConfig, b: ClusterConfig) -> bool:
    """Semantic config equality (field-wise; ignores caches)."""
    return (
        a.configstamp == b.configstamp
        and a.rf == b.rf
        and a.servers == b.servers
        and a.token_owners == b.token_owners
        and a.public_keys == b.public_keys
        and a.admin_keys == b.admin_keys
    )


class BadCertificate(Exception):
    """Certificate failed structural checks (timestamp disagreement etc.)."""


class BadRequest(Exception):
    """Request failed input validation (out-of-range seed, empty key, ...)."""


class QuotaExceeded(BadRequest):
    """The sender's per-client outstanding-grant quota is exhausted
    (``CLIENT_GRANT_QUOTA``).  Subclasses :class:`BadRequest` so every
    existing per-request isolation path treats it as a typed refusal
    value; the replica maps it to ``FailType.QUOTA_EXCEEDED`` with the
    ``retry_after_ms`` hint instead of a plain
    BAD_REQUEST."""

    def __init__(self, msg: str, retry_after_ms: int = 0):
        super().__init__(msg)
        self.retry_after_ms = retry_after_ms
