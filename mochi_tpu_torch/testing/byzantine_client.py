"""Byzantine CLIENT fault injection: misbehaving coordinators with real keys.

``testing/byzantine.py`` puts adversaries behind replica identities; this
module covers the CLIENT side of the protocol, which in this design is the
only coordinator (no server-to-server write path).  Basil (SOSP'21, arXiv
2109.12443) frames why this matters for BFT-DB work: client misbehavior
attacks LIVENESS and FAIRNESS, not safety — a client that follows the
message formats exactly but withholds, reorders, or biases its coordination
can wedge honest contenders without ever forging a byte.  The concrete hole
here is the known HQ-replication contention/cleanup weakness the paper
inherits: ``DataStore.process_write1`` refuses any conflicting transaction
while a granted slot is outstanding, and without grant expiry nothing would
ever free it.

:class:`ByzantineClient` wraps a REAL :class:`~mochi_tpu_torch.client.client.
MochiDBClient` — real Ed25519 keypair, real sessions, real signing, the
production pool — and drives attacks through the SDK's own message
builders, so every hostile message is validly authenticated and
indistinguishable from honest traffic until its *pattern* convicts it.

Strategy catalog (``CLIENT_STRATEGIES``):

``withhold``
    Acquire grant sets and never send Write2.  The worst case sweeps every
    subEpoch seed of a key's current epoch (``wedge``): the epoch only
    advances on apply, nothing applies, and every conflicting honest
    Write1 is refused at whatever seed it draws — an indefinite wedge
    without reclamation.  Defenses: per-client quota caps the sweep;
    ``MOCHI_GRANT_TTL_MS`` reclamation bounds the wedge near the TTL.

``partial-write2``
    Commit a perfectly valid certificate at a sub-quorum MINORITY of the
    replica set, so replicas diverge on outstanding state (the minority
    holds a commit the majority never saw).  Safety holds — the invariant
    checker keys conflicting-commit detection by timestamp, and the two
    sides occupy different slots — and the divergence heals through the
    existing laggard-nudge/resync path; the attack's cost is the extra
    contention + resync traffic it forces.

``seed-bias``
    Deterministic colliding subEpoch seeds: sweep seeds 0..bias_range-1 on
    hot keys (never committing), so honest writers' random draws collide
    with probability bias_range/1000 per attempt instead of ~1/1000 —
    the paper's random-seed mitigation turned against itself.  Quota caps
    how much of the seed space one identity can poison.

``grant-hoard``
    Breadth instead of depth: one withheld grant on each of MANY keys
    (including honest writers' keys), holding them all — a grant-book
    memory/quota stressor.  The per-client quota caps total holdings; the
    replica's per-client ledger (``DataStore.client_stats``) makes the
    hoarder visible.

All strategies are deterministic given their seed.  Inject via
``VirtualCluster.byzantine_client(...)`` / ``ProcessCluster.
byzantine_client(...)`` — composable with the replica adversaries
(``byzantine={...}``) in the same cluster.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import random
import time
import zlib
from typing import Dict, List, Optional, Sequence

from ..client.client import SEED_RANGE, MochiDBClient
from ..net.transport import new_msg_id
from ..protocol import (
    Action,
    FailType,
    MultiGrant,
    Operation,
    RequestFailedFromServer,
    Transaction,
    Write1OkFromServer,
    Write1ToServer,
    Write2AnsFromServer,
    Write2ToServer,
    WriteCertificate,
    transaction_hash,
)

LOG = logging.getLogger(__name__)

CLIENT_STRATEGIES = ("withhold", "partial-write2", "seed-bias", "grant-hoard")


@contextlib.contextmanager
def defense_knobs(ttl_ms: Optional[float] = None, quota: Optional[int] = None):
    """Pin the store's defense knobs (grant TTL, per-client quota) for one
    scenario and restore after — the ONE save/patch/restore helper tests
    and benchmark legs
    share (in-process postures only; child processes read the env vars)."""
    from ..server import store as store_mod

    saved = (store_mod.GRANT_TTL_MS, store_mod.CLIENT_GRANT_QUOTA)
    try:
        if ttl_ms is not None:
            store_mod.GRANT_TTL_MS = ttl_ms
        if quota is not None:
            store_mod.CLIENT_GRANT_QUOTA = quota
        yield
    finally:
        store_mod.GRANT_TTL_MS, store_mod.CLIENT_GRANT_QUOTA = saved


class ByzantineClient:
    """A protocol-conformant hostile coordinator.

    Wraps (never subclasses) the production SDK: attacks are built from
    the client's OWN envelope/signing machinery (``_envelope``,
    ``_write1_transaction``, ``_quorum_grant_subset``), so the replicas
    see correctly-signed, correctly-shaped messages from a registered
    identity — the defenses under test are quota/TTL/ledger accounting,
    never signature checks.
    """

    def __init__(
        self,
        client: MochiDBClient,
        strategy: str = "withhold",
        seed: int = 0,
        timeout_s: Optional[float] = None,
    ):
        if strategy not in CLIENT_STRATEGIES:
            raise ValueError(
                f"unknown byzantine client strategy {strategy!r}: "
                f"use one of {sorted(CLIENT_STRATEGIES)}"
            )
        self.client = client
        self.strategy = strategy
        self.rng = random.Random(seed)
        self.timeout_s = timeout_s if timeout_s is not None else client.timeout_s
        # what the adversary accomplished — embedded in benchmark records
        self.stats: Dict[str, int] = {
            "write1_sent": 0,
            "grants_held": 0,
            "refused": 0,
            "quota_refused": 0,
            "partial_commits": 0,
            "errors": 0,
        }

    @property
    def client_id(self) -> str:
        return self.client.client_id

    async def close(self) -> None:
        await self.client.close()

    # ------------------------------------------------------------ primitives

    async def _ensure_sessions(self, key: str) -> None:
        """MAC sessions with the key's replica set (what any throughput-
        conscious client — honest or not — does): the attack sweeps then
        ride the cheap HMAC envelope path instead of paying an Ed25519
        sign+verify per hostile message."""
        c = self.client
        await asyncio.gather(
            *(
                c._ensure_session(info.server_id, info)
                for info in c.config.servers_for_key(key)
            )
        )

    async def _write1_one(
        self, info, txn: Transaction, seed: int, txn_hash: bytes
    ) -> Optional[object]:
        """One signed Write1 to one replica; returns the payload or None."""
        c = self.client
        env = c._envelope(
            Write1ToServer(c.client_id, txn, seed, txn_hash),
            new_msg_id(),
            info.server_id,
        )
        self.stats["write1_sent"] += 1
        try:
            res = await c.pool.send_and_receive(info, env, self.timeout_s)
        except asyncio.CancelledError:
            raise
        except Exception:
            self.stats["errors"] += 1
            return None
        payload = res.payload
        if isinstance(payload, Write1OkFromServer):
            self.stats["grants_held"] += len(
                [g for g in payload.multi_grant.grants.values()]
            )
            return payload
        if isinstance(payload, RequestFailedFromServer):
            if payload.fail_type == FailType.QUOTA_EXCEEDED:
                self.stats["quota_refused"] += 1
                # mirror the SDK write path's counters so the client admin
                # shell's Clients view covers raw-harness traffic too
                c.metrics.mark("client.write1-quota")
                c.metrics.mark(f"client.quota-refused.{info.server_id}")
            else:
                self.stats["refused"] += 1
        else:
            self.stats["refused"] += 1
        return payload

    async def acquire(
        self, key: str, seed: int, value_hint: bytes = b"withheld"
    ) -> Dict[str, MultiGrant]:
        """Collect grants for one (key, seed) from the key's full replica
        set and HOLD them (no Write2).  Returns the OK MultiGrants by
        server id."""
        c = self.client
        await self._ensure_sessions(key)
        txn = Transaction((Operation(Action.WRITE, key, value_hint),))
        blind = c._write1_transaction(txn)
        h = transaction_hash(txn)
        results = await asyncio.gather(
            *(
                self._write1_one(info, blind, seed, h)
                for info in c.config.servers_for_key(key)
            )
        )
        return {
            p.multi_grant.server_id: p.multi_grant
            for p in results
            if isinstance(p, Write1OkFromServer)
        }

    async def wedge(self, key: str, seeds: Optional[Sequence[int]] = None) -> int:
        """The withhold attack's worst case: hold EVERY subEpoch slot of
        ``key``'s current epoch at every in-set replica (one transaction,
        all seeds — the idempotent-retry rule lets one txn hash occupy the
        whole seed space).  Until a defense intervenes, any conflicting
        honest Write1 is refused at whatever seed it draws.  Returns the
        number of OK per-replica grant responses held."""
        c = self.client
        await self._ensure_sessions(key)
        txn = Transaction((Operation(Action.WRITE, key, b"wedge"),))
        blind = c._write1_transaction(txn)
        h = transaction_hash(txn)
        if seeds is None:
            seeds = range(SEED_RANGE)
        seed_list = list(seeds)
        targets = c.config.servers_for_key(key)
        held = 0
        # One replica at a time, seeds in sub-shed-radar chunks: a single
        # full-seed burst lands as one giant drain batch and trips the
        # admission controller (batch EWMA past MOCHI_SHED_BATCH_HW
        # → OVERLOADED sheds punch holes in the wedge) — a patient
        # attacker paces below the load signal, which is exactly why
        # admission control alone is not the anti-wedge defense (the
        # store-level TTL/quota are).
        chunk = 48
        for info in targets:
            for i in range(0, len(seed_list), chunk):
                results = await asyncio.gather(
                    *(
                        self._write1_one(info, blind, s, h)
                        for s in seed_list[i : i + chunk]
                    )
                )
                held += sum(
                    1 for p in results if isinstance(p, Write1OkFromServer)
                )
        return held

    async def partial_write2(
        self,
        key: str,
        value: bytes,
        n_targets: int = 1,
        seed: Optional[int] = None,
    ) -> bool:
        """Assemble a fully valid write certificate, then commit it at only
        ``n_targets`` replicas (a sub-quorum minority): those replicas
        apply — the certificate is self-certifying — while the rest never
        hear of it, so the set diverges on outstanding state until resync
        heals it.  Returns True when the minority acked the apply."""
        c = self.client
        await self._ensure_sessions(key)
        txn = Transaction((Operation(Action.WRITE, key, value),))
        blind = c._write1_transaction(txn)
        h = transaction_hash(txn)
        if seed is None:
            seed = self.rng.randrange(SEED_RANGE)
        targets = c.config.servers_for_key(key)
        results = await asyncio.gather(
            *(self._write1_one(info, blind, seed, h) for info in targets)
        )
        oks: List[MultiGrant] = [
            p.multi_grant for p in results if isinstance(p, Write1OkFromServer)
        ]
        chosen = c._quorum_grant_subset(txn, oks)
        if chosen is None:
            return False
        certificate = WriteCertificate({mg.server_id: mg for mg in chosen})
        w2 = Write2ToServer(certificate, txn)
        acked = False
        for info in sorted(targets, key=lambda i: i.server_id)[:n_targets]:
            env = c._envelope(w2, new_msg_id(), info.server_id)
            try:
                res = await c.pool.send_and_receive(info, env, self.timeout_s)
            except asyncio.CancelledError:
                raise
            except Exception:
                self.stats["errors"] += 1
                continue
            if isinstance(res.payload, Write2AnsFromServer):
                acked = True
        if acked:
            self.stats["partial_commits"] += 1
        return acked

    async def hoard(
        self, keys: Sequence[str], seed: Optional[int] = None
    ) -> int:
        """grant-hoard sweep: one withheld grant per key across a wide
        keyspace (deterministic per-key seed unless given).  Returns the
        number of per-replica OK responses gathered this pass."""
        held = 0
        for key in keys:
            # stable per-key seed (crc32, not the salted builtin hash):
            # the module's determinism contract covers collision patterns
            # run over run
            s = (
                seed
                if seed is not None
                else zlib.crc32(key.encode()) % SEED_RANGE
            )
            grants = await self.acquire(key, s, value_hint=b"hoard")
            held += len(grants)
        return held

    # ---------------------------------------------------------- attack loop

    async def run(
        self,
        keys: Sequence[str],
        duration_s: float,
        interval_s: float = 0.05,
        bias_range: int = 128,
        wedge_seeds: int = 128,
        hoard_extra: int = 128,
    ) -> None:
        """Strategy loop for benchmark legs: attack ``keys`` (shared with
        honest writers) until the deadline.  Per-iteration failures are
        counted, never raised — an adversary does not crash."""
        deadline = time.monotonic() + duration_s
        i = 0
        hoard_keys = list(keys) + [
            f"hoard-{self.client_id[:8]}-{j}" for j in range(hoard_extra)
        ]
        while time.monotonic() < deadline:
            key = keys[i % len(keys)] if keys else f"byz-{i}"
            try:
                if self.strategy == "withhold":
                    # re-sweep each pass: honest commits advance the epoch,
                    # so held slots go stale and must be re-taken
                    await self.wedge(key, seeds=range(wedge_seeds))
                elif self.strategy == "seed-bias":
                    # deterministic colliding seeds across the hot keys —
                    # each pass re-takes the low seed range in the current
                    # epoch (the slots honest writers are most likely to
                    # draw are equally likely as any, but the SWEPT range
                    # is what scales the collision probability)
                    for k in keys:
                        await self.acquire(
                            k, i % bias_range, value_hint=b"bias"
                        )
                elif self.strategy == "grant-hoard":
                    await self.hoard(hoard_keys)
                elif self.strategy == "partial-write2":
                    await self.partial_write2(key, b"byz-%d" % i, n_targets=1)
            except asyncio.CancelledError:
                raise
            except Exception:
                LOG.exception("byzantine client iteration failed")
                self.stats["errors"] += 1
            i += 1
            await asyncio.sleep(interval_s)
