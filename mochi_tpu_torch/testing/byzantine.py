"""Byzantine fault injection: LIVE misbehaving replicas in the serving path.

Forging messages at the wire (``tests/test_torch_byzantine.py``) never puts a
misbehaving replica in a cluster's SERVING path.  This module does, the way
DSig (arXiv 2406.07215) and Handel (arXiv 1906.05132) argue it must be done:
the interesting failure modes of speculative/aggregated authentication only
surface with adversaries in the serving path, not in unit-test forgeries.

:class:`ByzantineReplica` is a behavior shim over a real
:class:`~mochi_tpu_torch.server.replica.MochiReplica`: the full honest runtime
(store, verifier, session layer, batched dispatch) runs underneath, and a
pluggable :class:`AttackStrategy` intercepts the batch seams — dropping
requests, mutating responses, and re-signing its lies with the replica's
REAL key.  That last part is the point: a Byzantine replica owns its
identity, so its misbehavior is validly authenticated and must be caught by
the protocol's quorum/content checks, never by signature checks.  Where the
honest replicas verify on the card (``CudaBatchVerifier``), the certificate
checks that convict or drop these lies are the card's.

Strategy catalog (``make_strategy`` names):

``equivocate``
    Conflicting MultiGrants: where the honest store refuses a Write1
    because the prospective timestamp is taken by a DIFFERENT transaction,
    the shim flips the refusal into an OK grant for the new transaction at
    the SAME timestamp — two validly-signed grants, same (key, ts),
    different transaction hashes, handed to different clients.  The
    classic safety attack; the honest side's defense is the 2f+1 quorum
    (one equivocator can never complete a conflicting certificate) plus
    the replica-side equivocation ledger
    (``MochiReplica._note_grant_evidence``) once both sides of the lie are
    presented.

``forge-cert``
    Tampered certificates/grants: Write1 grants go out with garbage
    signatures and wrong transaction hashes, read answers carry forged
    values and tampered certificates, Write2 answers lie about the applied
    value, and sync entries serve certificates whose grants no longer
    verify.  Caught by client grant validation (``MochiDBClient._grant_ok``),
    read/write tallies, and the resync certificate re-check.

``stale-replay``
    The replica pretends time never advanced: reads serve the FIRST state
    it ever saw per key, and Write1 grants are issued as if its epochs
    were reset to 0 (the restarted-without-resync posture, live).  Caught
    by timestamp-majority grant subsets and read quorums.

``silent``
    Never answers anything — every commit must go through the
    early-quorum straggler path, and ``fanout.straggler-timeout.<sid>``
    accrues on every initiator (the per-peer suspicion signal the client
    admin shell surfaces).

``storm``
    View-change/liveness storm: refuses a seeded fraction of Write1s
    (validly signed refusals) and floods peers with resync nudges.  Run
    under a netsim partition schedule this is the reconfiguration-churn
    shape: transient quorum loss, retry pressure, background sync traffic.

``session-attack``
    Fast-path adversary: establishes a REAL peer MAC session with
    a victim (the attacker is in-set, so the signed handshake succeeds
    honestly) and then attacks the session machinery itself — MAC-window
    mutation, cross-checkpoint replay, checkpoint downgrade, and riding
    the MAC discount past the overdue cap.  Every probe must end in a
    TYPED refusal or a conviction on the victim; a silent fallback to the
    signed path without evidence is the bug the probes exist to catch.

All strategies are deterministic given their seed.
"""

from __future__ import annotations

import asyncio
import logging
import random
import time
from dataclasses import replace
from typing import Dict, List, Optional, Sequence

from ..crypto import session as session_crypto
from ..net.transport import new_msg_id
from ..protocol import (
    Envelope,
    Grant,
    MultiGrant,
    NudgeSyncToServer,
    OperationResult,
    ReadFromServer,
    SessionCheckpointToServer,
    Status,
    SyncEntriesFromServer,
    SyncRequestToServer,
    TransactionResult,
    Write1OkFromServer,
    Write1RefusedFromServer,
    Write1ToServer,
    Write2AnsFromServer,
)
from ..server.replica import MochiReplica

LOG = logging.getLogger(__name__)

STRATEGIES = (
    "equivocate", "forge-cert", "stale-replay", "silent", "storm",
    "session-attack",
)


class AttackStrategy:
    """Base strategy: honest passthrough.  Subclasses override the three
    seams — ``wants`` (drop a request outright), ``mutate`` (rewrite the
    honest response payload; the shim re-authenticates whatever comes
    back), and ``run`` (an optional background task for active attacks
    like nudge floods).  ``bind`` hands the strategy its replica."""

    name = "honest"

    def __init__(self, seed: int = 0):
        self.replica: Optional[MochiReplica] = None
        self.rng = random.Random(seed)

    def bind(self, replica: MochiReplica) -> None:
        self.replica = replica

    def wants(self, env: Envelope) -> bool:
        """False = swallow the request (no response at all)."""
        return True

    def mutate(self, env: Envelope, payload):
        """Rewrite one honest response payload (or return it unchanged).
        Returning None drops the response after processing."""
        return payload

    async def run(self) -> None:
        """Optional active-attack loop; cancelled at replica close."""
        return None

    # ------------------------------------------------------------- helpers

    def _resign(self, mg: MultiGrant) -> MultiGrant:
        """Validly re-sign a (mutated) MultiGrant with the replica's REAL
        key — Byzantine lies are authenticated; content checks must catch
        them."""
        assert self.replica is not None
        bare = replace(mg, signature=None)
        return bare.with_signature(self.replica.keypair.sign(bare.signing_bytes()))


class SilentStrategy(AttackStrategy):
    """Answers nothing.  Forces every fan-out through the early-quorum
    straggler path; initiators accrue ``fanout.straggler-timeout.<sid>``."""

    name = "silent"

    def wants(self, env: Envelope) -> bool:
        return False


class EquivocateStrategy(AttackStrategy):
    """Flips Write1 refusals into OK grants at the contested timestamp:
    the second client gets a validly-signed grant for ITS transaction at a
    timestamp this replica already granted to a different transaction."""

    name = "equivocate"

    def mutate(self, env: Envelope, payload):
        if not isinstance(payload, Write1RefusedFromServer):
            return payload
        req = env.payload
        if not isinstance(req, Write1ToServer):
            return payload
        mg = payload.multi_grant
        flipped = {
            key: (
                Grant(g.object_id, g.timestamp, g.configstamp,
                      req.transaction_hash, Status.OK)
                if g.status == Status.REFUSED
                else g
            )
            for key, g in mg.grants.items()
        }
        forged = self._resign(
            MultiGrant(flipped, mg.client_id, mg.server_id)
        )
        return Write1OkFromServer(forged, {})


class ForgeCertStrategy(AttackStrategy):
    """Tampered authentication material everywhere it travels: garbage
    grant signatures + wrong hashes at Write1, forged values/certificates
    at read, lying Write2 answers, unverifiable sync entries."""

    name = "forge-cert"

    def _garbage_sig(self) -> bytes:
        return bytes(self.rng.randrange(256) for _ in range(64))

    def mutate(self, env: Envelope, payload):
        if isinstance(payload, Write1OkFromServer):
            mg = payload.multi_grant
            tampered = {
                key: replace(g, transaction_hash=b"\x00" * 64)
                for key, g in mg.grants.items()
            }
            forged = replace(
                MultiGrant(tampered, mg.client_id, mg.server_id),
                signature=self._garbage_sig(),
            )
            return Write1OkFromServer(forged, {})
        if isinstance(payload, ReadFromServer):
            ops = tuple(
                replace(op, value=b"forged-" + bytes(op.value or b""), existed=True)
                for op in payload.result.operations
            )
            return replace(payload, result=TransactionResult(ops))
        if isinstance(payload, Write2AnsFromServer):
            ops = tuple(
                replace(op, value=b"forged-" + bytes(op.value or b""))
                for op in payload.result.operations
            )
            return replace(payload, result=TransactionResult(ops))
        if isinstance(payload, SyncEntriesFromServer):
            entries = tuple(
                replace(
                    e,
                    certificate=type(e.certificate)(
                        {
                            sid: replace(mg, signature=self._garbage_sig())
                            for sid, mg in e.certificate.grants.items()
                        }
                    ),
                )
                for e in payload.entries
            )
            return SyncEntriesFromServer(entries)
        return payload


class StaleReplayStrategy(AttackStrategy):
    """Serves the past: reads return the FIRST state this replica ever
    answered for each key, and Write1 grants are re-issued at reset epochs
    (timestamp collapsed to the seed, as a restarted-without-resync
    replica would) — stale-but-validly-signed everything."""

    name = "stale-replay"

    def __init__(self, seed: int = 0):
        super().__init__(seed)
        self._first: Dict[str, OperationResult] = {}

    def mutate(self, env: Envelope, payload):
        if isinstance(payload, ReadFromServer):
            req_txn = getattr(env.payload, "transaction", None)
            if req_txn is None:
                return payload
            ops: List[OperationResult] = []
            for op, res in zip(req_txn.operations, payload.result.operations):
                held = self._first.setdefault(op.key, res)
                ops.append(held)
            return replace(payload, result=TransactionResult(tuple(ops)))
        if isinstance(payload, (Write1OkFromServer, Write1RefusedFromServer)):
            mg = payload.multi_grant
            stale = {
                key: replace(g, timestamp=g.timestamp % 1000)
                for key, g in mg.grants.items()
            }
            forged = self._resign(MultiGrant(stale, mg.client_id, mg.server_id))
            return replace(payload, multi_grant=forged)
        return payload


class StormStrategy(AttackStrategy):
    """Liveness storm: refuses a seeded fraction of Write1s (validly
    signed) and floods peers with resync nudges — the view-change-churn
    shape, meant to run under netsim partitions."""

    name = "storm"

    def __init__(self, seed: int = 0, refuse_p: float = 0.5,
                 nudge_interval_s: float = 0.1, nudge_keys: int = 64):
        super().__init__(seed)
        self.refuse_p = refuse_p
        self.nudge_interval_s = nudge_interval_s
        self.nudge_keys = nudge_keys

    def mutate(self, env: Envelope, payload):
        if (
            isinstance(payload, Write1OkFromServer)
            and self.rng.random() < self.refuse_p
        ):
            mg = payload.multi_grant
            refused = {
                key: replace(g, status=Status.REFUSED)
                for key, g in mg.grants.items()
            }
            forged = self._resign(MultiGrant(refused, mg.client_id, mg.server_id))
            return Write1RefusedFromServer(forged, {}, mg.client_id)
        return payload

    async def run(self) -> None:
        replica = self.replica
        assert replica is not None
        keys = tuple(f"storm-junk-{i}" for i in range(self.nudge_keys))
        while True:
            await asyncio.sleep(self.nudge_interval_s)
            peers = [
                info
                for sid, info in replica.config.servers.items()
                if sid != replica.server_id
            ]
            for info in peers:
                try:
                    await replica.peer_pool.send_and_receive(
                        info,
                        replica._signed_request(NudgeSyncToServer(keys)),
                        timeout_s=1.0,
                    )
                except asyncio.CancelledError:
                    raise
                except Exception:
                    pass  # flood is best-effort; partitions drop it


class SessionAttackStrategy(AttackStrategy):
    """Fast-path adversary.  Passive on the serving seams (it
    answers honestly); the attack surface is a set of ACTIVE probes the
    tests drive deterministically, each abusing a real peer MAC session
    with the victim:

    - :meth:`tamper_mac_window` — mutate a sealed envelope's payload after
      sealing (in-flight MAC-window mutation).  The victim must answer a
      typed BAD_SIGNATURE and record a ``mac-tamper`` conviction.
    - :meth:`replay_across_window` — deliver one sealed envelope TWICE but
      sign a declaration covering it once.  The victim's checkpoint ledger
      counts two; the signed transcript convicts (``checkpoint-mismatch``,
      typed BAD_CERTIFICATE) and the session drops.
    - :meth:`downgrade_checkpoint` — declare a checkpoint under session
      MAC instead of an Ed25519 signature (the forced signature→MAC
      downgrade).  Typed BAD_REQUEST + ``checkpoint-downgrade`` conviction;
      never a silent fallback.
    - :meth:`overdue_flood` — ride the MAC discount without ever signing a
      transcript declaration.  Past ``OVERDUE_FACTOR`` windows the victim
      refuses typed (BAD_REQUEST policy refusal) and drops the session.
    """

    name = "session-attack"

    async def _session(self, victim_sid: str):
        r = self.replica
        assert r is not None
        info = r.config.servers[victim_sid]
        key = await r._ensure_peer_session(victim_sid, info)
        if key is None:
            raise RuntimeError(f"no peer MAC session with {victim_sid}")
        return info, key

    def _sealed(self, payload, key) -> Envelope:
        assert self.replica is not None
        env = Envelope(
            payload=payload,
            msg_id=new_msg_id(),
            sender_id=self.replica.server_id,
            timestamp_ms=int(time.time() * 1000),
        )
        return session_crypto.seal(env, key)

    async def tamper_mac_window(
        self, victim_sid: str, timeout_s: float = 2.0
    ) -> Envelope:
        """Seal honestly, then swap the payload — the bytes a MITM (or a
        buggy sender) would deliver inside an established MAC window."""
        info, key = await self._session(victim_sid)
        sealed = self._sealed(
            SyncRequestToServer(keys=("honest",), max_entries=1), key
        )
        evil = replace(
            sealed,
            payload=SyncRequestToServer(keys=("tampered",), max_entries=1),
        )
        return await self.replica.peer_pool.send_and_receive(
            info, evil, timeout_s
        )

    async def replay_across_window(
        self, victim_sid: str, timeout_s: float = 2.0
    ):
        """Deliver one sealed envelope twice, declare it once, checkpoint:
        returns (first_response, second_response); the conviction lands on
        the victim when the signed declaration under-covers its ledger."""
        r = self.replica
        assert r is not None
        info, key = await self._session(victim_sid)
        sealed = self._sealed(
            SyncRequestToServer(keys=("replayed",), max_entries=1), key
        )
        win = r._peer_windows.get(victim_sid)
        if win is not None:
            win.note(sealed.signing_bytes())  # signed for ONCE
        first = await r.peer_pool.send_and_receive(info, sealed, timeout_s)
        second = await r.peer_pool.send_and_receive(info, sealed, timeout_s)
        await r._peer_checkpoint(victim_sid, info, timeout_s)
        return first, second

    async def downgrade_checkpoint(
        self, victim_sid: str, timeout_s: float = 2.0
    ) -> Envelope:
        """A MAC'd transcript declaration: whoever holds the session key
        could forge it, which is exactly the adversary checkpoints exist
        to convict — the victim must refuse typed and convict."""
        info, key = await self._session(victim_sid)
        return await self.replica.peer_pool.send_and_receive(
            info, self._sealed(SessionCheckpointToServer(0, ()), key), timeout_s
        )

    async def overdue_flood(
        self, victim_sid: str, n: int, timeout_s: float = 2.0
    ) -> Optional[Envelope]:
        """Send ``n`` distinct MAC'd envelopes and never declare any of
        them; returns the last response (typed BAD_REQUEST once past the
        overdue cap)."""
        info, key = await self._session(victim_sid)
        last: Optional[Envelope] = None
        for i in range(n):
            sealed = self._sealed(
                SyncRequestToServer(keys=(f"od-{i}",), max_entries=1), key
            )
            last = await self.replica.peer_pool.send_and_receive(
                info, sealed, timeout_s
            )
        return last


def make_strategy(spec, seed: int = 0) -> AttackStrategy:
    """Resolve a strategy name (or pass an instance through)."""
    if isinstance(spec, AttackStrategy):
        return spec
    table = {
        "honest": AttackStrategy,
        "silent": SilentStrategy,
        "equivocate": EquivocateStrategy,
        "forge-cert": ForgeCertStrategy,
        "stale-replay": StaleReplayStrategy,
        "storm": StormStrategy,
        "session-attack": SessionAttackStrategy,
    }
    try:
        return table[spec](seed=seed)
    except KeyError:
        raise ValueError(
            f"unknown byzantine strategy {spec!r}: use one of {sorted(table)}"
        ) from None


def check_byzantine_map(byzantine, server_ids: Sequence[str]) -> None:
    """Refuse a ``{server_id: strategy}`` map that names a server outside
    ``server_ids`` or an unknown strategy — before any replica binds a
    socket or any process spawns: a typo'd id must not silently run an
    honest cluster under an adversarial label, and a failure midway through
    a start loop would leak the replicas already started."""
    unknown = set(byzantine) - set(server_ids)
    if unknown:
        raise ValueError(
            f"byzantine map names unknown servers: {sorted(unknown)} "
            f"(cluster has {list(server_ids)})"
        )
    for spec in byzantine.values():
        make_strategy(spec)


class ByzantineReplica(MochiReplica):
    """A real replica whose batch seams route through an
    :class:`AttackStrategy`.  Everything else — boot, sessions, verifier,
    snapshotting, drain — is the honest runtime, so the adversary is
    indistinguishable from an honest replica until it chooses not to be."""

    def __init__(self, *args, strategy="honest", strategy_seed: int = 0, **kwargs):
        super().__init__(*args, **kwargs)
        self.strategy = make_strategy(strategy, seed=strategy_seed)
        self.strategy.bind(self)
        self._attack_task: Optional[asyncio.Task] = None

    async def start(self) -> None:
        await super().start()
        LOG.warning(
            "replica %s is BYZANTINE (strategy=%s) — test harness only",
            self.server_id, self.strategy.name,
        )
        if type(self.strategy).run is not AttackStrategy.run:
            self._attack_task = asyncio.ensure_future(self.strategy.run())

    async def close(self) -> None:
        if self._attack_task is not None:
            self._attack_task.cancel()
            try:
                await self._attack_task
            except asyncio.CancelledError:
                pass  # the cancellation we just requested
            except Exception:
                pass
            self._attack_task = None
        await super().close()

    # ---------------------------------------------------------- batch seams

    def _corrupt(self, env: Envelope, response: Optional[Envelope]) -> Optional[Envelope]:
        """Route one honest response through the strategy; a changed
        payload is re-authenticated in kind (MAC or signature) with the
        replica's real credentials via ``_respond``."""
        if response is None:
            return None
        try:
            mutated = self.strategy.mutate(env, response.payload)
        except Exception:
            LOG.exception("byzantine strategy %s failed; answering honestly",
                          self.strategy.name)
            return response
        if mutated is None:
            return None
        if mutated is response.payload:
            return response
        self.metrics.mark("byzantine.mutated-responses")
        return self._respond(env, mutated)

    def handle_inline_batch(self, envs: "Sequence[Envelope]") -> "List[Optional[Envelope]]":
        out: List[Optional[Envelope]] = [None] * len(envs)
        idx = [i for i, env in enumerate(envs) if self.strategy.wants(env)]
        self.metrics.mark("byzantine.dropped-requests", len(envs) - len(idx))
        if idx:
            for i, resp in zip(idx, super().handle_inline_batch([envs[i] for i in idx])):
                out[i] = self._corrupt(envs[i], resp)
        return out

    async def handle_batch(self, envs: "Sequence[Envelope]") -> "List[Optional[Envelope]]":
        out: List[Optional[Envelope]] = [None] * len(envs)
        idx = [i for i, env in enumerate(envs) if self.strategy.wants(env)]
        self.metrics.mark("byzantine.dropped-requests", len(envs) - len(idx))
        if idx:
            responses = await super().handle_batch([envs[i] for i in idx])
            for i, resp in zip(idx, responses):
                out[i] = self._corrupt(envs[i], resp)
        return out
