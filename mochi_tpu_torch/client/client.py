"""Transaction-coordinating client (ref: ``client/MochiDBClient.java``).

The client is the only coordinator in the protocol (no server↔server links —
SURVEY.md §2.9): it fans requests to the replica set, tallies 2f+1 quorums
per operation, and assembles write certificates from signed MultiGrants.

Differences from the reference, all deliberate:

* every outbound envelope is Ed25519-signed by the client, and server
  response envelopes are signature-checked before counting toward any quorum
  (the reference has no message authentication at all);
* refused Write1s are retried with a fresh seed a bounded number of times
  before surfacing ``RequestRefused`` (the reference throws immediately,
  ``MochiDBClient.java:324-328``, pushing retry onto the application);
* responses are awaited with asyncio timeouts rather than 5 ms busy-poll
  loops (``Utils.java:65-93``).
"""

from __future__ import annotations

import asyncio
import logging
import os
import random
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..cluster.config import (
    CONFIG_CLIENT_PREFIX,
    CONFIG_CLUSTER_KEY,
    ClusterConfig,
    ServerInfo,
    config_archive_key,
    config_client_key,
)
from ..crypto import session as session_crypto
from ..crypto.keys import KeyPair, generate_keypair, verify as cpu_verify
from ..net.transport import RpcClientPool, fan_out, new_msg_id
from ..protocol import (
    Envelope,
    FailType,
    MultiGrant,
    NudgeSyncToServer,
    Operation,
    Action,
    ReadFromServer,
    ReadToServer,
    RequestFailedFromServer,
    SessionAckFromServer,
    SessionCheckpointAckFromServer,
    SessionCheckpointToServer,
    SessionInitToServer,
    Status,
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
from ..obs import trace as obs_trace
from ..utils.metrics import Metrics
from .errors import InconsistentRead, InconsistentWrite, RequestRefused
from .txn import GrantAssembler, QuorumTally, TxnTrace
import time

LOG = logging.getLogger(__name__)

SEED_RANGE = 1000  # ref: MochiDBClient.java:262 — seed = rand.nextInt(1000)

# How long a client remembers an authenticated handshake refusal before
# trying that replica again (see MochiDBClient._session_refused).
SESSION_REFUSAL_TTL_S = 30.0

# How long a client remembers a handshake that FAILED (timeout, connect
# error, silent replica) before retrying it.  Shorter than the refusal TTL
# — failures are transient faults, refusals are policy — but without it a
# SILENT replica gates every fan-out behind a full handshake timeout
# serially before the fan-out even starts: the config-10 silent attack
# measured write p50 at ~2x the request timeout from exactly this.
SESSION_FAILURE_TTL_S = 10.0

# Consecutive fully-shed Write1 rounds before the client stops retrying and
# surfaces hard overload as a typed RequestRefused.  At moderate shed
# probabilities a spurious give-up is <1% (draws are per-attempt), while
# hard overload (p~0.9) still fails in ~1 s of backoff.
MAX_ALL_SHED_ROUNDS = 5

# Per-peer suspicion counters the client accrues on its tally paths
# (``suspect.<kind>.<sid>``; surfaced per peer on the ClientAdminServer
# fan-out table next to the transport's straggler evidence).  Advisory
# only: suspicion re-orders the trimmed read fan-out away from suspects —
# it never changes a quorum rule, so a smeared honest replica loses read
# traffic priority, never correctness.
SUSPECT_KINDS = (
    "no-response",      # fan-out leg timed out / errored at full wait
    "bad-grant",        # grant failed signature/hash/configstamp validation
    "grant-conflict",   # grant dropped from the timestamp-consistent subset
    "tally-outvoted",   # answer disagreed with the 2f+1 winning fingerprint
)

# A peer becomes a read-routing suspect past this score: a couple of
# outlier marks (an honest laggard mid-resync) must not exile a replica.
SUSPICION_THRESHOLD = 2

# Routing decisions look only at suspicion accrued within this window, so
# a replica that recovers (restart blip, transient partition) re-enters
# the trimmed-read rotation once its marks age out — the cumulative
# counters stay monotonic for observability, but routing must not hold a
# lifetime grudge.
SUSPICION_WINDOW_S = 60.0


@dataclass
class MochiDBClient:
    """Async client SDK ("MochiSDK", ``mochiDB.tex:96``)."""

    config: ClusterConfig
    client_id: str = field(default_factory=lambda: f"client-{uuid.uuid4()}")
    keypair: KeyPair = field(default_factory=generate_keypair)
    timeout_s: float = 10.0
    write_attempts: int = 16  # Write1 retry budget (seed collisions + refusals)
    refusal_retries: int = 8
    authenticate_servers: bool = True
    # Network conditioning (mochi_tpu_torch.netsim.NetSim): when set, every
    # connection this client opens applies the sim's directed-link
    # policies (label -> server and back).  netsim_label defaults to the
    # per-run uuid client_id — pass a stable label (VirtualCluster does:
    # "client-<i>") when run-over-run determinism matters.
    netsim: Optional[object] = None
    netsim_label: Optional[str] = None
    # Early-quorum fan-outs: every phase
    # returns the moment a signature/MAC-verified, consistent 2f+1
    # agreement exists — Write2 dispatches at the 2f+1st consistent grant,
    # commit acks return at the 2f+1st consistent answer, and the
    # stragglers drain in the background into per-replica histograms
    # (net/transport._drain_stragglers).  The final tallies still re-check
    # the full quorum conditions over whatever was returned, so this knob
    # trades NOTHING in safety; off = wait out the full replica set as
    # before (kill switch: MOCHI_EARLY_QUORUM=0).
    early_quorum: bool = field(
        default_factory=lambda: os.environ.get("MOCHI_EARLY_QUORUM", "1") != "0"
    )
    # Grant-content validation on the Write1 tally path (Byzantine round):
    # each arriving MultiGrant's Ed25519 signature is checked against the
    # issuer's configured key, and its OK grants must carry THIS
    # transaction's hash, BEFORE the grant can vote in the certificate
    # subset.  Without this, one in-set replica
    # returning a garbage-signed (or wrong-hash) grant inside a validly
    # authenticated envelope poisons the assembled certificate and every
    # replica rejects the Write2 — a measured liveness hole under the
    # forge-cert attack (benchmarks/config10_byzantine.py).  Costs one
    # host verify per grant (~0.2 ms native-C), overlapped with the
    # fan-out's network wait.  Kill switch: MOCHI_VERIFY_GRANT_SIGS=0.
    verify_grant_sigs: bool = field(
        default_factory=lambda: os.environ.get("MOCHI_VERIFY_GRANT_SIGS", "1") != "0"
    )
    # Deterministic client-side randomness (scenario engine):
    # when set, the SDK's RNG — Write1 subEpoch seed draws, shed/refusal
    # backoff jitter — is random.Random(rng_seed) instead of OS entropy,
    # so the same seed replays the same draw sequence.  The scenario
    # engine (testing/scenario.py) derives one per client from the
    # scenario seed; production callers leave it None (per-process
    # entropy: correlated backoff jitter across a fleet would herd).
    rng_seed: Optional[int] = None
    # First-attempt Write1 fan-out trimmed to a quorum (2f+1) instead of the
    # full replica set; retries widen to the full set.  Off by default: it
    # saves f requests per write but measured SLOWER on the single-core
    # loopback bench (the skipped replica's grant was free parallelism
    # there; ~35% of config-1 throughput lost to retry widening, pure-
    # python round).  The trimmed targets now come from the suspicion-
    # steered _quorum_targets: against an UNRESPONSIVE in-set
    # replica the trim no longer wastes a timeout per fan-out once
    # suspicion converges — the A/B under the silent adversary
    # (benchmarks/results_r12.json "trim_write1_ab") measures that
    # scenario; the honest-loopback loss stands, so the default stays
    # False — measure per deployment.
    trim_write1: bool = False
    # Round-18 fast path (crypto/session.py): MAC'd envelopes get signed
    # checkpoint declarations every CHECKPOINT_MSGS/CHECKPOINT_MS, and
    # arriving MultiGrants from unsuspected MAC-session peers defer their
    # Ed25519 check to the replicas' certificate verify (audited
    # synchronously on any BAD_CERTIFICATE commit answer).  None = the
    # MOCHI_FAST_PATH env knob; resolved to a bool in __post_init__.
    fast_path: Optional[bool] = None

    def __post_init__(self) -> None:
        self.fast_path = session_crypto.fast_path_enabled(self.fast_path)
        self.pool = RpcClientPool(
            default_timeout_s=self.timeout_s,
            netsim=self.netsim,
            local_label=self.netsim_label or self.client_id,
        )
        self.metrics = Metrics()
        # Causal tracing (obs/trace.py): contexts mint per
        # transaction via client/txn.TxnTrace; sampled contexts ride every
        # envelope this client sends.  Off (MOCHI_TRACE* unset) the tracer
        # never mints and every trace site is one None test.
        self.tracer = obs_trace.Tracer(
            f"client:{self.netsim_label or self.client_id[:20]}"
        )
        self._rand = (
            random.Random(self.rng_seed)
            if self.rng_seed is not None
            else random.Random()
        )
        # server_id -> session MAC key; Ed25519 envelope signing is the
        # fallback (and the handshake carrier) — crypto/session.py.
        self._sessions: Dict[str, bytes] = {}
        self._session_locks: Dict[str, asyncio.Lock] = {}
        # sid -> sender-side checkpoint window (fast path): digests of
        # every MAC'd envelope sent, declared under an Ed25519 signature
        # each window so the receiver can convict MAC-window tampering
        # retroactively (crypto/session.SessionWindow).
        self._windows: Dict[str, session_crypto.SessionWindow] = {}
        # sid -> monotonic deadline: servers that sent an AUTHENTICATED
        # BAD_SIGNATURE handshake refusal (secure posture, identity not in
        # that replica's registry).  Skip re-handshaking until the deadline
        # — a TTL, because the refusal can be transient (replica restarted
        # and not yet resynced the registry; registration committed after
        # our first contact) and nothing bumps the configstamp in those
        # cases.  Also cleared outright on config refresh.
        self._session_refused: Dict[str, float] = {}
        self._read_rotor = 0
        # sid -> timestamped suspicion events (the decaying routing score;
        # the monotonic suspect.* counters are the observability record)
        self._suspicion_events: Dict[str, deque] = {}
        # sid -> last straggler-timeout counter value folded into events
        self._straggler_seen: Dict[str, int] = {}

    # ------------------------------------------------------------ plumbing

    def _targets(self, transaction: Transaction) -> List[Tuple[str, ServerInfo]]:
        """Union of the replica sets of all keys (ref: ``MochiDBClient.java:120-125``)."""
        seen: Dict[str, ServerInfo] = {}
        for key in transaction.keys:
            for info in self.config.servers_for_key(key):
                seen[info.server_id] = info
        return sorted(seen.items())

    def _suspect(self, sid: str, kind: str) -> None:
        """Accrue one unit of per-peer suspicion (``SUSPECT_KINDS``):
        a monotonic counter for the admin surfaces plus a timestamped
        event for the decaying routing score."""
        self.metrics.mark(f"suspect.{kind}.{sid}")
        self._suspicion_events.setdefault(sid, deque(maxlen=4096)).append(
            time.monotonic()
        )
        # Always-sample upgrade: a suspicion mark is exactly the evidence a
        # trace exists for — record it even when the head verdict was skip.
        ctx = obs_trace.current_ctx()
        if ctx is not None:
            self.tracer.force_mark(
                "client.suspect", ctx, args={"kind": kind, "peer": sid}
            )

    def _suspicion_score(self, sid: str) -> int:
        """Misbehavior evidence against ``sid`` within the last
        ``SUSPICION_WINDOW_S``: tally-path suspicion marks plus the
        transport's straggler-timeout growth (the silent-replica signal,
        folded in by counter delta since the counters themselves carry no
        timestamps).  Windowed so a recovered replica re-enters the read
        rotation instead of being exiled for the client's lifetime."""
        now = time.monotonic()
        events = self._suspicion_events.setdefault(sid, deque(maxlen=4096))
        stragglers = self.metrics.counters.get(
            f"fanout.straggler-timeout.{sid}", 0
        )
        seen = self._straggler_seen.get(sid, 0)
        if stragglers > seen:
            events.extend([now] * (stragglers - seen))
            self._straggler_seen[sid] = stragglers
        cutoff = now - SUSPICION_WINDOW_S
        while events and events[0] < cutoff:
            events.popleft()
        return len(events)

    def fastpath_stats(self) -> Dict[str, object]:
        """Fast-path posture from the initiator side: per-peer
        checkpoint windows plus the deferred-grant and audit counters
        (ClientAdminServer surface)."""
        return {
            "fast_path": self.fast_path,
            "windows": {
                sid: {"pending": len(w.pending), "window": w.window,
                      "sent": w.sent}
                for sid, w in self._windows.items()
            },
            "checkpoints": self.metrics.counters.get("client.checkpoints", 0),
            "grant_verifies_deferred": self.metrics.counters.get(
                "client.grant-verify-deferred", 0
            ),
            "cert_audits": self.metrics.counters.get("client.cert-audits", 0),
            "cert_audit_convictions": self.metrics.counters.get(
                "client.cert-audit-convictions", 0
            ),
        }

    def suspicion_stats(self) -> Dict[str, Dict[str, int]]:
        """Per-peer suspicion breakdown (ClientAdminServer surface)."""
        out: Dict[str, Dict[str, int]] = {}
        for kind in SUSPECT_KINDS:
            prefix = f"suspect.{kind}."
            for name, n in self.metrics.counters.items():
                if name.startswith(prefix):
                    out.setdefault(name[len(prefix):], {})[kind] = n
        return out

    def _quorum_targets(self, transaction: Transaction) -> List[Tuple[str, ServerInfo]]:
        """A minimal read fan-out: greedily cover every key's replica set
        with exactly ``quorum`` members (rotating the start point to spread
        load).  Reads only need 2f+1 matching answers, so fanning to all
        3f+1 replicas sends f extra requests per key that the tally then
        ignores — the reference always fans to the full union
        (``MochiDBClient.java:120-125``); the paper's own read bound is even
        lower (f+1, ``mochiDB.tex:142``).  A trimmed read can fail
        spuriously (a chosen replica lagging a just-committed write), so
        :meth:`_read_once` falls back to the full union before giving up.

        Suspicion-aware: peers whose suspicion score exceeds
        ``SUSPICION_THRESHOLD`` (straggler timeouts, outvoted answers,
        bad grants) are chosen only when the quorum cannot be covered
        without them — a silent or lying replica stops costing every
        trimmed read a timeout + full-union retry after its first few
        offenses.  Purely a liveness routing hint: the tally rules are
        unchanged, and the full-union fallback still reaches everyone.
        """
        q = self.config.quorum
        chosen: Dict[str, ServerInfo] = {}
        self._read_rotor += 1
        for key in transaction.keys:
            rset = self.config.servers_for_key(key)
            have = sum(1 for info in rset if info.server_id in chosen)
            if have >= q:
                continue
            n = len(rset)
            start = self._read_rotor % n
            order = sorted(
                range(n),
                key=lambda off: (
                    self._suspicion_score(
                        rset[(start + off) % n].server_id
                    ) > SUSPICION_THRESHOLD,
                    off,
                ),
            )
            for off in order:
                if have >= q:
                    break
                info = rset[(start + off) % n]
                if info.server_id not in chosen:
                    chosen[info.server_id] = info
                    have += 1
        return sorted(chosen.items())

    @staticmethod
    def _is_admin_txn(transaction: Transaction) -> bool:
        return any(
            op.key.startswith(CONFIG_CLUSTER_KEY)
            or op.key.startswith(CONFIG_CLIENT_PREFIX)
            for op in transaction.operations
        )

    async def register_client_key(self, client_id: str, public_key: bytes) -> None:
        """Admin: durably register a client's Ed25519 key so replicas with
        ``require_client_auth`` accept it (``_CONFIG_CLIENT_<id>``)."""
        if len(public_key) != 32:
            raise ValueError("Ed25519 public key must be 32 bytes")
        await self.execute_write_transaction(
            Transaction(
                (Operation(Action.WRITE, config_client_key(client_id), public_key),)
            )
        )

    @classmethod
    def _needs_signature(cls, payload) -> bool:
        """Admin (reconfiguration) requests must ride SIGNED envelopes: the
        replica's admin check proves key ownership via the signature, which
        an open-mode session MAC cannot (replica._admin_sig_ok)."""
        txn = getattr(payload, "transaction", None)
        return txn is not None and cls._is_admin_txn(txn)

    def _envelope(self, payload, msg_id: str, sid: Optional[str] = None) -> Envelope:
        # Timed per target: this is the client's per-envelope serialization
        # cost (payload encode — cached after the first target — plus the
        # MAC/sign), the "fan-out serialization" slice of the commit
        # breakdown (benchmarks/config6_bigcluster.py).
        with self.metrics.timer("envelope-encode-sign"):
            # Propagate the txn's trace context — SAMPLED traces
            # only, so unsampled traffic keeps the exact pre-trace wire
            # bytes and the native envelope-decode fast path on every hop.
            trace_field = None
            if self.tracer.enabled:
                ctx = obs_trace.current_ctx()
                if ctx is not None and ctx.sampled:
                    trace_field = ctx.to_wire()
            env = Envelope(
                payload=payload,
                msg_id=msg_id,
                sender_id=self.client_id,
                timestamp_ms=int(time.time() * 1000),
                trace=trace_field,
            )
            session_key = self._sessions.get(sid) if sid is not None else None
            if session_key is not None and not self._needs_signature(payload):
                sealed = session_crypto.seal(env, session_key)
                if self.fast_path:
                    # Transcript for the next signed checkpoint: every
                    # MAC'd envelope's canonical auth bytes get declared
                    # under an Ed25519 signature within one window.
                    self._windows.setdefault(
                        sid, session_crypto.SessionWindow()
                    ).note(sealed.signing_bytes())
                return sealed
            return env.with_signature(self.keypair.sign(env.signing_bytes()))

    def _authentic(self, sid: str, env: Envelope) -> bool:
        if not self.authenticate_servers:
            return True
        if env.mac is not None:
            session_key = self._sessions.get(sid)
            return (
                session_key is not None
                and env.sender_id == sid
                and session_crypto.mac_ok(session_key, env.signing_bytes(), env.mac)
            )
        key = self.config.public_keys.get(sid)
        if key is None:
            return True  # unsigned cluster (e.g. unsigned-mode tests)
        if env.signature is None or env.sender_id != sid:
            return False
        return cpu_verify(key, env.signing_bytes(), env.signature)

    @staticmethod
    def _server_signed(sid: str, server_key: bytes, env: Envelope) -> bool:
        """One definition of "this envelope is Ed25519-signed by sid" for
        both handshake checks (ack and typed refusal) — divergence here
        would let one path accept what the other rejects."""
        return (
            env.sender_id == sid
            and env.signature is not None
            and cpu_verify(server_key, env.signing_bytes(), env.signature)
        )

    async def _ensure_session(self, sid: str, info: ServerInfo) -> None:
        """Establish a MAC session with one server (no-op if present).

        Only servers with a configured public key get sessions — the
        Ed25519-signed ack is what rules out a MITM, so an unverifiable ack
        would be worthless; unknown-key servers stay on signed envelopes.
        """
        if sid in self._sessions or not self.authenticate_servers:
            return
        if self._session_refused.get(sid, 0.0) > time.monotonic():
            return
        server_key = self.config.public_keys.get(sid)
        if server_key is None:
            return
        lock = self._session_locks.setdefault(sid, asyncio.Lock())
        async with lock:
            # re-check BOTH outcomes under the lock: a concurrent caller may
            # have just established a session — or just been refused
            if sid in self._sessions:
                return
            if self._session_refused.get(sid, 0.0) > time.monotonic():
                return
            hs = session_crypto.new_handshake()
            env = self._envelope(  # signed (no session yet) — must be
                SessionInitToServer(hs.public_bytes, hs.nonce), new_msg_id()
            )
            try:
                res = await self.pool.send_and_receive(info, env, self.timeout_s)
            except asyncio.CancelledError:
                raise
            except Exception as exc:
                LOG.debug("session handshake with %s failed: %s", sid, exc)
                # Remember the failure (short TTL): an unresponsive replica
                # must not re-gate every subsequent fan-out behind a full
                # handshake timeout — signed envelopes work meanwhile.
                self.metrics.mark(f"client.handshake-failure.{sid}")
                self._session_refused[sid] = (
                    time.monotonic() + SESSION_FAILURE_TTL_S
                )
                return  # fall back to signed envelopes
            ack = res.payload
            # Re-read after the handshake round trip: a reconfiguration can
            # rotate sid's key while we were suspended, and the ack must
            # verify against the key the CURRENT config trusts — the
            # pre-await copy could accept a signature from a rotated-out
            # identity (found by analysis: await-races/stale-read).
            server_key = self.config.public_keys.get(sid)
            if server_key is None:
                return
            if isinstance(ack, RequestFailedFromServer) and self._server_signed(
                sid, server_key, res
            ):
                if ack.fail_type == FailType.OVERLOADED:
                    # Handshake-storm valve on the replica (admission
                    # control): honor the retry-after hint as a failure
                    # TTL and stay on signed envelopes meanwhile —
                    # re-knocking per request is exactly the storm the
                    # valve exists to stop.
                    self.metrics.mark(f"client.handshake-limited.{sid}")
                    wait_s = max(1.0, ack.retry_after_ms / 1e3)
                    self._session_refused[sid] = time.monotonic() + min(
                        wait_s, SESSION_FAILURE_TTL_S
                    )
                    return
                # AUTHENTICATED typed refusal (refusals to a signed
                # handshake are themselves Ed25519-signed — _respond signs
                # in-kind), not a forged ack: in the secure posture a
                # replica rejects handshakes from identities it has no
                # registered key for (e.g. an admin known only via
                # config.admin_keys, or a replica outside the registry
                # entry's replica set).  Expected — remember and stay on
                # signatures (re-handshaking per request would add a signed
                # RPC to every fan-out).  An UNSIGNED refusal falls through
                # to the forged-ack WARNING below: suppressing sessions must
                # cost an attacker a valid server signature.
                if ack.fail_type == FailType.BAD_REQUEST:
                    # Policy refusal (replica evict_client ban book):
                    # an expected steady state like identity-unknown —
                    # cache it, or every sessionless fan-out re-knocks,
                    # paying a signed RPC per request and draining the
                    # replica's GLOBAL handshake rate bucket that honest
                    # clients' session setup shares.
                    LOG.info(
                        "%s refused session handshake (policy); staying "
                        "on signatures for %gs", sid, SESSION_REFUSAL_TTL_S,
                    )
                    self._session_refused[sid] = (
                        time.monotonic() + SESSION_REFUSAL_TTL_S
                    )
                    return
                if ack.fail_type != FailType.BAD_SIGNATURE:
                    # Anything else is unexpected — log and retry on the
                    # next request.
                    LOG.warning(
                        "%s refused session handshake (%s); staying on signatures",
                        sid,
                        ack.fail_type.name,
                    )
                    return
                LOG.debug(
                    "%s refused session handshake (BAD_SIGNATURE: identity "
                    "not registered there); staying on signatures for %gs",
                    sid,
                    SESSION_REFUSAL_TTL_S,
                )
                self._session_refused[sid] = time.monotonic() + SESSION_REFUSAL_TTL_S
                return
            if not isinstance(ack, SessionAckFromServer) or not self._server_signed(
                sid, server_key, res
            ):
                LOG.warning("invalid session ack from %s; staying on signatures", sid)
                return
            self._sessions[sid] = session_crypto.derive_key(
                hs,
                ack.x25519_public,
                ack.nonce,
                initiator_id=self.client_id,
                responder_id=sid,
                initiated=True,
            )
            # Fresh session, fresh transcript: the replica's checkpoint
            # ledger reset on this handshake too (replica._session_init).
            self._windows.pop(sid, None)

    async def _checkpoint(self, sid: str, info: ServerInfo) -> None:
        """Send one signed checkpoint declaration for ``sid``'s MAC window
        (crypto/session.py design note).  Best-effort: a lost or refused
        checkpoint keeps its digests pending for the next attempt (the
        window's ``take`` never clears speculatively), and a typed refusal
        tears the session down — the next fan-out re-handshakes with a
        clean transcript on both sides."""
        win = self._windows.get(sid)
        if win is None or not win.pending:
            return
        window, digests = win.take()
        ticket = win  # the handle the taken digests belong to
        # sid=None: checkpoints are ALWAYS Ed25519-signed — a MAC'd
        # declaration could be forged by whoever holds the session key,
        # which is exactly the adversary the checkpoint convicts.
        env = self._envelope(
            SessionCheckpointToServer(window, digests), new_msg_id()
        )
        try:
            res = await self.pool.send_and_receive(
                info, env, min(self.timeout_s, 5.0)
            )
        except asyncio.CancelledError:
            raise
        except Exception:
            self.metrics.mark(f"client.checkpoint-lost.{sid}")
            return  # re-declared on the next due() window
        ack = res.payload
        # Re-read after the await: a concurrent teardown/re-handshake may
        # have replaced the window, and the fresh one owns a NEW transcript
        # — retiring these digests against it would corrupt it.
        win = self._windows.get(sid)
        if win is None or win is not ticket:
            return
        if isinstance(
            ack, SessionCheckpointAckFromServer
        ) and self._authentic(sid, res):
            win.committed(len(digests))
            self.metrics.mark("client.checkpoints")
            return
        # Refusal (overdue policy, carry overflow, or — convicted on the
        # replica — a transcript mismatch): drop the session and window;
        # traffic falls back to signed envelopes until the lazy
        # re-handshake.
        self.metrics.mark(f"client.checkpoint-refused.{sid}")
        self._sessions.pop(sid, None)
        self._windows.pop(sid, None)

    async def _fan_out(
        self,
        transaction: Transaction,
        payload_factory,
        _retry: bool = True,
        targets: Optional[List[Tuple[str, ServerInfo]]] = None,
        arrived: Optional[Callable[[str, object], bool]] = None,
    ) -> Dict[str, object]:
        """Fan a payload to the replica set; keep only authentic responses.

        ``arrived`` (early-quorum path): a payload-level predicate called
        per response AS IT LANDS — behind an authenticity gate, so only
        MAC/signature-verified payloads can vote.  When it returns True the
        fan-out returns immediately with the responses so far; transport
        drains the stragglers in the background.  Verification therefore
        runs verify-as-arrived, overlapping the remaining targets' network
        wait, instead of verify-at-tally after the slowest replica.
        """
        if targets is None:
            targets = self._targets(transaction)
        now = time.monotonic()
        missing = [
            t
            for t in targets
            if t[0] not in self._sessions
            and self._session_refused.get(t[0], 0.0) <= now
        ]
        if missing:  # skip coroutine+gather setup on the steady-state path
            await asyncio.gather(
                *(self._ensure_session(sid, info) for sid, info in missing)
            )
        if self.fast_path:
            # Due checkpoint windows flush BEFORE the fan-out (concurrent
            # across peers, off the per-request path the rest of the time):
            # past the receiver's overdue cap MAC'd requests get typed
            # refusals, so the declaration must stay ahead of the traffic.
            due = [
                (sid, info)
                for sid, info in targets
                if (w := self._windows.get(sid)) is not None
                and (w.due() or w.overdue_risk())
            ]
            if due:
                await asyncio.gather(
                    *(self._checkpoint(sid, info) for sid, info in due)
                )
        quorum_done = None
        # sids the predicate already authenticated this fan-out — the
        # post-filter below skips re-verifying those (the second HMAC —
        # or worse, a second uncached Ed25519 verify on session-less
        # envelopes — would be pure waste on exactly the hot path this
        # predicate exists to shorten).
        auth_ok: set = set()
        if arrived is not None and self.early_quorum:
            def quorum_done(sid: str, res: object) -> bool:
                if not isinstance(res, Envelope) or not self._authentic(sid, res):
                    return False
                auth_ok.add(sid)
                return arrived(sid, res.payload)
        results = await fan_out(
            self.pool,
            targets,
            lambda msg_id, sid: self._envelope(payload_factory(), msg_id, sid),
            self.timeout_s,
            metrics=self.metrics,
            quorum_done=quorum_done,
            tracer=self.tracer,
        )
        out: Dict[str, object] = {}
        stale_sessions = []
        for sid, res in results.items():
            if isinstance(res, Exception):
                LOG.debug("no response from %s: %s", sid, res)
                # full-wait legs that died/timed out; early-quorum
                # stragglers accrue fanout.straggler-timeout.<sid> from
                # the background drain instead — both feed the same
                # per-peer suspicion score.
                self._suspect(sid, "no-response")
                continue
            if sid not in auth_ok and not self._authentic(sid, res):
                LOG.warning("dropping unauthenticated response claiming to be %s", sid)
                continue
            payload = res.payload
            if (
                isinstance(payload, RequestFailedFromServer)
                and sid in self._sessions
                and (
                    payload.fail_type == FailType.BAD_SIGNATURE
                    or (
                        payload.fail_type == FailType.BAD_REQUEST
                        and "checkpoint" in payload.detail
                    )
                )
            ):
                # Replica restarted and lost our session (MAC bounced) —
                # or refused further MAC traffic pending a signed
                # checkpoint it considers overdue (fast-path policy,
                # e.g. a replica restarted mid-window or this client has
                # checkpoints off): tear down and re-handshake fresh.
                stale_sessions.append(sid)
                continue
            out[sid] = payload
        if stale_sessions and _retry:
            for sid in stale_sessions:
                self._sessions.pop(sid, None)
                self._windows.pop(sid, None)
            # arrived=None on the stale-session retry: the caller's
            # tracker (QuorumTally/GrantAssembler) already holds votes
            # from THIS attempt's discarded responses, so reusing it
            # could fire the predicate before the retry's own responses
            # reach quorum — the authoritative tally would then raise on
            # a thin dict a full wait would have satisfied.  The retry
            # is rare (replica restarted mid-session); it just waits out
            # the full set.
            return await self._fan_out(
                transaction, payload_factory, _retry=False, targets=targets,
            )
        return out

    @staticmethod
    async def _backoff_sleep(delay_s: float) -> None:
        """Backoff sleeps ride the coalesced timer wheel: at front-end
        scale thousands of clients sit in shed backoff simultaneously, and
        a per-sleep TimerHandle would cost one loop wakeup each — the
        wheel batches a quantum's worth into one.  Jitter dwarfs the
        quantum, so coarseness is free here."""
        from ..net.transport import TIMEOUT_WHEEL_QUANTUM_S

        if TIMEOUT_WHEEL_QUANTUM_S > 0:
            from ..utils.wakeup import wheel_for_loop

            await wheel_for_loop(TIMEOUT_WHEEL_QUANTUM_S).sleep(delay_s)
        else:
            await asyncio.sleep(delay_s)

    async def close(self) -> None:
        await self.pool.close()

    # ---------------------------------------------------------------- reads

    async def execute_read_transaction(self, transaction: Transaction) -> TransactionResult:
        """1-round-trip read with per-op 2f+1 agreement
        (ref: ``executeReadTransactionBL``, ``MochiDBClient.java:114-181``).

        On quorum failure, a reconfiguration may have moved the keys off the
        replica set this client still targets — adopt the newer committed
        config if there is one and retry once.
        """
        # One trace context per TRANSACTION (not per attempt): retries and
        # recovery reads stay inside the same causal record (obs/trace.py).
        with TxnTrace(self.tracer, "txn.read") as tt:
            return await self._read_with_recovery(transaction, tt)

    async def _read_with_recovery(
        self, transaction: Transaction, tt: TxnTrace
    ) -> TransactionResult:
        try:
            try:
                return await self._read_once(transaction, trim=True, tt=tt)
            except InconsistentRead:
                # The quorum-sized fan-out can miss when a chosen replica
                # lags a fresh commit or times out — the full union is the
                # authoritative attempt.
                return await self._read_once(transaction, trim=False, tt=tt)
        except InconsistentRead as failure:
            if transaction.keys == (CONFIG_CLUSTER_KEY,):
                raise
            if await self.refresh_config():
                # A reconfiguration moved the keys (the old set answers
                # WRONG_SHARD, so responders can even be 0): retry against
                # the NEW replica set first — usually it answers outright.
                try:
                    return await self._read_once(transaction, trim=False, tt=tt)
                except InconsistentRead as exc:
                    # New members may still be syncing; fall through to the
                    # nudge+poll recovery with the post-refresh evidence.
                    failure = exc
            # Recovery is only attempted when the failure is a RECOVERABLE
            # split: a quorum of in-set replicas responded but disagreed —
            # e.g. replicas restarted without --resync-on-boot hold nothing
            # and outvote the survivors, or a reconfiguration added fresh
            # members still syncing.  With fewer responders the set is
            # simply down, and nudge+poll would only amplify outage load
            # (an app retry loop would multiply every failed read ~4x).
            if failure.responders < self.config.quorum:
                raise failure
            # The state is recoverable (paper's UptoSpeed): nudge the set
            # to resync, then poll with backoff — the nudge is acked before
            # the background sync worker finishes, so a single fixed sleep
            # would race it on loaded hosts or big key sets.
            await self._nudge_read_set(transaction)
            last: InconsistentRead = failure
            for delay in (0.15, 0.35, 0.8):
                await asyncio.sleep(delay)
                try:
                    return await self._read_once(transaction, trim=False, tt=tt)
                except InconsistentRead as exc:
                    last = exc
            raise last

    async def _nudge_read_set(self, transaction: Transaction) -> None:
        """Advisory resync hint to every replica of the transaction's keys
        (an up-to-date replica treats it as a cheap no-op)."""
        keys_by_sid: Dict[str, set] = {}
        for op in transaction.operations:
            for info in self.config.servers_for_key(op.key):
                keys_by_sid.setdefault(info.server_id, set()).add(op.key)
        await asyncio.gather(
            *(self._send_nudge(sid, keys) for sid, keys in keys_by_sid.items())
        )

    async def _read_once(
        self, transaction: Transaction, trim: bool = False,
        tt: Optional[TxnTrace] = None,
    ) -> TransactionResult:
        if tt is None:
            tt = TxnTrace(None, "txn.read")  # span-less (internal callers)
        with self.metrics.timer("read-transactions"):
            nonce = new_msg_id()
            with self.metrics.timer("read-transactions-step1-future-wait"), \
                    tt.stage("read-step1-wait"):
                # One shared payload for every target: the envelope layer
                # caches the payload's mcode bytes on the object, so the
                # n-way fan-out pays one payload-tree encode, not n
                # (messages.Envelope._six_bytes).
                read_payload = ReadToServer(self.client_id, transaction, nonce)
                # Early-quorum: stop waiting the moment every op has 2f+1
                # agreeing in-set answers (same vote rules as the tally
                # below, which stays authoritative over the returned dict).
                tally = QuorumTally(
                    [
                        set(self.config.replica_set_for_key(op.key))
                        for op in transaction.operations
                    ],
                    self.config.quorum,
                )

                def _read_fp(op_res):
                    if op_res.status == Status.WRONG_SHARD:
                        return None
                    return (bytes(op_res.value or b""), op_res.existed)

                def read_arrived(sid: str, payload: object) -> bool:
                    if (
                        not isinstance(payload, ReadFromServer)
                        or payload.nonce != nonce
                    ):
                        return False
                    return tally.add(sid, payload.result.operations, _read_fp)

                responses = await self._fan_out(
                    transaction,
                    lambda: read_payload,
                    targets=self._quorum_targets(transaction) if trim else None,
                    arrived=read_arrived,
                )
            reads = {
                sid: p
                for sid, p in responses.items()
                if isinstance(p, ReadFromServer) and p.nonce == nonce
            }
            n_ops = len(transaction.operations)
            final: List = []
            outvoted: set = set()
            for i in range(n_ops):
                # Coalesce per-op results, ignoring WRONG_SHARD fillers
                # (ref: MochiDBClient.java:148-175).  Only servers in the
                # op's replica set get a vote: the fault bound (≤ f faulty of
                # 3f+1) holds per set, so out-of-set responders — reached via
                # the multi-key fan-out union — must not tip the tally.
                rset = set(self.config.replica_set_for_key(transaction.operations[i].key))
                tallies: Dict[bytes, Tuple[int, object]] = {}
                votes: Dict[str, tuple] = {}
                for sid, p in reads.items():
                    if sid not in rset or i >= len(p.result.operations):
                        continue
                    op_res = p.result.operations[i]
                    if op_res.status == Status.WRONG_SHARD:
                        continue
                    fp = (bytes(op_res.value or b""), op_res.existed)
                    votes[sid] = fp
                    count, _ = tallies.get(fp, (0, None))
                    tallies[fp] = (count + 1, op_res)
                best = max(tallies.values(), key=lambda t: t[0], default=(0, None))
                if best[0] < self.config.quorum:
                    responders = sum(t[0] for t in tallies.values())
                    raise InconsistentRead(
                        f"op {i}: best agreement {best[0]} < quorum "
                        f"{self.config.quorum} ({responders} responders)",
                        responders=responders,
                    )
                # With a quorum established, dissenting in-set answers are
                # evidence (stale or lying replica) — at most once per txn.
                winning_fp = next(fp for fp, t in tallies.items() if t is best)
                outvoted.update(
                    sid for sid, fp in votes.items() if fp != winning_fp
                )
                final.append(best[1])
            for sid in outvoted:
                self._suspect(sid, "tally-outvoted")
            return TransactionResult(tuple(final))

    # -------------------------------------------------------- reconfiguration

    async def refresh_config(self) -> bool:
        """Pull the committed cluster config and adopt it if newer.

        The config document rides the same 2f+1 quorum read as any value
        (it was committed with a write certificate under the previous
        configuration), so adopting it extends — not bypasses — the trust
        chain.  Returns True if the config advanced.
        """
        txn = Transaction((Operation(Action.READ, CONFIG_CLUSTER_KEY),))
        try:
            result = await self.execute_read_transaction(txn)
        except asyncio.CancelledError:
            raise
        except Exception:
            return False
        value = result.operations[0].value
        if not value:
            return False
        try:
            new_cfg = ClusterConfig.from_json(bytes(value).decode())
        except Exception:
            LOG.exception("committed cluster config unparseable")
            return False
        if new_cfg.configstamp <= self.config.configstamp:
            return False
        self._session_refused.clear()  # membership/registry may have changed
        LOG.info(
            "client adopting cluster config cs=%d (was %d)",
            new_cfg.configstamp, self.config.configstamp,
        )
        self.config = new_cfg
        # Sessions with surviving servers stay valid; new servers handshake
        # lazily on first contact.
        return True

    async def reconfigure_cluster(self, new_config: ClusterConfig) -> None:
        """Admin entry point: commit a new membership document.

        Runs the paper's configuration-change protocol (mochiDB.tex:184-199)
        over the standard 2-phase write: all current servers grant (the
        _CONFIG_ keyspace is owned by every server), the certificate commits
        the document, and each replica's apply hook installs it live.
        """
        if new_config.configstamp <= self.config.configstamp:
            raise ValueError(
                f"new configstamp {new_config.configstamp} must exceed "
                f"current {self.config.configstamp}"
            )
        # One transaction commits the new membership AND two archives:
        # the superseded config under its stamp (historical-certificate
        # validation, store.config_for_stamp) and the NEW config under ITS
        # stamp — the forward catch-up rung: this entry's certificate is
        # stamped with the OLD configstamp, so a replica that only knows
        # config N can validate-and-install N+1, then N+2, ... in one
        # sorted resync sweep (no wedge after missing several reconfigs).
        new_blob = new_config.to_json().encode()
        txn = Transaction(
            (
                Operation(Action.WRITE, CONFIG_CLUSTER_KEY, new_blob),
                Operation(
                    Action.WRITE,
                    config_archive_key(self.config.configstamp),
                    self.config.to_json().encode(),
                ),
                Operation(
                    Action.WRITE, config_archive_key(new_config.configstamp), new_blob
                ),
            )
        )
        await self.execute_write_transaction(txn)
        self.config = new_config

    # --------------------------------------------------------------- writes

    def _grant_ok(self, mg: MultiGrant, txn_hash: bytes) -> bool:
        """Content validation for one arriving MultiGrant before it may
        vote in certificate assembly: the issuer's Ed25519 signature over
        the grant (envelope auth says who SENT it, not that the grant
        inside verifies — replicas will check each grant independently, so
        the client must too or a Byzantine in-set grant poisons the whole
        certificate), plus per-grant content sanity — OK grants must carry
        THIS transaction's hash.  Verdict is cached on the (frozen) grant
        object: the early-quorum predicate and the authoritative
        post-filter see the same instances."""
        cached = mg.__dict__.get("_grant_ok")
        if cached is not None:
            return cached
        ok = True
        key = self.config.public_keys.get(mg.server_id)
        # Crypto gated by the kill switch / unsigned-cluster posture; the
        # FREE content check below always runs — disabling it would
        # re-open the wrong-hash certificate-poisoning liveness hole the
        # kill switch has no reason to buy back.
        if key is not None and self.verify_grant_sigs and self.authenticate_servers:
            if mg.signature is None:
                ok = False
            elif (
                self.fast_path
                and mg.server_id in self._sessions
                and self._suspicion_score(mg.server_id) == 0
            ):
                # Verify-behind-commit: the grant arrived over
                # an authenticated MAC session from an UNSUSPECTED peer;
                # its Ed25519 check is deferred — every replica's own
                # certificate verify (the quorum-critical check) still
                # runs, and a BAD_CERTIFICATE commit answer triggers the
                # synchronous per-grant audit (_audit_certificate) that
                # attributes the poison and re-arms full verification via
                # the suspicion score.  A suspected or session-less peer
                # pays the signature check up front as before.
                self.metrics.mark("client.grant-verify-deferred")
            elif not cpu_verify(key, mg.signing_bytes(), mg.signature):
                ok = False
        if ok:
            # Content: OK grants must commit to THIS transaction's hash.
            # Deliberately NOT a configstamp equality check — a stale
            # client mid-reconfiguration legitimately receives grants
            # stamped newer than its own config (the refresh path adopts
            # it); configstamp games are caught by the replicas' own
            # mixed-stamp certificate rejection.
            for g in mg.grants.values():
                if g.status == Status.OK and g.transaction_hash != txn_hash:
                    ok = False
                    break
        if not ok:
            self._suspect(mg.server_id, "bad-grant")
        mg.__dict__["_grant_ok"] = ok  # frozen dataclass: cache via __dict__
        return ok

    def _audit_certificate(
        self, certificate: WriteCertificate, txn_hash: bytes
    ) -> List[str]:
        """Synchronous audit of a certificate the replicas rejected
        (fast-path suspicion trigger): re-run the FULL Ed25519 + content
        check on every grant — including any whose check was deferred
        behind the MAC session — and attribute each failure to its signer
        with a suspicion mark and a flight-recorder dump.  Returns the
        convicted server ids; the retry loop then rebuilds from fresh
        grants, which the suspicion score forces through up-front
        verification."""
        bad: List[str] = []
        for mg in certificate.grants.values():
            key = self.config.public_keys.get(mg.server_id)
            sig_ok = key is None or (
                mg.signature is not None
                and cpu_verify(key, mg.signing_bytes(), mg.signature)
            )
            content_ok = all(
                g.transaction_hash == txn_hash
                for g in mg.grants.values()
                if g.status == Status.OK
            )
            if sig_ok and content_ok:
                continue
            bad.append(mg.server_id)
            mg.__dict__["_grant_ok"] = False
            self._suspect(mg.server_id, "bad-grant")
            ctx = obs_trace.current_ctx()
            attach = {
                "kind": "audit-bad-grant",
                "peer": mg.server_id,
                "signature_ok": sig_ok,
                "content_ok": content_ok,
            }
            self.tracer.force_mark("client.audit", ctx, args=attach)
            try:
                self.tracer.dump_flight("audit-bad-grant", attach)
            except OSError:
                LOG.exception("flight-recorder dump failed for audit")
        self.metrics.mark("client.cert-audits")
        if bad:
            self.metrics.mark("client.cert-audit-convictions", len(bad))
        return bad

    @staticmethod
    def _write1_transaction(transaction: Transaction) -> Transaction:
        """Value-less WRITE ops for every operation — grants are value-blind
        (ref: ``MochiDBClient.java:256-261``)."""
        return Transaction(
            tuple(Operation(Action.WRITE, op.key, None) for op in transaction.operations)
        )

    def _quorum_grant_subset(
        self, transaction: Transaction, oks: Sequence[MultiGrant]
    ) -> Optional[List[MultiGrant]]:
        """Largest timestamp-consistent MultiGrant subset with per-key quorum.

        The reference demands *unanimous* timestamps across every responder
        and retries otherwise (``isUniformTimeStampInMultiGrants``,
        ``MochiDBClient.java:195-219,310-318``) — which lets a single
        Byzantine or lagging replica stall all writes.  Instead: per key,
        take the majority timestamp among that key's replica set; drop any
        MultiGrant conflicting with a winning timestamp; accept if the
        surviving grants still cover every key with >= 2f+1 distinct in-set
        servers.  Returns None when no such subset exists (caller retries).
        """
        replica_sets = {
            op.key: set(self.config.replica_set_for_key(op.key))
            for op in transaction.operations
        }
        winning: Dict[str, int] = {}
        for key, rset in replica_sets.items():
            counts: Dict[int, int] = {}
            for mg in oks:
                grant = mg.grants.get(key)
                if grant is not None and grant.status == Status.OK and mg.server_id in rset:
                    counts[grant.timestamp] = counts.get(grant.timestamp, 0) + 1
            if not counts:
                return None
            winning[key] = max(counts.items(), key=lambda kv: kv[1])[0]
        chosen = [
            mg
            for mg in oks
            if all(
                g.timestamp == winning[key]
                for key, g in mg.grants.items()
                if key in winning and g.status == Status.OK
            )
        ]
        # Re-check coverage on the survivors (dropping a conflicted MultiGrant
        # removes all its keys' votes at once).
        for key, rset in replica_sets.items():
            voters = {
                mg.server_id
                for mg in chosen
                if mg.server_id in rset
                and (g := mg.grants.get(key)) is not None
                and g.status == Status.OK
            }
            if len(voters) < self.config.quorum:
                return None
        return chosen

    def _trim_to_quorum_cover(
        self, transaction: Transaction, chosen: Sequence[MultiGrant]
    ) -> List[MultiGrant]:
        """Smallest MultiGrant subset still giving every key >= 2f+1 in-set
        votes.  Every grant in the certificate is signature-checked by every
        replica in the set, so each extra grant costs rf Ed25519 verifies
        cluster-wide; with rf=3f+1 > 2f+1 there is always at least one grant
        to shave.  If a trimmed-in signature turns out bad (Byzantine signer),
        the Write2 fails quorum and the client retry rebuilds from scratch —
        liveness degrades for that one transaction, safety never.
        """
        need: Dict[str, int] = {}
        rsets: Dict[str, set] = {}
        for op in transaction.operations:
            if op.key not in rsets:
                rsets[op.key] = set(self.config.replica_set_for_key(op.key))
                need[op.key] = self.config.quorum
        # Grants covering more still-needed keys first; ties broken by
        # server_id for determinism.
        kept: List[MultiGrant] = []
        remaining = sorted(chosen, key=lambda mg: mg.server_id)
        while any(n > 0 for n in need.values()):
            def gain(mg: MultiGrant) -> int:
                return sum(
                    1
                    for key, n in need.items()
                    if n > 0
                    and mg.server_id in rsets[key]
                    and (g := mg.grants.get(key)) is not None
                    and g.status == Status.OK
                )

            best = max(remaining, key=gain, default=None)
            if best is None or gain(best) == 0:
                return list(chosen)  # cover impossible to shrink; keep all
            remaining.remove(best)
            kept.append(best)
            for key in need:
                if (
                    best.server_id in rsets[key]
                    and (g := best.grants.get(key)) is not None
                    and g.status == Status.OK
                ):
                    need[key] -= 1
        return kept

    async def execute_write_transaction(self, transaction: Transaction) -> TransactionResult:
        """2-phase write: Write1 grant acquisition → Write2 certificate commit
        (ref: ``executeWriteTransactionBL``, ``MochiDBClient.java:237-387``)."""
        with self.metrics.timer("write-transactions"), \
                TxnTrace(self.tracer, "txn.write") as tt:
            txn_hash = transaction_hash(transaction)
            write1_txn = self._write1_transaction(transaction)
            refusals = 0
            all_shed_rounds = 0
            for attempt in range(self.write_attempts):
                seed = self._rand.randrange(SEED_RANGE)
                # Grants only need a timestamp-consistent 2f+1 subset, so the
                # first attempt asks exactly a quorum (same trim as the read
                # path; the reference always fans the full union,
                # ``MochiDBClient.java:237-263``).  Any shortfall — a slow,
                # refusing, or Byzantine member of the chosen quorum — falls
                # back to the full replica set on the retry below.  Write2
                # still commits to the FULL set: every replica must apply,
                # and its certificate is self-certifying (2f+1 signatures)
                # even at a replica that issued no grant itself.
                w1_payload = Write1ToServer(
                    self.client_id, write1_txn, seed, txn_hash
                )
                # Pipelined Write1 -> Write2: the assembler folds each
                # authenticated grant in AS IT ARRIVES and fires the moment
                # a timestamp-consistent per-key 2f+1 subset exists — the
                # fan-out then returns and Write2 dispatches immediately,
                # overlapping certificate assembly with the residual grant
                # arrivals (drained in the background).
                assembler = GrantAssembler(
                    lambda oks: self._quorum_grant_subset(transaction, oks)
                )

                def w1_arrived(sid: str, payload: object) -> bool:
                    return (
                        isinstance(payload, Write1OkFromServer)
                        and payload.multi_grant.server_id == sid
                        and self._grant_ok(payload.multi_grant, txn_hash)
                        and assembler.add(payload.multi_grant)
                    )

                with self.metrics.timer("write1-phase"), \
                        tt.stage("write1-phase"):
                    responses = await self._fan_out(
                        write1_txn,
                        lambda: w1_payload,
                        targets=(
                            self._quorum_targets(write1_txn)
                            if attempt == 0 and self.trim_write1
                            else None
                        ),
                        arrived=w1_arrived,
                    )
                oks: List[MultiGrant] = []
                for sid, p in responses.items():
                    if (
                        isinstance(p, Write1OkFromServer)
                        and p.multi_grant.server_id == sid
                        and self._grant_ok(p.multi_grant, txn_hash)
                    ):
                        oks.append(p.multi_grant)
                # Proceed as soon as a timestamp-consistent 2f+1 subset
                # exists; refusals/outliers from up to f servers (contention,
                # lag, Byzantine skew) must not block an honest quorum.
                # Recomputed here over the post-filter responses even when
                # the assembler fired (authoritative; the assembler is a
                # liveness signal — see client/txn.py).
                chosen = self._quorum_grant_subset(transaction, oks)
                if chosen is not None:
                    # Suspicion accounting: a validated grant that still
                    # fell out of the timestamp-consistent subset voted a
                    # conflicting timestamp (Byzantine skew, or an honest
                    # laggard pre-resync — the threshold absorbs those).
                    chosen_ids = {mg.server_id for mg in chosen}
                    for mg in oks:
                        if mg.server_id not in chosen_ids:
                            self._suspect(mg.server_id, "grant-conflict")
                if chosen is not None and not self._is_admin_txn(transaction):
                    # Admin (config/archive) certificates keep ALL grants: a
                    # fresh member bootstrapping years later must still find
                    # 2f+1 signers it can resolve even after some of the
                    # original signers were removed — the archive cert is
                    # the root of its historical trust chain.
                    chosen = self._trim_to_quorum_cover(transaction, chosen)
                if chosen is None:
                    shed = sum(
                        1
                        for p in responses.values()
                        if isinstance(p, RequestFailedFromServer)
                        and p.fail_type == FailType.OVERLOADED
                    )
                    # Per-client grant-quota refusals ride the
                    # same flow-control contract as sheds: typed, carry a
                    # retry-after hint, and resolve by backing off (the
                    # client's own earlier grants commit or age out) — but
                    # they are counted apart, per replica, because for an
                    # operator "my cluster is overloaded" and "this client
                    # is hoarding grants" are different diagnoses (the
                    # bounded escalation below says which one happened).
                    quota_refused = 0
                    for sid, p in responses.items():
                        if (
                            isinstance(p, RequestFailedFromServer)
                            and p.fail_type == FailType.QUOTA_EXCEEDED
                        ):
                            quota_refused += 1
                            self.metrics.mark("client.write1-quota")
                            self.metrics.mark(f"client.quota-refused.{sid}")
                    shed += quota_refused
                    if shed:
                        # Admission control turned us away — this is flow
                        # control, not refusal: exponential jittered backoff
                        # (the explicit retry-with-backoff contract of
                        # FailType.OVERLOADED), and it doesn't burn the
                        # refusal budget.  MAX_ALL_SHED_ROUNDS consecutive
                        # fully-shed rounds mean hard overload: surface it
                        # as a typed failure in bounded time instead of
                        # hammering an already-saturated cluster with
                        # retries (every retry is 2(rf) more messages the
                        # cluster must shed again).
                        self.metrics.mark("client.write1-shed")
                        if shed >= len(responses) and len(responses) > 0:
                            all_shed_rounds += 1
                            if all_shed_rounds >= MAX_ALL_SHED_ROUNDS:
                                if quota_refused == shed:
                                    # quota-only rounds: the cluster is
                                    # fine — THIS identity is over its
                                    # grant budget (hoarding, or wide
                                    # transactions piling up abandoned
                                    # grants); the overload runbook is
                                    # the wrong place to send anyone
                                    raise RequestRefused(
                                        "per-client grant quota exhausted: "
                                        f"write refused {all_shed_rounds}x "
                                        "(outstanding grants must commit "
                                        "or age out)"
                                    )
                                raise RequestRefused(
                                    "cluster overloaded: write shed by "
                                    f"admission control {all_shed_rounds}x"
                                )
                        else:
                            all_shed_rounds = 0
                        # Jittered exponential backoff, raised to the
                        # replicas' retry-after hint (their backlog-drain
                        # estimate) when one was sent: a shedding cluster
                        # sets the retry cadence, not the client's
                        # loopback-sized default.
                        delay = (
                            0.02 * (1 << min(attempt, 4))
                            * (0.5 + self._rand.random())
                        )
                        hint_ms = max(
                            (
                                p.retry_after_ms
                                for p in responses.values()
                                if isinstance(p, RequestFailedFromServer)
                                and p.fail_type
                                in (FailType.OVERLOADED, FailType.QUOTA_EXCEEDED)
                            ),
                            default=0,
                        )
                        if hint_ms > 0:
                            delay = max(
                                delay,
                                hint_ms / 1e3 * (0.75 + 0.5 * self._rand.random()),
                            )
                        await self._backoff_sleep(delay)
                        continue
                    all_shed_rounds = 0
                    # Seed collision with another in-flight transaction,
                    # missing responses, or split timestamps: back off and
                    # retry with a fresh seed
                    # (ref: MochiDBClient.java:310-328 — refusal aborted there).
                    refusals += 1
                    if refusals > self.refusal_retries:
                        raise RequestRefused(
                            f"write refused after {refusals} attempts "
                            f"({len(oks)} grants, quorum {self.config.quorum})"
                        )
                    # Timestamp splits usually mean some replicas lost state
                    # (restart: epochs back at 0).  Nudge the laggards to
                    # resync before retrying (paper's client-initiated
                    # UptoSpeed, mochiDB.tex:168-169).
                    await self._nudge_laggards(transaction, oks)
                    await asyncio.sleep(0.001 * (1 + attempt))
                    continue
                certificate = WriteCertificate({mg.server_id: mg for mg in chosen})
                try:
                    return await self._write2(transaction, certificate, tt)
                except InconsistentWrite as exc:
                    # A reconfiguration may have landed between our phases
                    # (replicas reject cross-config certificates).  Adopt
                    # the newer config if there is one and retry; otherwise:
                    # BAD_CERTIFICATE answers mean THIS certificate was the
                    # problem (a poisoned grant that slipped validation, or
                    # a replay race) — fresh grants can fix that, so burn a
                    # refusal-retry instead of surfacing a dead end.  Any
                    # other split is real and raises.
                    if exc.bad_certificate and self.fast_path:
                        # Audit-on-suspicion: a deferred grant
                        # check may have let the poison through — re-verify
                        # every grant NOW, attribute the signer, and let
                        # the suspicion score force the retry's grants
                        # through up-front verification.
                        self._audit_certificate(certificate, txn_hash)
                    if not await self.refresh_config() and not exc.bad_certificate:
                        raise
                    refusals += 1
                    if refusals > self.refusal_retries:
                        raise
                    continue
            raise RequestRefused(f"write did not converge in {self.write_attempts} attempts")

    async def _nudge_laggards(
        self, transaction: Transaction, oks: Sequence[MultiGrant]
    ) -> None:
        """Tell replicas whose grant timestamps trail the per-key maximum to
        pull state from their peers.  Advisory and best-effort: failures are
        ignored (the retry loop and the replicas' own validation carry the
        correctness burden)."""
        behind: Dict[str, set] = {}
        for op in transaction.operations:
            ts_by_server = {
                mg.server_id: g.timestamp
                for mg in oks
                if (g := mg.grants.get(op.key)) is not None and g.status == Status.OK
            }
            if len(ts_by_server) < 2:
                continue
            newest = max(ts_by_server.values())
            for sid, ts in ts_by_server.items():
                # An honest laggard's epoch (and thus grant ts) trails by
                # >= one epoch unit; same-epoch spread is just seed noise.
                if newest - ts >= SEED_RANGE:
                    behind.setdefault(sid, set()).add(op.key)
        if not behind:
            return
        await asyncio.gather(
            *(self._send_nudge(sid, keys) for sid, keys in behind.items())
        )

    async def _send_nudge(self, sid: str, keys: set) -> None:
        info = self.config.servers.get(sid)
        if info is None:
            return
        msg_id = new_msg_id()
        env = self._envelope(NudgeSyncToServer(tuple(sorted(keys))), msg_id)
        try:
            await self.pool.send_and_receive(info, env, timeout_s=2.0)
        except asyncio.CancelledError:
            raise
        except Exception:
            pass

    async def _write2(
        self, transaction: Transaction, certificate: WriteCertificate,
        tt: Optional[TxnTrace] = None,
    ) -> TransactionResult:
        if tt is None:
            tt = TxnTrace(None, "txn.write")  # span-less (internal callers)
        # Shared payload: at n=64 the 43-grant certificate is ~9.8 KB and
        # was re-encoded per target (96% of envelope encode cost in a
        # profile); the payload-level mcode cache makes this one encode.
        w2_payload = Write2ToServer(certificate, transaction)
        # Early-quorum commit: stop waiting at the 2f+1st consistent
        # verified answer per op (Write2 was still SENT to the full set —
        # every replica applies; only the client's wait is quorum-bound).
        # _tally_write2 below re-checks >= 2f+1 over the returned dict, so
        # a commit can never be accepted on fewer verified responses.
        tally = QuorumTally(
            [
                set(self.config.replica_set_for_key(op.key))
                for op in transaction.operations
            ],
            self.config.quorum,
        )

        def _w2_fp(op_res):
            if op_res.status == Status.WRONG_SHARD:
                return None
            return (bytes(op_res.value or b""), op_res.status)

        def w2_arrived(sid: str, payload: object) -> bool:
            if not isinstance(payload, Write2AnsFromServer):
                return False
            return tally.add(sid, payload.result.operations, _w2_fp)

        # Stage-timed for the commit breakdown (config-6): the fan-out wait
        # now spans send-to-all through the QUORUM point (stragglers drain
        # off the clock) — it CONTAINS each replica's verify wait + store
        # apply plus the wire/loop time; the tally is pure client CPU.
        with self.metrics.timer("write2-fanout-wait"), \
                tt.stage("write2-fanout-wait"):
            responses = await self._fan_out(
                transaction, lambda: w2_payload, arrived=w2_arrived
            )
        with self.metrics.timer("write2-tally"), tt.stage("write2-tally"):
            return self._tally_write2(transaction, responses)

    def _tally_write2(
        self, transaction: Transaction, responses: Dict[str, object]
    ) -> TransactionResult:
        n_ops = len(transaction.operations)
        final: List = []
        outvoted: set = set()
        for i in range(n_ops):
            # Per-op votes restricted to the key's replica set (same
            # out-of-set exclusion as the read path).
            rset = set(self.config.replica_set_for_key(transaction.operations[i].key))
            tallies: Dict[Tuple, Tuple[int, object]] = {}
            votes: Dict[str, Tuple] = {}
            for sid, p in responses.items():
                if sid not in rset or not isinstance(p, Write2AnsFromServer):
                    continue
                if i >= len(p.result.operations):
                    continue
                op_res = p.result.operations[i]
                if op_res.status == Status.WRONG_SHARD:
                    continue
                fp = (bytes(op_res.value or b""), op_res.status)
                votes[sid] = fp
                count, _ = tallies.get(fp, (0, None))
                tallies[fp] = (count + 1, op_res)
            best = max(tallies.values(), key=lambda t: t[0], default=(0, None))
            if best[0] < self.config.quorum:
                # ref: per-op 2f+1 tally (MochiDBClient.java:355-382).
                # Flag certificate rejections: those are retryable with
                # fresh grants (see execute_write_transaction).
                raise InconsistentWrite(
                    f"op {i}: best agreement {best[0]} < quorum {self.config.quorum}",
                    bad_certificate=any(
                        isinstance(p, RequestFailedFromServer)
                        and p.fail_type == FailType.BAD_CERTIFICATE
                        for p in responses.values()
                    ),
                )
            winning_fp = next(fp for fp, t in tallies.items() if t is best)
            outvoted.update(sid for sid, fp in votes.items() if fp != winning_fp)
            final.append(best[1])
        for sid in outvoted:
            self._suspect(sid, "tally-outvoted")
        return TransactionResult(tuple(final))
