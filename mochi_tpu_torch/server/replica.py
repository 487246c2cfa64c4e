"""Replica runtime: dispatch, message authentication, certificate verification.

Combines the reference's L4/L5 (``RequestHandlerDispatcher.java:44-61`` typed
dispatch; ``MochiServer.java`` runtime) with the new signature pipeline at
exactly the seam SURVEY.md §2.4 identifies: message ingress, *before* the
datastore.  Flow per inbound envelope:

1. authenticate the sender's envelope signature (servers' keys from the
   cluster config; clients' keys from a registry) via the
   ``SignatureVerifier`` SPI — forged envelopes get ``BAD_SIGNATURE``;
2. for Write2: verify every MultiGrant signature in the certificate (the
   2f+1 quorum-cert check, batched on the verifier — the hot path of
   BASELINE.json configs 3-4), dropping invalid grants *before* the
   datastore's quorum count;
3. dispatch to the datastore state machine;
4. sign MultiGrants we issue and the response envelope.
"""

from __future__ import annotations

import asyncio
import hmac
import logging
import random
import time
from dataclasses import replace
from typing import Dict, Iterable, List, Optional, Sequence

from ..cluster.config import (
    CONFIG_CLIENT_PREFIX,
    CONFIG_CLUSTER_KEY,
    SHARD_TOKENS,
    ClusterConfig,
    config_client_key,
)
from ..crypto import session as session_crypto
from ..crypto.keys import KeyPair, verify as crypto_verify
from ..net.transport import RpcClientPool, RpcServer, new_msg_id
from ..obs import trace as obs_trace
from ..protocol import (
    Envelope,
    FailType,
    HelloFromServer,
    HelloToServer,
    NudgeSyncToServer,
    ReadFromServer,
    ReadToServer,
    RequestFailedFromServer,
    SessionAckFromServer,
    SessionCheckpointAckFromServer,
    SessionCheckpointToServer,
    SessionInitToServer,
    Status,
    SyncAckFromServer,
    SyncDigestFromServer,
    SyncDigestRequestToServer,
    SyncEntriesFromServer,
    SyncRequestToServer,
    Write1OkFromServer,
    Write1RefusedFromServer,
    Write1ToServer,
    Write2ToServer,
    WriteCertificate,
)
from ..utils.metrics import Metrics
from ..verifier.spi import (
    CpuVerifier,
    SignatureVerifier,
    VerifyItem,
    aggregate_key,
)
from .admission import AdmissionController, SessionTable, TokenBucket
from .store import BadRequest, DataStore, QuotaExceeded

LOG = logging.getLogger(__name__)

# Equivocation ledger bound: how many (object, ts, configstamp, signer) ->
# txn-hash observations a replica remembers from VALIDLY SIGNED grants it
# verified.  A second validly-signed grant from the same signer for the
# same slot with a DIFFERENT hash is cryptographic proof of equivocation —
# the one Byzantine behavior signatures alone cannot prevent, only convict.
# FIFO-bounded: old slots age out (their epochs are long past the GC
# horizon anyway); an adversary churning the ledger only evicts evidence
# about ancient timestamps.
GRANT_LEDGER_MAX = 16384
# Distinct conflicting hashes remembered per slot: one conviction per
# distinct lie is plenty of evidence, and an adversary spraying many
# hashes at ONE slot must not grow a single entry (or its O(len) scan on
# the Write2 hot path) without bound.
GRANT_LEDGER_SLOT_MAX = 8

# Per-batch budget of certificate VerifyItems pooled OPTIMISTICALLY (i.e.
# for Write2 envelopes whose own auth verdict is still pending in the same
# round trip).  Within budget, a drained batch needs exactly one verifier
# round trip (one bitmap per batch); past it — only ever
# reached by large signed bursts or forged-Write2 floods — the overflow
# certificates wait for their auth verdicts and ride a second round trip,
# capping what an unauthenticated sender can spend of the verifier at ~1
# check per forged message (the pre-batch price).
OPTIMISTIC_CERT_ITEM_BUDGET = 256

# Flight-recorder dumps a replica writes per conviction REASON: the dump
# is a full-ring JSON write on the event loop, so a Byzantine client
# flooding forged certificates must buy bounded disk and bounded loop
# stalls — the first few dumps carry the causal evidence, the rest only
# bump the conviction counters/spans (same posture as InvariantChecker's
# per-run dump bound).
CONVICTION_DUMPS_MAX = 8

# Ban-book bound (evict_client): identities whose session handshakes this
# replica refuses after a policy eviction.  FIFO-bounded like every other
# per-client table — an adversary minting identities to churn the book can
# at worst amnesty the OLDEST ban, never grow replica memory.
CLIENT_BANS_MAX = 4096

# Checkpoint-ledger bound (crypto/session.CheckpointLedger): one
# receiver-side audit ledger per MAC session.  FIFO-bounded like the ban
# book; evicting a ledger only forfeits THIS replica's retroactive audit of
# that sender's current window (the session itself stays authenticated).
CKPT_LEDGERS_MAX = 4096


def _persistence():
    """Snapshot persistence (``server/persistence.py``), imported where a
    snapshot is loaded or written."""
    from . import persistence

    return persistence


class MochiReplica:
    """One BFT replica node (ref: ``MochiServer.java`` + handler set)."""

    def __init__(
        self,
        server_id: str,
        config: ClusterConfig,
        keypair: KeyPair,
        verifier: Optional[SignatureVerifier] = None,
        client_public_keys: Optional[Dict[str, bytes]] = None,
        require_client_auth: bool = False,
        host: str = "0.0.0.0",
        port: int = 8081,  # ref default port: MochiServer.java:33-34
        snapshot_path: Optional[str] = None,
        snapshot_interval_s: float = 0.0,
        admission: Optional[bool] = None,
        shed_lag_ms: Optional[float] = None,
        netsim=None,
        # Durable storage (mochi_tpu_torch/storage; docs/OPERATIONS.md
        # §4i): ``storage`` takes a ready StorageEngine; ``storage_dir``
        # builds a durable engine rooted at <dir>/<server_id> (WAL +
        # snapshots + verified crash recovery).  Neither -> MemoryStorage,
        # the reference's in-memory posture and the test-matrix default.
        # ``storage_engine`` picks which durable engine a storage_dir gets:
        # "wal" (default) or "paged" (docs/OPERATIONS.md §4l).
        storage=None,
        storage_dir: Optional[str] = None,
        storage_engine: Optional[str] = None,
        # Fast-path posture (crypto/session.py): None -> the
        # MOCHI_FAST_PATH env knob (default ON).  ON: MAC'd write
        # certificates verify as ONE memoized aggregate attestation,
        # replica->replica traffic rides MAC sessions, and checkpoint
        # ledgers audit every MAC window.  OFF: the earlier posture
        # (per-grant certificate checks, signed peer traffic) — the A/B
        # and rollback leg.  Liveness/latency-only either way: downgrade
        # attempts fail typed and convicted, never silently.
        fast_path: Optional[bool] = None,
    ):
        self.server_id = server_id
        self.config = config
        self.keypair = keypair
        self.verifier = verifier if verifier is not None else CpuVerifier()
        self.client_public_keys = client_public_keys if client_public_keys is not None else {}
        self.require_client_auth = require_client_auth
        self.store = DataStore(server_id, config)
        self.metrics = Metrics()
        # Causal tracing (obs/trace.py): spans for envelopes that
        # arrive carrying a head-sampled trace context, plus the conviction
        # flight recorder (bad-certificate / equivocation verdicts and the
        # SIGTERM drain dump the ring to MOCHI_TRACE_DIR).  Off by default:
        # with MOCHI_TRACE* unset the per-envelope cost is one `is None`.
        self.tracer = obs_trace.Tracer(f"replica:{server_id}")
        self._conviction_dumps: Dict[str, int] = {}
        # Storage SPI: the store stages durable events into the engine
        # synchronously; this replica awaits the engine's flush at the
        # batched-write2 seam (acks only after the log write) and runs
        # recovery at boot.  Safe to attach before recovery: the durable
        # engine's stage hooks no-op while it is replaying.
        if storage is None:
            from ..storage import build_storage

            storage = build_storage(
                storage_dir, server_id, metrics=self.metrics,
                engine=storage_engine,
            )
        elif getattr(storage, "metrics", None) is None:
            # an engine built before the replica existed (server boot path)
            # adopts this replica's registry for its fsync/snapshot evidence
            storage.metrics = self.metrics
        self.storage = storage
        self.store.storage = storage
        storage.store = self.store  # bg snapshot trigger needs the store
        # Batched hot path: the transport drains each scheduling tick's
        # frames (across all connections) into the two batch entry points —
        # MAC'd read/write1/hello synchronously, everything else through
        # one task whose signature checks share a single verifier round
        # trip (handle_batch).
        self.rpc = RpcServer(
            host,
            port,
            self.handle_envelope,
            inline_batch_handler=self.handle_inline_batch,
            batch_handler=self.handle_batch,
            metrics=self.metrics,
        )
        # Network conditioning (mochi_tpu_torch.netsim.NetSim or None): held for
        # the peer pool's link policies and the admin surfaces (/status
        # "netsim", /metrics.prom mochi_netsim gauges).
        self.netsim = netsim
        # server->server pool (state transfer); lazily connected
        self.peer_pool = RpcClientPool(netsim=netsim, local_label=server_id)
        self._sync_tasks: set = set()
        self._pending_sync_keys: set = set()
        self._sync_worker: Optional[asyncio.Task] = None
        self.snapshot_path = snapshot_path
        self.snapshot_interval_s = snapshot_interval_s
        self._snapshot_task: Optional[asyncio.Task] = None
        self._snapshot_write_fut: Optional[asyncio.Future] = None
        # sender_id -> session MAC key (crypto/session.py): envelope auth at
        # HMAC cost; Ed25519 reserved for MultiGrants.  Lost on restart —
        # clients re-handshake when their MAC'd request bounces.  Bounded
        # LRU + idle TTL (server/admission.SessionTable): at front-end
        # scale thousands of client sessions must cost bounded memory, and
        # an evicted client transparently re-handshakes.
        self._sessions = SessionTable()
        self.fast_path = session_crypto.fast_path_enabled(fast_path)
        # Receiver-side checkpoint audit ledgers, one per MAC session
        # (crypto/session.CheckpointLedger): the digest multiset of every
        # accepted MAC'd envelope, reconciled against the sender's periodic
        # SIGNED declaration — a MAC forgery or replay is convicted
        # retroactively with transferable evidence.
        self._ckpt_ledgers: Dict[str, session_crypto.CheckpointLedger] = {}
        # Initiator-side peer MAC sessions (replica->replica resync/digest
        # traffic): key + sender-side checkpoint window per peer, plus a
        # failure TTL so a refusing/overloaded peer keeps getting signed
        # envelopes instead of a handshake storm.
        self._peer_sessions: Dict[str, bytes] = {}
        self._peer_windows: Dict[str, session_crypto.SessionWindow] = {}
        self._peer_hs_retry_at: Dict[str, float] = {}
        self._peer_hs_locks: Dict[str, asyncio.Lock] = {}
        # Policy-evicted identities (evict_client): a banned sender's
        # re-handshake is refused, so "evicted" cannot silently mean
        # "re-admitted one round trip later".  Ordered dict as FIFO set;
        # signed-envelope traffic is deliberately NOT banned here —
        # refusing signed work is the disconnect policy this hook is the
        # seam for, not something to smuggle in.
        self._client_bans: Dict[str, None] = {}
        # signing_bytes -> signature for MultiGrants THIS replica issued at
        # write1: the write2 own-grant check becomes a compare instead of a
        # deterministic re-sign (~57 us saved per write2).  Bounded FIFO; a
        # miss (evicted, or issued before a restart) falls back to re-sign.
        self._own_grant_sigs: Dict[bytes, bytes] = {}
        # Byzantine-evidence ledger (docs/OPERATIONS.md §4f): the distinct
        # transaction hashes seen per (object, ts, configstamp, signer)
        # from validly-signed grants; each NEW conflicting hash convicts
        # the signer of one equivocation (counted per peer, surfaced on
        # /status "byzantine" and the mochi_byzantine prom family).
        self._grant_ledger: Dict[tuple, tuple] = {}
        self._equivocations: Dict[str, int] = {}
        # Admission control (overload shedding), ON by default: the
        # deterministic load signal in server/admission.py — dispatch
        # pressure, verify occupancy, send-queue pressure, all
        # event-counted — drives a shed probability; the replica sheds NEW
        # transactions (Write1 -> OVERLOADED + retry-after hint) while
        # still finishing admitted ones (Write2, reads), bounding the
        # service-time tail instead of collapsing under backlog.  The
        # reference has no admission control at all (its 2-thread pool
        # just queues, MochiServer.java:36-54).  ``shed_lag_ms`` is the
        # retired wall-clock signal's knob, kept as an on/off alias
        # (0 = off) for older call sites.
        if admission is None:
            admission = shed_lag_ms is None or shed_lag_ms > 0
        self._admission = AdmissionController(self.rpc, enabled=admission)
        self._handshakes = TokenBucket()
        self._sweep_countdown = 1024
        # Reconfiguration (paper mochiDB.tex:184-199): a committed write to
        # CONFIG_CLUSTER_KEY installs the new membership live.
        self.store.on_config_value = self._install_config
        # Registry rotation/revocation invalidates the client's live MAC
        # session — the next envelope re-authenticates against the new key.
        self.store.on_client_key_change = lambda cid: self._drop_session(cid)

    # ----------------------------------------------------------------- boot

    async def start(self) -> None:
        # Comb-first default: the cluster's replica identities are known
        # signers, so every verifier composition gets them at boot (the SPI
        # routes the registration to whatever layer can use it — the device
        # comb registry, the host fallback's window tables — and silently
        # no-ops elsewhere).  Best-effort by design: a failed registration
        # leaves that traffic on the general ladder, never unverified.
        self._register_config_signers(self.config)
        if self.snapshot_path:
            persistence = _persistence()

            def _load():
                return persistence.load_snapshot(self.store, self.snapshot_path)

            n = await asyncio.get_running_loop().run_in_executor(None, _load)
            if n:
                self.metrics.mark("replica.snapshot-loaded", n)
            # A snapshot may hold a newer committed membership than the boot
            # config file — install it before serving.
            sv = self.store._get(CONFIG_CLUSTER_KEY)
            if sv is not None and sv.exists and sv.value:
                self._install_config(sv.value)
        # Durable-storage recovery BEFORE the socket opens: replay the
        # snapshot + WAL through the verified path (every certificate's
        # grants re-verify on this replica's own batch verifier — a
        # tampered log is convicted, never served).  Config installs fire
        # through the store's apply hook exactly as live traffic does.
        report = await self.storage.recover(
            self.store, verifier=self.verifier, metrics=self.metrics
        )
        if report.get("entries") or report.get("convicted"):
            LOG.info(
                "storage recovery for %s: %s entries replayed, %s convicted "
                "(%s ms)",
                self.server_id, report.get("entries"),
                report.get("convicted"), report.get("ms"),
            )
        await self.storage.start()
        await self.rpc.start()
        if self.snapshot_interval_s > 0 and (
            self.snapshot_path or self.storage.name in ("durable", "paged")
        ):
            self._snapshot_task = asyncio.ensure_future(self._snapshot_loop())

    @staticmethod
    def _shed_draw(payload) -> float:
        """Deterministic admission draw in [0,1) keyed on (client, seed).

        Every replica computes the SAME draw, so at shed probability p the
        cluster sheds the same p-fraction of transactions everywhere —
        independent per-replica coin flips would make the 2f+1 grant quorum
        succeed with probability ~(1-p)^(2f+1) and collapse goodput in a
        retry storm (measured: 4x worse than no shedding at 1.8x overload).
        The seed is client-chosen, so a Byzantine client can bias its own
        draws — admission control is a performance mechanism, not a
        security boundary; fairness under attack would need the (signed)
        client id rate-limited per sender, which the session layer already
        identifies.  A retry picks a fresh seed, i.e. a fresh draw.
        """
        import zlib

        h = zlib.crc32(f"{payload.client_id}:{payload.seed}".encode())
        return (h & 0xFFFFFFFF) / 4294967296.0

    @property
    def _shed_p(self) -> float:
        return self._admission.shed_p

    @_shed_p.setter
    def _shed_p(self, p: float) -> None:
        # Test seam (and the old attribute's name): assigning pins the
        # controller at exactly that probability; assign None via
        # ``self._admission.pin(None)`` to unfreeze.
        self._admission.pin(p)

    def overload_stats(self) -> Dict[str, object]:
        """The /status "overload" surface (admin/http.py): controller
        state, transport load signal, bounded-table sizes."""
        was = self._admission.overloaded
        self._admission.update()
        if self._admission.overloaded and not was:
            self.metrics.mark("replica.overload-entered")
        st = self._admission.stats()
        # full send-queue total incl. the transports' own write buffers
        # (O(connections) — admin freshness, not the hot-path signal)
        st["sendq_total_bytes"] = self.rpc.send_queue_bytes()
        st["sessions"] = self._sessions.stats()
        st["handshake_refused"] = self._handshakes.refused
        st["write1_shed"] = self.metrics.counters.get("replica.write1-shed", 0)
        return st

    async def _snapshot_loop(self) -> None:
        persistence = _persistence()

        while True:
            await asyncio.sleep(self.snapshot_interval_s)
            if self.storage.name in ("durable", "paged"):
                try:
                    # the engine snapshots + truncates its own WAL (and
                    # also self-triggers on log growth); the legacy
                    # snapshot_path mechanism below stays for callers
                    # without a storage engine
                    await self.storage.snapshot(self.store)
                except asyncio.CancelledError:
                    raise
                except Exception:
                    LOG.exception("storage snapshot failed")
                if not self.snapshot_path:
                    continue
            try:
                # Serialize ON the event loop (the store mutates only there —
                # snapshotting from a thread would race dict iteration and
                # could tear a StoreValue mid-_apply); only the fsync'd file
                # write goes to the executor.
                blob = persistence.snapshot_bytes(self.store)
                self._snapshot_write_fut = asyncio.get_running_loop().run_in_executor(
                    None, persistence.write_snapshot_blob, blob, self.snapshot_path
                )
                await self._snapshot_write_fut
                self.metrics.mark("replica.snapshots")
            except asyncio.CancelledError:
                raise  # close() cancelled us mid-write; the final snapshot follows
            except Exception:
                LOG.exception("periodic snapshot failed")

    async def drain(self, timeout_s: float = 5.0) -> None:
        """Graceful-shutdown drain (SIGTERM semantics): stop accepting new
        connections, let admitted work finish and its coalesced response
        writes flush, bounded by ``timeout_s``.  Callers follow with
        :meth:`close` — which then finds no in-flight batches to cancel,
        so the final snapshot captures every transaction the replica
        acknowledged.  The process harness (``testing/process_cluster.py``)
        relies on this for deterministic teardown: TERM → drain → close →
        exit 0, never a mid-batch abort."""
        await self.rpc.quiesce(timeout_s)
        if self.tracer.flight_dir:
            # Crash/drain flight dump: the span ring survives
            # the process on disk, so cross-process trace merges work even
            # though the replica is about to exit (tools/trace.py).
            try:
                await asyncio.get_running_loop().run_in_executor(
                    None,
                    self.tracer.dump_flight,
                    "drain",
                    {"server_id": self.server_id},
                )
            except asyncio.CancelledError:
                raise
            except Exception:
                LOG.exception("drain flight dump failed")

    async def close(self) -> None:
        if self._snapshot_task is not None:
            # Await the cancelled loop AND any in-flight executor write: an
            # unawaited periodic os.replace could otherwise land AFTER the
            # final snapshot below, clobbering the freshest state.
            self._snapshot_task.cancel()
            try:
                await self._snapshot_task
            except asyncio.CancelledError:
                pass  # the cancellation we just requested
            except Exception:
                pass
            fut = self._snapshot_write_fut
            if fut is not None and not fut.done():
                try:
                    await fut
                except asyncio.CancelledError:
                    raise
                except Exception:
                    pass
        for task in list(self._sync_tasks):
            task.cancel()
        if self.snapshot_path:
            persistence = _persistence()

            try:
                persistence.write_snapshot(self.store, self.snapshot_path)
            except Exception:
                LOG.exception("final snapshot failed")
        await self.peer_pool.close()
        await self.rpc.close()
        # After the socket is down nothing new can stage: final flush +
        # snapshot + log truncation, so the next boot replays a short tail.
        try:
            await self.storage.close(self.store)
        except asyncio.CancelledError:
            raise
        except Exception:
            LOG.exception("storage close failed")

    @property
    def bound_port(self) -> int:
        return self.rpc.bound_port

    # -------------------------------------------------------- reconfiguration

    def _install_config(self, blob: bytes) -> None:
        """Adopt a committed cluster config (called from the datastore's
        apply hook and at boot).  The blob earned a 2f+1 write certificate
        under the previous configuration, so its authenticity rides the same
        quorum trust as any committed value — no extra signature needed.

        Completes the paper's declared configuration-change protocol
        (``mochiDB.tex:184-199``; ``Grant.configstamp``,
        ``MochiProtocol.proto:110``; ``clusterConfigurationstamp``,
        ``ClusterConfiguration.java:41`` — all vestigial in the reference).
        The paper's bespoke config1/config2 rounds (write blocking + ack
        majority) are subsumed by the standard Write1/Write2 path: the
        config write carries a real certificate, and configstamp gating in
        ``DataStore._coalesce_grants`` replaces the paper's per-message CS
        equality check.
        """
        try:
            new_cfg = ClusterConfig.from_json(
                blob.decode() if isinstance(blob, (bytes, bytearray)) else blob
            )
        except Exception:
            LOG.exception("committed cluster config is unparseable; ignoring")
            return
        if new_cfg.configstamp <= self.config.configstamp:
            return  # stale or duplicate install
        old = self.config
        self.config = new_cfg
        self.store.config = new_cfg
        # Keep both in the history: certificates formed under either stamp
        # remain checkable (store.config_for_stamp).
        self.store.note_config(old)
        self.store.note_config(new_cfg)
        added = sorted(set(new_cfg.servers) - set(old.servers))
        removed = sorted(set(old.servers) - set(new_cfg.servers))
        LOG.info(
            "installed cluster config cs=%d (was %d): +%s -%s",
            new_cfg.configstamp, old.configstamp, added, removed,
        )
        self.metrics.mark("replica.config-installs")
        # Re-register the FULL membership's identities with the verifier's
        # known-signer machinery (comb fast path, crypto/comb.py) —
        # registration is idempotent, and the full set also repairs any
        # identity a pre-boot snapshot install raced past.  Without this
        # the new members' grant certificates still verify — just on the
        # general ladder — so the call is best-effort by design.
        if added or removed:
            self._register_config_signers(new_cfg)
        if self.server_id not in new_cfg.servers:
            LOG.warning(
                "this server is not a member of config cs=%d — retired "
                "(serving WRONG_SHARD until decommissioned)",
                new_cfg.configstamp,
            )
        elif added or removed:
            # Membership changed: token ownership moved — pull newly-owned
            # keys from peers in the background.
            self._pending_sync_keys.add("*")
            self._kick_sync_worker()

    def _register_config_signers(self, cfg: ClusterConfig) -> None:
        """Hand the membership's public keys to the verifier's known-signer
        registration (SPI ``register_signers``); best-effort, idempotent."""
        reg = getattr(self.verifier, "register_signers", None)
        if not callable(reg):
            return
        try:
            if reg(list(cfg.public_keys.values())):
                self.metrics.mark("replica.signers-registered", len(cfg.public_keys))
        except Exception:
            LOG.exception("known-signer registration failed")

    # ------------------------------------------------------------- envelopes

    def _sender_key(self, sender_id: str) -> Optional[bytes]:
        key = self.config.public_keys.get(sender_id)
        if key is None:
            key = self.client_public_keys.get(sender_id)
        if key is None:
            # durable registry: _CONFIG_CLIENT_<id> committed via the
            # (admin-gated) config keyspace
            sv = self.store.data_config.get(config_client_key(sender_id))
            if sv is not None and sv.exists and isinstance(sv.value, (bytes, bytearray)):
                if len(sv.value) == 32:
                    key = bytes(sv.value)
        return key

    def _auth_mac(self, env: Envelope) -> bool:
        """Session-MAC envelope authentication (synchronous HMAC)."""
        session_key = self._sessions.get(env.sender_id)
        if session_key is None:
            return False
        with self.metrics.timer("replica.crypto-local"):
            ok = session_crypto.mac_ok(session_key, env.signing_bytes(), env.mac)
        if not ok:
            # A bad MAC on an ESTABLISHED session is tamper-or-spoof
            # evidence (an honest client without the session key sends
            # signed envelopes; the only benign cause is a re-handshake
            # race on a stale key): record the conviction mark alongside
            # the typed BAD_SIGNATURE the caller answers.  force_mark is a
            # ring append and the flight dump is bounded per kind, so a
            # tamper flood buys counters, not attacker-priced disk.
            self.metrics.mark("replica.mac-tamper")
            self._convict("mac-tamper", env, {"payload": type(env.payload).__name__})
        return ok

    def _drop_session(self, sender_id: str) -> None:
        """Forget a MAC session AND its checkpoint ledger together — a
        fresh handshake must always start with a fresh audit window."""
        self._sessions.pop(sender_id, None)
        self._ckpt_ledgers.pop(sender_id, None)

    def _note_mac_accepted(self, env: Envelope) -> bool:
        """Record one accepted MAC'd envelope in the sender's checkpoint
        ledger.  False = the sender is past the overdue cap —
        it has ridden the MAC discount for OVERDUE_FACTOR windows without
        ever signing for them — so the session is dropped and the caller
        answers a typed refusal (BAD_REQUEST, not BAD_SIGNATURE: policy,
        not forgery; the client re-handshakes and re-sends)."""
        if not self.fast_path:
            return True
        led = self._ckpt_ledgers.get(env.sender_id)
        if led is None:
            if len(self._ckpt_ledgers) >= CKPT_LEDGERS_MAX:
                self._ckpt_ledgers.pop(next(iter(self._ckpt_ledgers)))
            led = session_crypto.CheckpointLedger()
            self._ckpt_ledgers[env.sender_id] = led
        if led.note(env.signing_bytes()):
            return True
        self.metrics.mark("replica.checkpoint-overdue")
        self._drop_session(env.sender_id)
        return False

    _OVERDUE_DETAIL = (
        "session checkpoint overdue: too many MAC'd envelopes without a "
        "signed transcript declaration; re-establish the session"
    )

    @staticmethod
    def _is_admin_op(payload) -> bool:
        txn = getattr(payload, "transaction", None)
        return txn is not None and any(
            op.key.startswith(CONFIG_CLUSTER_KEY)
            or op.key.startswith(CONFIG_CLIENT_PREFIX)
            for op in txn.operations
        )

    def _admin_sig_ok(self, env: Envelope) -> bool:
        """Authorization for _CONFIG_CLUSTER* writes (paper: "client with
        admin privilege", mochiDB.tex:191).  Self-contained: the envelope
        must be Ed25519-SIGNED by one of ``config.admin_keys`` — verified
        directly against those keys, so an admin needs no entry in any
        client registry, and a session MAC can never qualify (open-mode
        sessions don't prove key ownership)."""
        if env.signature is None or env.mac is not None:
            return False
        signing = env.signing_bytes()
        with self.metrics.timer("replica.crypto-local"):
            return any(
                crypto_verify(ak, signing, env.signature)
                for ak in self.config.admin_keys
            )

    def _respond(self, env: Envelope, payload, force_sign: bool = False) -> Envelope:
        response = Envelope(
            payload=payload,
            msg_id=new_msg_id(),
            sender_id=self.server_id,
            reply_to=env.msg_id,
            timestamp_ms=int(time.time() * 1000),
        )
        # Respond IN KIND: MAC only when the request itself was MAC'd.  A
        # half-established session (our ack was lost; the client stayed on
        # signatures) must not make us MAC responses the client cannot
        # check — it would drop them as unauthenticated and this replica
        # would silently stop counting toward quorums.
        session_key = None
        if not force_sign and env.mac is not None:
            session_key = self._sessions.get(env.sender_id)
        # "replica.crypto-local" accumulates every SYNCHRONOUS crypto
        # operation this replica performs on its own CPU (session MACs,
        # envelope/grant Ed25519 signs, admin verifies) — the numerator of
        # BASELINE.json's "<5% replica CPU in crypto" target.  Certificate
        # and client-signature checks ride the verifier SPI (TPU service)
        # and cost this process only codec+HMAC, which IS counted.
        if session_key is not None:
            with self.metrics.timer("replica.crypto-local"):
                return session_crypto.seal(response, session_key)
        with self.metrics.timer("replica.crypto-local"):
            return response.with_signature(self.keypair.sign(response.signing_bytes()))

    async def handle_envelope(self, env: Envelope) -> Optional[Envelope]:
        """Single-envelope adapter over the batch pipeline (tests, foreign
        transports).  MAC'd inline types stay await-free end-to-end, so the
        transport's synchronous fast-path contract still holds."""
        if env.mac is not None and isinstance(env.payload, RpcServer.INLINE_TYPES):
            return self.handle_inline_batch([env])[0]
        return (await self.handle_batch([env]))[0]

    # ------------------------------------------------------ batched dispatch

    def handle_inline_batch(
        self, envs: "Sequence[Envelope]"
    ) -> "List[Optional[Envelope]]":
        """Synchronous half of the drain: MAC'd reads/write1s/hellos of one
        scheduling tick, authenticated (HMAC) and dispatched together —
        write1 grant issuance enters the store once per batch
        (``DataStore.process_write1_batch``), zero tasks, zero awaits."""
        metrics = self.metrics
        metrics.histogram("replica.batch-occupancy").observe(len(envs))
        # Traced members of this drain batch (head-sampled envelopes only;
        # the replica records whenever the WIRE carries a context, whatever
        # its own MOCHI_TRACE posture — the client minted the decision).
        traced = [e for e in envs if e.trace is not None]
        t_wall0 = time.time() if traced else 0.0
        t_perf0 = time.perf_counter() if traced else 0.0
        out: List[Optional[Envelope]] = [None] * len(envs)
        w1_envs: List[Envelope] = []
        w1_idx: List[int] = []
        for i, env in enumerate(envs):
            payload = env.payload
            try:
                if not self._auth_mac(env):
                    metrics.mark("replica.bad-signature")
                    out[i] = self._respond(
                        env,
                        RequestFailedFromServer(
                            FailType.BAD_SIGNATURE, "envelope signature invalid"
                        ),
                    )
                elif not self._note_mac_accepted(env):
                    out[i] = self._respond(
                        env,
                        RequestFailedFromServer(
                            FailType.BAD_REQUEST, self._OVERDUE_DETAIL
                        ),
                    )
                elif isinstance(payload, Write1ToServer):
                    w1_idx.append(i)
                    w1_envs.append(env)
                elif isinstance(payload, ReadToServer):
                    with metrics.timer("replica.read"):
                        result = self.store.process_read(payload.transaction)
                    out[i] = self._respond(
                        env, ReadFromServer(result, payload.nonce, rid=new_msg_id())
                    )
                elif isinstance(payload, HelloToServer):
                    out[i] = self._respond(
                        env, HelloFromServer(f"{payload.message} back")
                    )
                else:  # transport classification keeps this unreachable; fail typed
                    out[i] = self._respond(
                        env,
                        RequestFailedFromServer(
                            FailType.OLD_REQUEST, "unhandled payload"
                        ),
                    )
            except Exception:
                # one envelope's processing bug fails alone — batchmates
                # (and their responses) are unaffected
                LOG.exception("inline dispatch failed for %s", type(payload).__name__)
        if w1_envs:
            # MAC'd envelopes can never carry a valid admin signature
            # (_admin_sig_ok rejects MACs outright), so admin_ok is False.
            for i, response in zip(
                w1_idx, self._handle_write1_batch(w1_envs, [False] * len(w1_envs))
            ):
                out[i] = response
        if traced:
            dur = time.perf_counter() - t_perf0
            for env in traced:
                self._record_handle_span(
                    "replica.handle_inline_batch", env, t_wall0, t_perf0, dur,
                    len(envs),
                )
        return out

    def _record_handle_span(
        self,
        name: str,
        env: Envelope,
        t_wall0: float,
        t_perf0: float,
        dur_s: float,
        batch: int,
        extra: Optional[Dict] = None,
    ) -> None:
        """One replica-side span for a traced envelope's trip through a
        drain batch: queue/drain wait (ingress stamp → batch start) plus
        the handling duration, parented under the client's stage span.
        Name/args stay constant/lazy per the span-lazy-label rule."""
        ctx = obs_trace.TraceContext.from_wire(env.trace)
        if ctx is None or not ctx.sampled:
            return
        args: Dict = {"type": type(env.payload).__name__, "batch": batch}
        rx = env.__dict__.get("_rx_perf")
        if rx is not None:
            args["queue_us"] = round((t_perf0 - rx) * 1e6, 1)
        if extra:
            args.update(extra)
        self.tracer.record(name, ctx, t_wall0, dur_s, args=args)

    async def handle_batch(
        self, envs: "Sequence[Envelope]"
    ) -> "List[Optional[Envelope]]":
        """Async-half entry point: pins each MAC'd sender's session for the
        batch's lifetime (the table's LRU eviction must never drop a
        session between an envelope's auth check and its response seal —
        the batch spans verifier awaits where a handshake burst could
        otherwise evict it), then runs the real pipeline."""
        sessions = self._sessions
        pinned = [env.sender_id for env in envs if env.mac is not None]
        for s in pinned:
            sessions.pin(s)
        try:
            return await self._handle_batch_pipeline(envs)
        finally:
            for s in pinned:
                sessions.unpin(s)

    async def _handle_batch_pipeline(
        self, envs: "Sequence[Envelope]"
    ) -> "List[Optional[Envelope]]":
        """Async half of the drain: everything that may need real signature
        work.  Envelope-auth checks AND Write2 certificate checks for the
        whole batch ride ONE ``verify_batch`` round trip (single bitmap,
        sliced back per envelope) — the amortization the north-star
        batch-verifier seam exists for — plus an overflow-only second
        round trip for certificates past the optimistic budget
        (``OPTIMISTIC_CERT_ITEM_BUDGET``).  A forged envelope or bad grant
        fails alone: its slice of the bitmap condemns it, its batchmates'
        slices stand (typed dispatch ref: RequestHandlerDispatcher.java:44-61).
        """
        metrics = self.metrics
        metrics.histogram("replica.batch-occupancy").observe(len(envs))
        n = len(envs)
        out: List[Optional[Envelope]] = [None] * n
        # Traced (head-sampled) members of this batch — the verify round
        # trip below is SHARED across the batch, so each traced member gets
        # charged its slice (items, duration share, unique-vs-memoized) on
        # its own span: the live verifies/txn meter (obs/trace.py).
        traced = [(i, e) for i, e in enumerate(envs) if e.trace is not None]
        t_wall0 = time.time() if traced else 0.0
        t_perf0 = time.perf_counter() if traced else 0.0
        verify_dur_s = 0.0
        verify_total_items = 0
        verify_unique = 0
        verify_memoized = 0

        # Stage 1 (sync): envelope-auth triage.  MACs check inline; signed
        # envelopes contribute one VerifyItem each.  A valid admin
        # signature IS authentication (and stronger).
        AUTH_OK, AUTH_FAIL, AUTH_PENDING, AUTH_OVERDUE = 0, 1, 2, 3
        auth = [AUTH_OK] * n
        admin_ok = [False] * n
        auth_pos = [-1] * n
        # dead = this envelope's processing raised (malformed payload deep
        # enough to survive decode but break auth/cert prep): it gets NO
        # response — the old per-task blast radius — and, crucially, its
        # batchmates are untouched.
        dead = [False] * n
        items: List[VerifyItem] = []
        for i, env in enumerate(envs):
            payload = env.payload
            try:
                if (
                    bool(self.config.admin_keys)
                    and self._is_admin_op(payload)
                    and self._admin_sig_ok(env)
                ):
                    admin_ok[i] = True
                    continue
                if env.mac is not None:
                    if not self._auth_mac(env):
                        auth[i] = AUTH_FAIL
                    elif not self._note_mac_accepted(env):
                        auth[i] = AUTH_OVERDUE
                    continue
                key = self._sender_key(env.sender_id)
                if key is None:
                    # Unknown sender: only acceptable in open (non-auth) mode.
                    if self.require_client_auth:
                        auth[i] = AUTH_FAIL
                    continue
                if env.signature is None:
                    # Known identity but stripped signature: always an
                    # impersonation attempt — reject regardless of auth mode.
                    auth[i] = AUTH_FAIL
                    continue
                auth[i] = AUTH_PENDING
                auth_pos[i] = len(items)
                items.append(VerifyItem(key, env.signing_bytes(), env.signature))
            except Exception:
                LOG.exception("auth triage failed for %s", type(payload).__name__)
                dead[i] = True

        # Stage 2 (sync): Write2 certificate preparation.  Optimistically
        # included for pending-auth envelopes too — the grants verify in
        # the same round trip (one bitmap per batch) and
        # are simply discarded if the envelope itself turns out forged.
        # The forgery amplification this buys is bounded twice over:
        # fabricated signer ids resolve no key and contribute nothing, the
        # own-grant path never SIGNS for a pending-auth envelope
        # (defer_own), and the optimistic items of pending-auth envelopes
        # share a per-batch BUDGET — past it, their certificates wait for
        # the auth verdict and ride a second round trip (stage 4b), so a
        # forged-Write2 flood degrades to costing ~1 auth verify per
        # message (the pre-batch price) instead of 2f+2, while legitimate
        # signed bursts at worst pay one extra round trip.
        cert_prep: Dict[int, tuple] = {}
        deferred_cert: List[int] = []
        # Round-18 one-attestation path: MAC-authenticated Write2s whose
        # certificate can verify as a single memoized aggregate (index ->
        # (agg_key, items, server_ids)).  Resolved in stage 4c; a failed
        # aggregate falls back to the per-item attribution path.
        agg_w2: Dict[int, tuple] = {}
        optimistic_budget = OPTIMISTIC_CERT_ITEM_BUDGET
        # Admin-gate verdicts snapshotted BEFORE the await: self.config is
        # mutable (a reconfiguration can land mid-await), and dispatch must
        # agree with the prep decision taken here — re-reading admin_keys
        # after the await could otherwise skip BOTH the denial and the
        # (never-prepared) certificate path.
        w2_admin_denied: set = set()
        for i, env in enumerate(envs):
            if auth[i] in (AUTH_FAIL, AUTH_OVERDUE) or dead[i]:
                continue
            payload = env.payload
            if isinstance(payload, Write2ToServer):
                if (
                    self.config.admin_keys
                    and not admin_ok[i]
                    and self._is_admin_op(payload)
                ):
                    # Will be denied in dispatch (authorization, not auth):
                    # don't buy its certificate 2f+1 pooled verifies first —
                    # the old path denied before the cert check too.
                    w2_admin_denied.add(i)
                    continue
                if self.fast_path and env.mac is not None and auth[i] == AUTH_OK:
                    # MAC-authenticated sender, fast path ON: the whole
                    # 2f+1 grant set rides ONE verify_aggregate call,
                    # memoized cluster-wide by cert hash — the meter-moving
                    # change of the fast path.  Ineligible certificates
                    # (unresolvable signer, missing signature) need
                    # attribution anyway and stay on the per-item path.
                    agg = self._aggregate_items(payload.write_certificate)
                    if agg is not None:
                        agg_w2[i] = agg
                        continue
                if auth[i] == AUTH_PENDING and optimistic_budget <= 0:
                    deferred_cert.append(i)
                    continue
                try:
                    prep = self._prepare_certificate(
                        payload.write_certificate,
                        defer_own=auth[i] == AUTH_PENDING,
                    )
                except Exception:
                    # e.g. type-garbage configstamps poisoning the config
                    # lookup: THIS envelope dies; batchmates proceed
                    LOG.exception("certificate prep failed for %s", env.msg_id)
                    dead[i] = True
                    continue
                cert_prep[i] = (prep, len(items))
                items.extend(prep[2])
                if auth[i] == AUTH_PENDING:
                    optimistic_budget -= len(prep[2])

        # Stage 2b: launch the aggregate attestations as tasks so they
        # overlap stage 3's pooled round trip (on a memoized verifier the
        # common case resolves without any real crypto at all).
        agg_tasks: Dict[int, asyncio.Task] = {}
        if agg_w2:
            loop = asyncio.get_running_loop()
            for i, (akey, aitems, _sids) in agg_w2.items():
                agg_tasks[i] = loop.create_task(
                    self._verify_aggregate_counted(akey, aitems)
                )

        # Stage 3: the single verifier round trip for the whole batch.
        if items:
            metrics.histogram("replica.verify-occupancy").observe(len(items))
            with metrics.timer("replica.auth-verify"):
                if traced:  # snapshot only when someone gets charged
                    tv0 = time.perf_counter()
                    u0, m0 = self._verify_memo_counters()
                bitmap = await self._verify_counted(items)
                if traced:
                    verify_dur_s += time.perf_counter() - tv0
                    verify_total_items += len(items)
                    uniq, memo = self._verify_memo_delta(u0, m0, len(items))
                    verify_unique += uniq
                    verify_memoized += memo
        else:
            bitmap = []

        # Stage 4 (sync): resolve auth verdicts; forged envelopes answer
        # BAD_SIGNATURE and drop out of dispatch.
        for i, env in enumerate(envs):
            if dead[i]:
                continue
            if auth[i] == AUTH_PENDING:
                auth[i] = AUTH_OK if bitmap[auth_pos[i]] else AUTH_FAIL
            if auth[i] == AUTH_FAIL:
                metrics.mark("replica.bad-signature")
                if env.trace is not None:
                    # always-sample-on-error upgrade: an auth failure is
                    # evidence whatever the head verdict was
                    self.tracer.force_mark(
                        "replica.bad-signature",
                        obs_trace.TraceContext.from_wire(env.trace),
                        args={"sender": env.sender_id},
                    )
                out[i] = self._respond(
                    env,
                    RequestFailedFromServer(
                        FailType.BAD_SIGNATURE, "envelope signature invalid"
                    ),
                )
            elif auth[i] == AUTH_OVERDUE:
                # Authentic MAC, but the sender dodged its signed
                # checkpoint for OVERDUE_FACTOR windows: typed policy
                # refusal (session already dropped; the client
                # re-handshakes and re-sends).
                out[i] = self._respond(
                    env,
                    RequestFailedFromServer(
                        FailType.BAD_REQUEST, self._OVERDUE_DETAIL
                    ),
                )

        # Stage 4b (overflow only): certificates whose envelopes exhausted
        # the optimistic budget, now that their auth verdicts are known —
        # forged ones were already answered BAD_SIGNATURE above and never
        # reach this round trip.
        if deferred_cert:
            items2: List[VerifyItem] = []
            for i in deferred_cert:
                if dead[i] or out[i] is not None or auth[i] != AUTH_OK:
                    continue
                env = envs[i]
                try:
                    prep = self._prepare_certificate(env.payload.write_certificate)
                except Exception:
                    LOG.exception("certificate prep failed for %s", env.msg_id)
                    dead[i] = True
                    continue
                cert_prep[i] = (prep, len(items2), True)
                items2.extend(prep[2])
            if items2:
                metrics.histogram("replica.verify-occupancy").observe(len(items2))
                with metrics.timer("replica.auth-verify"):
                    if traced:
                        tv0 = time.perf_counter()
                        u0, m0 = self._verify_memo_counters()
                    bitmap2 = await self._verify_counted(items2)
                    if traced:
                        verify_dur_s += time.perf_counter() - tv0
                        verify_total_items += len(items2)
                        uniq, memo = self._verify_memo_delta(u0, m0, len(items2))
                        verify_unique += uniq
                        verify_memoized += memo
            else:
                bitmap2 = []
        else:
            bitmap2 = []

        # Materialize each certificate's verdict slice from whichever round
        # trip carried it, so dispatch needs no bitmap bookkeeping.
        for i, entry in list(cert_prep.items()):
            if len(entry) == 3:
                prep, start, _ = entry
                cert_prep[i] = (prep, bitmap2[start : start + len(prep[2])])
            else:
                prep, start = entry
                cert_prep[i] = (prep, bitmap[start : start + len(prep[2])])

        # Stage 4c: resolve the aggregate attestations.  A verified
        # aggregate synthesizes an all-valid prep (dispatch then reuses the
        # normal _finish_certificate path, including the equivocation
        # ledger); a failed one pays the AUDIT — a per-item round trip with
        # full attribution and the usual conviction machinery — so only
        # Byzantine-polluted certificates ever ride the slow path, and
        # never silently.
        if agg_tasks:
            audit_items: List[VerifyItem] = []
            audit_prep: Dict[int, tuple] = {}
            with metrics.timer("replica.auth-verify"):
                if traced:
                    tv0 = time.perf_counter()
                    u0, m0 = self._verify_memo_counters()
                for i, task in agg_tasks.items():
                    try:
                        ok = await task
                    except asyncio.CancelledError:
                        raise
                    except Exception:
                        LOG.exception("aggregate verify failed for %s", envs[i].msg_id)
                        ok = False
                    _akey, _aitems, sids = agg_w2[i]
                    if ok:
                        metrics.mark("replica.cert-agg-verified")
                        cert_prep[i] = ((sids, [True] * len(sids), [], []), [])
                    else:
                        metrics.mark("replica.cert-agg-audit")
                        try:
                            prep = self._prepare_certificate(
                                envs[i].payload.write_certificate
                            )
                        except Exception:
                            LOG.exception(
                                "certificate prep failed for %s", envs[i].msg_id
                            )
                            dead[i] = True
                            continue
                        audit_prep[i] = (prep, len(audit_items))
                        audit_items.extend(prep[2])
                if audit_items:
                    metrics.histogram("replica.verify-occupancy").observe(
                        len(audit_items)
                    )
                    bitmap3 = await self._verify_counted(audit_items)
                else:
                    bitmap3 = []
                if traced:
                    charged = len(agg_tasks) + len(audit_items)
                    verify_dur_s += time.perf_counter() - tv0
                    verify_total_items += charged
                    uniq, memo = self._verify_memo_delta(u0, m0, charged)
                    verify_unique += uniq
                    verify_memoized += memo
            for i, (prep, start) in audit_prep.items():
                cert_prep[i] = (prep, bitmap3[start : start + len(prep[2])])

        # Stage 5 (sync): typed dispatch; write1/write2 group into the
        # store's batch entry points.
        w1_envs: List[Envelope] = []
        w1_idx: List[int] = []
        w1_admin: List[bool] = []
        w2_envs: List[Envelope] = []
        w2_idx: List[int] = []
        w2_reqs: List[Write2ToServer] = []
        for i, env in enumerate(envs):
            if out[i] is not None or dead[i]:
                continue
            payload = env.payload
            try:
                out[i] = self._dispatch_one(
                    i, env, payload, admin_ok, cert_prep, w2_admin_denied,
                    w1_idx, w1_envs, w1_admin, w2_idx, w2_envs, w2_reqs,
                )
            except Exception:
                # one envelope's processing bug fails alone — batchmates
                # (and their responses) are unaffected
                LOG.exception("dispatch failed for %s", type(payload).__name__)
                out[i] = None

        if w1_envs:
            for i, response in zip(
                w1_idx, self._handle_write1_batch(w1_envs, w1_admin)
            ):
                out[i] = response
        w2_apply_dur = 0.0
        w2_apply_wall = 0.0
        wal_dur = 0.0
        wal_wall = 0.0
        if w2_reqs:
            w2_apply_wall = time.time()
            ta0 = time.perf_counter()
            with metrics.timer("replica.write2"):
                results = self.store.process_write2_batch(w2_reqs)
            w2_apply_dur = time.perf_counter() - ta0
            if self.storage.dirty:
                # Durability BEFORE acknowledgement: the batch's staged
                # commit records hit the log (to the engine's fsync-policy
                # level) before any Write2 answer is built — group commit
                # at exactly the batching seam, so one flush covers the
                # whole drained batch.  The no-storage default short-
                # circuits on ``dirty`` (False) with zero awaits.
                wal_wall = time.time()
                tw0 = time.perf_counter()
                with metrics.timer("replica.wal-flush"):
                    await self.storage.flush()
                wal_dur = time.perf_counter() - tw0
            for i, env, result in zip(w2_idx, w2_envs, results):
                if isinstance(result, Exception):
                    LOG.error("write2 failed for %s", env.msg_id, exc_info=result)
                    continue  # drop THIS response only; batchmates answer
                if (
                    isinstance(result, RequestFailedFromServer)
                    and result.fail_type == FailType.BAD_CERTIFICATE
                    and "configstamp ahead" not in result.detail
                ):
                    # Store-level certificate rejection (thin after grant
                    # drops, hash mismatch, replay): same conviction
                    # treatment as the signature-check failure above.
                    # "configstamp ahead" is excluded: that is THIS replica
                    # lagging a reconfiguration (an honest certificate it
                    # cannot check yet — the branch below kicks the sync
                    # worker), not evidence against the sender.
                    self._convict(
                        "bad-certificate", env, {"detail": result.detail[:200]}
                    )
                if (
                    isinstance(result, RequestFailedFromServer)
                    and "configstamp ahead" in result.detail
                ):
                    # The cluster reconfigured past us — catch up in the
                    # background (the client retries meanwhile).
                    self._pending_sync_keys.add(CONFIG_CLUSTER_KEY)
                    self._kick_sync_worker()
                out[i] = self._respond(env, result)
        if traced:
            self._record_batch_spans(
                envs, traced, auth_pos, cert_prep, set(w2_idx),
                t_wall0, t_perf0,
                verify_dur_s, verify_total_items, verify_unique,
                verify_memoized,
                w2_apply_wall, w2_apply_dur, len(w2_reqs),
                wal_wall, wal_dur, set(agg_tasks),
            )
        return out

    def _record_batch_spans(
        self, envs, traced, auth_pos, cert_prep, w2_applied,
        t_wall0, t_perf0,
        verify_dur_s, verify_total_items, verify_unique, verify_memoized,
        w2_apply_wall, w2_apply_dur, n_w2,
        wal_wall, wal_dur, agg_idx=frozenset(),
    ) -> None:
        """Slice this drain batch's SHARED costs back to its traced member
        transactions: the pooled ``verify_batch`` round trip is charged per
        envelope proportional to its VerifyItem count (with the caching
        layer's unique-vs-memoized split prorated the same way — the live
        verifies/txn meter), the store write2 apply and the group-commit
        WAL fsync are charged 1/n shares, and queue/drain wait rides the
        handle span (``_record_handle_span``)."""
        dur = time.perf_counter() - t_perf0
        for i, env in traced:
            k = (1 if auth_pos[i] >= 0 else 0)
            if i in agg_idx:
                # One-attestation path: the whole grant set was ONE
                # aggregate call — the meter's honest unit on the fast path
                # (the unique/memoized split still prorates from the
                # caching layer's real counters).
                k += 1
            prep_entry = cert_prep.get(i)
            if prep_entry is not None:
                k += len(prep_entry[0][2])
            extra = None
            if k and verify_total_items:
                frac = k / verify_total_items
                extra = {
                    "verify_items": k,
                    "verify_share_us": round(verify_dur_s * frac * 1e6, 1),
                    "verify_unique": round(verify_unique * frac, 3),
                    "verify_memoized": round(verify_memoized * frac, 3),
                }
            self._record_handle_span(
                "replica.handle_batch", env, t_wall0, t_perf0, dur,
                len(envs), extra=extra,
            )
            if i in w2_applied:
                ctx = obs_trace.TraceContext.from_wire(env.trace)
                if ctx is not None and ctx.sampled and n_w2:
                    self.tracer.record(
                        "store.write2-apply", ctx, w2_apply_wall,
                        w2_apply_dur / n_w2, args={"batch": n_w2},
                    )
                    if wal_dur:
                        self.tracer.record(
                            "wal.fsync", ctx, wal_wall, wal_dur / n_w2,
                            args={"fsyncs": round(1.0 / n_w2, 4)},
                        )

    def _memo_layer(self):
        """The caching layer of this replica's LOCAL verifier composition
        (unwraps ``.inner`` chains — CoalescingVerifier(Caching(...)) etc.),
        or None.  A REMOTE service's cache (verifier/service.py) is not
        visible from here: in that posture the meter's ``verify_unique`` is
        an UPPER bound (every item charged as unique) — the cluster-wide
        memoization shows up on the service's own admin surface instead."""
        v = self.verifier
        while v is not None:
            if isinstance(getattr(v, "hits", None), int) and isinstance(
                getattr(v, "misses", None), int
            ):
                return v
            v = getattr(v, "inner", None)
        return None

    def _verify_memo_counters(self):
        """Snapshot the local composition's memoization counters (the
        CachingVerifier hits/misses pair) — (None, None) when no local
        caching layer exists (see :meth:`_memo_layer` for the remote
        caveat)."""
        layer = self._memo_layer()
        if layer is None:
            return None, None
        return layer.hits, layer.misses

    def _verify_memo_delta(self, h0, m0, n_items: int):
        """(unique, memoized) verifies this round trip cost, from the
        caching layer's counter deltas.  Without a local caching layer
        every item is charged as a real verification (an upper bound — see
        :meth:`_memo_layer`).  Concurrent batches can interleave deltas;
        the counts are normalized to this batch's item total so a card's
        unique+memoized always sums to the items it was charged."""
        if h0 is None:
            return n_items, 0
        layer = self._memo_layer()
        if layer is None:
            return n_items, 0
        memo = max(0, layer.hits - h0)
        uniq = max(0, layer.misses - m0)
        total = uniq + memo
        if total <= 0:
            return n_items, 0
        if total != n_items:
            scale = n_items / total
            return uniq * scale, memo * scale
        return uniq, memo

    async def _verify_counted(self, items: "List[VerifyItem]"):
        """verify_batch with admission-control occupancy accounting: items
        awaiting the verifier are the write path's service-center backlog —
        one of the deterministic load components (server/admission.py)."""
        self._admission.verify_inflight += len(items)
        try:
            return await self.verifier.verify_batch(items)
        finally:
            self._admission.verify_inflight -= len(items)

    async def _verify_aggregate_counted(
        self, key: bytes, items: "List[VerifyItem]"
    ) -> bool:
        """verify_aggregate with the same admission occupancy accounting as
        :meth:`_verify_counted` — a memo hit releases immediately, a miss
        holds the slots for the one real batched round trip."""
        self._admission.verify_inflight += len(items)
        try:
            return await self.verifier.verify_aggregate(key, items)
        finally:
            self._admission.verify_inflight -= len(items)

    def _aggregate_items(self, wc: WriteCertificate) -> Optional[tuple]:
        """Build the deterministic (agg_key, items, server_ids) triple for a
        certificate's one-attestation verify, or None when the certificate
        needs per-item handling anyway (unresolvable signer id, missing
        signature, id mismatch — those drop grants with attribution).

        The item list is byte-identical on every replica — grant order is
        the certificate's own (wire) order, keys resolve from the committed
        config the cert was formed under, and the replica's OWN grant is
        included as a real verify rather than a local re-sign compare — so
        the aggregate key memoizes CLUSTER-WIDE on a shared verifier: rf
        replicas checking the same certificate cost one batched call total.
        """
        try:
            cert_cfg = self.store.cert_config(wc)
        except Exception:
            return None
        server_ids = list(wc.grants.keys())
        if not server_ids:
            return None
        items: List[VerifyItem] = []
        for sid in server_ids:
            mg = wc.grants[sid]
            key = cert_cfg.public_keys.get(sid)
            if key is None or mg.signature is None or mg.server_id != sid:
                return None
            items.append(VerifyItem(key, mg.signing_bytes(), mg.signature))
        return aggregate_key(items), items, server_ids

    def _dispatch_one(
        self,
        i: int,
        env: Envelope,
        payload,
        admin_ok,
        cert_prep,
        w2_admin_denied,
        w1_idx,
        w1_envs,
        w1_admin,
        w2_idx,
        w2_envs,
        w2_reqs,
    ) -> Optional[Envelope]:
        """Typed dispatch for ONE authenticated envelope of a batch; returns
        its response, or None when the envelope joined a write1/write2 group
        (those respond from their batched store entry)."""
        metrics = self.metrics
        if isinstance(payload, Write2ToServer):
            if i in w2_admin_denied:
                # verdict snapshotted pre-await (see handle_batch stage 2)
                return self._admin_denied(env)
            prep, vslice = cert_prep[i]
            checked = self._finish_certificate(
                payload.write_certificate, prep, vslice
            )
            if checked is None:
                self.metrics.mark("replica.bad-certificate")
                # Conviction: record the verdict span (always-sampled) and
                # drive the flight recorder — the whole point of the ring
                # is that a Byzantine verdict ships with the convicted
                # message's causal path, not just a counter.
                self._convict(
                    "bad-certificate",
                    env,
                    {"signers": sorted(payload.write_certificate.grants)},
                )
                return self._respond(
                    env,
                    RequestFailedFromServer(
                        FailType.BAD_CERTIFICATE,
                        "certificate signature check failed",
                    ),
                )
            w2_idx.append(i)
            w2_envs.append(env)
            w2_reqs.append(replace(payload, write_certificate=checked))
            return None
        if isinstance(payload, Write1ToServer):
            # admin gating lives in _handle_write1_batch (single source
            # for this path and the MAC'd inline path)
            w1_idx.append(i)
            w1_envs.append(env)
            w1_admin.append(admin_ok[i])
            return None
        if isinstance(payload, ReadToServer):
            with metrics.timer("replica.read"):
                result = self.store.process_read(payload.transaction)
            return self._respond(
                env, ReadFromServer(result, payload.nonce, rid=new_msg_id())
            )
        if isinstance(payload, HelloToServer):
            return self._respond(env, HelloFromServer(f"{payload.message} back"))
        if isinstance(payload, SessionInitToServer):
            return self._session_init(env, payload)
        if isinstance(payload, SessionCheckpointToServer):
            return self._session_checkpoint(env, payload)
        if isinstance(payload, SyncRequestToServer):
            # Serve committed state for transfer.  No trust needed on
            # either side: entries are (transaction, certificate) pairs
            # the receiver re-validates via the Write2 checks.
            entries = self.store.export_sync_entries(
                payload.keys,
                min(payload.max_entries, 1024),
                payload.after_key,
                payload.prefix,
            )
            return self._respond(env, SyncEntriesFromServer(tuple(entries)))
        if isinstance(payload, SyncDigestRequestToServer):
            # Anti-entropy digest page: shard rollups or per-key
            # digests, so a resyncing peer names the DIFFERENCE before
            # pulling.  Digests derive from quorum-signed transaction
            # hashes; the transfer itself stays the certificate-validated
            # SyncRequestToServer path, so lying here buys nothing.
            metrics.mark("replica.sync-digest-requests")
            if payload.tokens is None:
                return self._respond(
                    env,
                    SyncDigestFromServer(
                        shards=tuple(
                            (t, n, d)
                            for t, n, d in self.store.export_shard_digests()
                        )
                    ),
                )
            return self._respond(
                env,
                SyncDigestFromServer(
                    keys=tuple(
                        self.store.export_key_digests(
                            payload.tokens[:SHARD_TOKENS],
                            min(payload.max_entries, 4096),
                            payload.after_key,
                        )
                    )
                ),
            )
        if isinstance(payload, NudgeSyncToServer):
            # Advisory lag hint (paper's client-initiated UptoSpeed,
            # mochiDB.tex:168-169): queue the keys for the single
            # background sync worker.  One worker + coalesced key set =
            # built-in rate limit (a nudge flood can at worst keep one
            # resync loop busy, not spawn unbounded concurrent
            # certificate verification).
            keys = payload.keys[:1024]
            metrics.mark("replica.sync-nudges")
            self._pending_sync_keys.update(keys)
            self._kick_sync_worker()
            return self._respond(env, SyncAckFromServer(len(keys)))
        LOG.warning("unhandled payload type %s", type(payload).__name__)
        return self._respond(
            env,
            RequestFailedFromServer(FailType.OLD_REQUEST, "unhandled payload"),
        )

    def _convict(self, kind: str, env: Optional[Envelope], detail: Dict) -> None:
        """Conviction hook: force-record a verdict span under
        the convicted message's trace (when it carried one) and dump the
        span ring to the flight dir.  The synchronous full-ring dump is
        BOUNDED per conviction kind (``CONVICTION_DUMPS_MAX``): a forged-
        cert flood must not buy attacker-priced disk writes or loop
        stalls — past the cap, the forced span and counters remain the
        (cheap, bounded) evidence."""
        ctx = None
        if env is not None and env.trace is not None:
            ctx = obs_trace.TraceContext.from_wire(env.trace)
        attach = {"kind": kind, "server_id": self.server_id, **detail}
        if ctx is not None:
            attach["trace_id"] = ctx.trace_id
        if env is not None:
            attach["msg_id"] = env.msg_id
            attach["sender_id"] = env.sender_id
        self.tracer.force_mark("replica.conviction", ctx, args=attach)
        dumped = self._conviction_dumps.get(kind, 0)
        if dumped >= CONVICTION_DUMPS_MAX:
            return
        self._conviction_dumps[kind] = dumped + 1
        try:
            self.tracer.dump_flight(kind, attach)
        except OSError:
            LOG.exception("flight-recorder dump failed for %s", kind)

    def _admin_denied(self, env: Envelope) -> Envelope:
        self.metrics.mark("replica.admin-denied")
        # BAD_REQUEST, not BAD_SIGNATURE: this is authorization, and a
        # BAD_SIGNATURE would trip the client's lost-session heuristic
        # (tearing down valid MAC sessions on every denial).
        return self._respond(
            env,
            RequestFailedFromServer(
                FailType.BAD_REQUEST,
                "cluster reconfiguration requires a signed envelope from "
                "an admin key (config.admin_keys)",
            ),
        )

    def _session_init(self, env: Envelope, payload: SessionInitToServer) -> Envelope:
        # Handshake-storm valve: X25519+Ed25519 handshakes are the most
        # expensive unauthenticated work this replica performs — a storm
        # must not buy unbounded CPU (or churn the session table's LRU).
        # The typed OVERLOADED refusal carries a retry-after hint; the
        # client's failure TTL (SESSION_FAILURE_TTL_S) keeps it on signed
        # envelopes meanwhile, so liveness only loses the MAC discount.
        if not self._handshakes.admit():
            self.metrics.mark("replica.handshake-limited")
            return self._respond(
                env,
                RequestFailedFromServer(
                    FailType.OVERLOADED,
                    "session handshake rate limited; retry later",
                    self._handshakes.retry_after_ms(),
                ),
                force_sign=True,
            )
        # Ban book AFTER the rate valve: the refusal below is signed
        # (force_sign — the client must be able to trust "you are banned"
        # or a MITM could fake evictions), and the valve is what keeps
        # signed refusals bounded under a banned-identity storm.
        if env.sender_id in self._client_bans:
            self.metrics.mark("replica.handshake-banned")
            # BAD_REQUEST, not BAD_SIGNATURE — same reasoning as
            # _admin_denied: this is policy, and BAD_SIGNATURE would make
            # the client tear down unrelated valid sessions.
            return self._respond(
                env,
                RequestFailedFromServer(
                    FailType.BAD_REQUEST,
                    "client evicted by policy; session handshake refused",
                ),
                force_sign=True,
            )
        # The ack must be Ed25519-SIGNED (not MAC'd): its signature is
        # what proves to the initiator that no MITM swapped X25519 keys.
        # A MAC'd handshake request is meaningless — require signature
        # semantics (enforced by auth: the mac path only passes for an
        # already established session, which a fresh handshake won't have).
        hs = session_crypto.new_handshake()
        ack = self._respond(
            env,
            SessionAckFromServer(hs.public_bytes, hs.nonce),
            force_sign=True,
        )
        self._sessions[env.sender_id] = session_crypto.derive_key(
            hs,
            payload.x25519_public,
            payload.nonce,
            initiator_id=env.sender_id,
            responder_id=self.server_id,
            initiated=False,
        )
        # Fresh session, fresh audit window: the sender's SessionWindow
        # restarts with the new key, so a ledger carried across handshakes
        # would demand coverage the sender can no longer give.
        self._ckpt_ledgers.pop(env.sender_id, None)
        self.metrics.mark("replica.sessions-established")
        return ack

    def _session_checkpoint(
        self, env: Envelope, payload: SessionCheckpointToServer
    ) -> Envelope:
        """Verify a sender's signed checkpoint declaration against this
        replica's accepted-envelope ledger.

        The declaration MUST arrive Ed25519-signed — its signature is the
        retroactive identity binding the whole fast path rests on — so a
        MAC'd (or unsigned) checkpoint is by definition a downgrade attempt:
        typed refusal + conviction, never a silent fallback.  A coverage
        mismatch (this replica accepted a MAC'd envelope the sender never
        signed for) is a forged or replayed MAC window: conviction with the
        signed declaration as transferable evidence, typed BAD_CERTIFICATE,
        and the session drops so state restarts clean."""
        metrics = self.metrics
        if env.mac is not None or env.signature is None:
            metrics.mark("replica.checkpoint-downgrade")
            self._convict(
                "checkpoint-downgrade", env,
                {"macd": env.mac is not None, "window": payload.window},
            )
            return self._respond(
                env,
                RequestFailedFromServer(
                    FailType.BAD_REQUEST,
                    "session checkpoints must be Ed25519-signed "
                    "(MAC downgrade refused)",
                ),
                force_sign=True,
            )
        led = self._ckpt_ledgers.get(env.sender_id)
        if led is None:
            # No MAC'd envelope accepted since boot/handshake: trivially
            # consistent — verify against an empty ledger so the declared
            # digests still enter the carry (late arrivals stay covered).
            led = session_crypto.CheckpointLedger()
            self._ckpt_ledgers[env.sender_id] = led
        if len(payload.digests) > session_crypto.CheckpointLedger.CARRY_MAX:
            # bound the carry memory a single declaration can demand
            self._drop_session(env.sender_id)
            return self._respond(
                env,
                RequestFailedFromServer(
                    FailType.BAD_REQUEST,
                    "checkpoint declaration too large; re-establish session",
                ),
                force_sign=True,
            )
        accepted_before = led.count_since
        reason = led.verify(payload.digests)
        if reason == "carry overflow":
            # pathological loss, not evidence: demand a fresh session
            metrics.mark("replica.checkpoint-reset")
            self._drop_session(env.sender_id)
            return self._respond(
                env,
                RequestFailedFromServer(
                    FailType.BAD_REQUEST,
                    "session transcript unreconcilable; re-establish session",
                ),
                force_sign=True,
            )
        if reason is not None:
            metrics.mark("replica.checkpoint-mismatch")
            self._convict(
                "checkpoint-mismatch", env,
                {"reason": reason, "window": payload.window,
                 "declared": len(payload.digests)},
            )
            self._drop_session(env.sender_id)
            return self._respond(
                env,
                RequestFailedFromServer(
                    FailType.BAD_CERTIFICATE,
                    "checkpoint transcript mismatch: " + reason,
                ),
                force_sign=True,
            )
        metrics.mark("replica.checkpoints-verified")
        return self._respond(
            env, SessionCheckpointAckFromServer(payload.window, accepted_before)
        )

    def _handle_write1_batch(
        self, envs: "Sequence[Envelope]", admin_ok: "Sequence[bool]"
    ) -> "List[Optional[Envelope]]":
        """Grant issuance for all Write1s of one drain batch: shed/admin
        gating per envelope, then ONE ``process_write1_batch`` store entry,
        then the grant signatures (synchronous host crypto, counted in
        replica.crypto-local like every sign this replica performs)."""
        metrics = self.metrics
        # Refresh the shed probability from the deterministic load signal
        # once per Write1 batch — the only admission point, so the O(1)
        # update needs no timer task (and a pinned controller stays put).
        admission = self._admission
        was_over = admission.overloaded
        admission.update()
        if admission.overloaded and not was_over:
            metrics.mark("replica.overload-entered")
        self._sweep_countdown -= 1
        if self._sweep_countdown <= 0:
            # amortized idle-session TTL sweep (O(sessions), every ~1k
            # write1 batches): idle memory reclaimed while traffic pays
            self._sweep_countdown = 1024
            self._sessions.sweep()
        out: List[Optional[Envelope]] = [None] * len(envs)
        reqs: List[Write1ToServer] = []
        req_idx: List[int] = []
        for i, env in enumerate(envs):
            payload = env.payload
            try:
                if (
                    bool(self.config.admin_keys)
                    and not admin_ok[i]
                    and self._is_admin_op(payload)
                ):
                    # Authorization for the GRANT path too, not just Write2
                    # commit: a non-admin Write1 on config keys must not
                    # even acquire grants (it would contend with — and
                    # refuse — legitimate admin reconfiguration Write1s).
                    # MAC'd envelopes can never qualify (_admin_sig_ok
                    # rejects MACs), so admin_ok is False for the whole
                    # inline path.
                    out[i] = self._admin_denied(env)
                elif (
                    self._shed_p > 0.0
                    and not admin_ok[i]
                    and self._shed_draw(payload) < self._shed_p
                ):
                    # Shed at the txn entry point only: admitted work
                    # (Write2, reads) still completes, so shedding DRAINS
                    # the backlog instead of wasting the grants already
                    # issued.  Admin ops (reconfiguration) are never shed —
                    # an operator fixing an overloaded cluster must get
                    # through.
                    metrics.mark("replica.write1-shed")
                    if env.trace is not None:
                        # always-sample-on-shed: the shed txn is exactly
                        # the trace an overload postmortem wants
                        self.tracer.force_mark(
                            "replica.shed",
                            obs_trace.TraceContext.from_wire(env.trace),
                            args={"shed_p": round(self._shed_p, 4)},
                        )
                    out[i] = self._respond(
                        env,
                        RequestFailedFromServer(
                            FailType.OVERLOADED,
                            "overloaded; retry with backoff",
                            admission.retry_after_ms,
                        ),
                    )
                else:
                    req_idx.append(i)
                    reqs.append(payload)
            except Exception:
                # garbage payload fails alone (no response; client times out)
                LOG.exception("write1 gating failed for %s", env.msg_id)
        if reqs:
            w1_wall = time.time()
            tw1 = time.perf_counter()
            with metrics.timer("replica.write1"):
                results = self.store.process_write1_batch(reqs)
            w1_dur = time.perf_counter() - tw1
            for j in req_idx:
                env = envs[j]
                if env.trace is not None:
                    # store write1 apply charged as a 1/n share of the
                    # batched entry point (grant issuance + quota checks)
                    ctx = obs_trace.TraceContext.from_wire(env.trace)
                    if ctx is not None and ctx.sampled:
                        self.tracer.record(
                            "store.write1-apply", ctx, w1_wall,
                            w1_dur / len(reqs), args={"batch": len(reqs)},
                        )
            for i, env, result in zip(req_idx, (envs[j] for j in req_idx), results):
                try:
                    if isinstance(result, QuotaExceeded):
                        # Per-client grant quota: typed refusal
                        # with a retry-after hint, riding the same client
                        # backoff contract as OVERLOADED sheds — and a
                        # replica-side suspicion observable (the store's
                        # per-client ledger already counted it).
                        metrics.mark("replica.write1-quota-refused")
                        out[i] = self._respond(
                            env,
                            RequestFailedFromServer(
                                FailType.QUOTA_EXCEEDED,
                                str(result),
                                result.retry_after_ms,
                            ),
                        )
                        continue
                    if isinstance(result, BadRequest):
                        out[i] = self._respond(
                            env,
                            RequestFailedFromServer(
                                FailType.BAD_REQUEST, str(result)
                            ),
                        )
                        continue
                    if isinstance(result, Exception):
                        # processing bug isolated by the store batch entry:
                        # drop THIS response only (client timeout recovers),
                        # exactly the old per-message handler blast radius
                        LOG.error(
                            "write1 failed for %s", env.msg_id, exc_info=result
                        )
                        continue
                    mg = result.multi_grant
                    with metrics.timer("replica.crypto-local"):
                        sb = mg.signing_bytes()
                        sig = self.keypair.sign(sb)
                        if len(self._own_grant_sigs) >= 8192:
                            self._own_grant_sigs.pop(
                                next(iter(self._own_grant_sigs))
                            )
                        self._own_grant_sigs[sb] = sig
                        mg_signed = mg.with_signature(sig)
                    out[i] = self._respond(
                        env, replace(result, multi_grant=mg_signed)
                    )
                except Exception:
                    # sign/respond bug for one grant fails alone
                    LOG.exception("write1 response failed for %s", env.msg_id)
        return out

    # ---------------------------------------------------------------- resync

    def _kick_sync_worker(self) -> None:
        if self._sync_worker is None or self._sync_worker.done():
            self._sync_worker = asyncio.ensure_future(self._sync_worker_loop())
            self._sync_tasks.add(self._sync_worker)
            self._sync_worker.add_done_callback(self._sync_tasks.discard)

    async def _sync_worker_loop(self) -> None:
        """Drain nudged keys in batches until the pending set is empty."""
        while self._pending_sync_keys:
            batch = set(list(self._pending_sync_keys)[:1024])
            self._pending_sync_keys -= batch
            try:
                # "*" = full resync (post-reconfiguration ownership changes)
                await self.resync(None if "*" in batch else batch)
            except asyncio.CancelledError:
                raise  # close() cancels sync workers; exit, don't keep draining
            except Exception:
                LOG.exception("background resync failed")

    def _signed_request(self, payload) -> Envelope:
        env = Envelope(
            payload=payload,
            msg_id=new_msg_id(),
            sender_id=self.server_id,
            timestamp_ms=int(time.time() * 1000),
        )
        with self.metrics.timer("replica.crypto-local"):
            return env.with_signature(self.keypair.sign(env.signing_bytes()))

    # --------------------------------------------- peer MAC sessions

    def _drop_peer_session(self, sid: str) -> None:
        self._peer_sessions.pop(sid, None)
        self._peer_windows.pop(sid, None)

    async def _ensure_peer_session(
        self, sid: str, info, timeout_s: float = 3.0
    ) -> Optional[bytes]:
        """Initiator side of a replica->replica MAC session: the same
        SessionInit handshake clients use (the responder's _session_init
        doesn't care who initiates), with the ack's Ed25519 signature
        verified against the peer's MEMBERSHIP key — that signature is what
        stops a MITM key substitution.  None = no session (refused, rate
        limited, unreachable): the caller stays on signed envelopes, and a
        failure TTL stops a refusing peer from buying a handshake storm."""
        key = self._peer_sessions.get(sid)
        if key is not None:
            return key
        if time.monotonic() < self._peer_hs_retry_at.get(sid, 0.0):
            return None
        lock = self._peer_hs_locks.setdefault(sid, asyncio.Lock())
        async with lock:
            key = self._peer_sessions.get(sid)  # raced handshake won
            if key is not None:
                return key
            if time.monotonic() < self._peer_hs_retry_at.get(sid, 0.0):
                return None
            hs = session_crypto.new_handshake()
            try:
                res = await self.peer_pool.send_and_receive(
                    info,
                    self._signed_request(
                        SessionInitToServer(hs.public_bytes, hs.nonce)
                    ),
                    timeout_s,
                )
            except asyncio.CancelledError:
                raise
            except Exception:
                self._peer_hs_retry_at[sid] = time.monotonic() + 10.0
                return None
            ack = res.payload
            peer_key = self.config.public_keys.get(sid)
            sig_ok = False
            if (
                isinstance(ack, SessionAckFromServer)
                and peer_key is not None
                and res.signature is not None
            ):
                # pooled (non-blocking) verify: handshakes are rare, but a
                # storm of them must not stall the event loop on host crypto
                bitmap = await self._verify_counted(
                    [VerifyItem(peer_key, res.signing_bytes(), res.signature)]
                )
                sig_ok = bool(bitmap[0])
            if not sig_ok:
                self.metrics.mark("replica.peer-handshake-refused")
                self._peer_hs_retry_at[sid] = time.monotonic() + 10.0
                return None
            key = session_crypto.derive_key(
                hs,
                ack.x25519_public,
                ack.nonce,
                initiator_id=self.server_id,
                responder_id=sid,
                initiated=True,
            )
            self._peer_sessions[sid] = key
            self._peer_windows[sid] = session_crypto.SessionWindow()
            self.metrics.mark("replica.peer-sessions-established")
            return key

    async def _peer_checkpoint(
        self, sid: str, info, timeout_s: float = 5.0
    ) -> None:
        """Flush this replica's sender-side checkpoint window for one peer
        session: sign the declaration, retire it on a positive ack.  A
        refused declaration (should never happen to an honest sender) drops
        the session — state restarts clean on the next handshake."""
        win = self._peer_windows.get(sid)
        if win is None or not win.pending:
            return
        window, digests = win.take()
        ticket = win  # the handle the taken digests belong to
        try:
            res = await self.peer_pool.send_and_receive(
                info,
                self._signed_request(SessionCheckpointToServer(window, digests)),
                timeout_s,
            )
        except asyncio.CancelledError:
            raise
        except Exception:
            return  # lost checkpoint: the window re-declares next flush
        # Re-read after the await: a concurrent drop/re-handshake replaced
        # the window, and the fresh one owns a NEW transcript — retiring
        # these digests against it would corrupt it.
        win = self._peer_windows.get(sid)
        if win is None or win is not ticket:
            return
        if isinstance(res.payload, SessionCheckpointAckFromServer):
            win.committed(len(digests))
            self.metrics.mark("replica.peer-checkpoints")
        elif isinstance(res.payload, RequestFailedFromServer):
            self.metrics.mark("replica.peer-checkpoint-refused")
            self._drop_peer_session(sid)

    async def _peer_send(
        self, sid: str, info, payload, timeout_s: float
    ) -> Envelope:
        """Send one peer request: MAC-sealed on an established session when
        the fast path is on (with the sender-side checkpoint bookkeeping),
        Ed25519-signed otherwise.  A stale-session BAD_SIGNATURE (the peer
        restarted and lost its table) retries signed once and re-handshakes
        lazily — same contract as the client SDK's fan-out."""
        if self.fast_path:
            key = await self._ensure_peer_session(sid, info)
            if key is not None:
                win = self._peer_windows.get(sid)
                if win is not None and (win.due() or win.overdue_risk()):
                    await self._peer_checkpoint(sid, info, timeout_s)
                    key = self._peer_sessions.get(sid)
                if key is not None:
                    env = Envelope(
                        payload=payload,
                        msg_id=new_msg_id(),
                        sender_id=self.server_id,
                        timestamp_ms=int(time.time() * 1000),
                    )
                    with self.metrics.timer("replica.crypto-local"):
                        env = session_crypto.seal(env, key)
                    win = self._peer_windows.get(sid)
                    if win is not None:
                        win.note(env.signing_bytes())
                    res = await self.peer_pool.send_and_receive(
                        info, env, timeout_s
                    )
                    p = res.payload
                    if (
                        isinstance(p, RequestFailedFromServer)
                        and p.fail_type == FailType.BAD_SIGNATURE
                    ):
                        self.metrics.mark("replica.peer-session-stale")
                        self._drop_peer_session(sid)
                    elif (
                        isinstance(p, RequestFailedFromServer)
                        and p.fail_type == FailType.BAD_REQUEST
                        and "checkpoint" in p.detail
                    ):
                        self.metrics.mark("replica.peer-session-reset")
                        self._drop_peer_session(sid)
                    else:
                        return res
                    return await self.peer_pool.send_and_receive(
                        info, self._signed_request(payload), timeout_s
                    )
        return await self.peer_pool.send_and_receive(
            info, self._signed_request(payload), timeout_s
        )

    async def resync(
        self, keys: Optional[Iterable[str]] = None, timeout_s: float = 5.0
    ) -> int:
        """Pull committed state from peers and apply whatever is newer.

        The paper's UptoSpeed recovery (``mochiDB.tex:168-169``), which the
        reference never built (SURVEY.md §5): after a restart (state is
        in-memory, like the reference) this replica's epochs restart at 0 and
        its Write1 grants can never again agree with the surviving quorum —
        resync re-hydrates (value, certificate, epoch) per key.  Every entry
        is validated exactly like a client Write2 (2f+1 signed in-set grants,
        transaction-hash match, staleness), so a Byzantine peer can at worst
        send us stale-but-valid state, which the timestamp check ignores.

        Returns the number of objects whose state advanced.
        """
        key_tuple = tuple(keys) if keys is not None else None
        page = 1024
        advanced_keys: set = set()

        def peers_now():
            # Re-read per pass: a mid-resync reconfig swaps the peer list
            # under us, and every pulled entry is certificate-validated
            # anyway, so the freshest membership can only improve coverage.
            return [
                (sid, info)
                for sid, info in self.config.servers.items()
                if sid != self.server_id
            ]

        async def pull_peer(
            sid,
            info,
            prefix: Optional[str],
            req_keys: "Optional[tuple]" = None,
            count: Optional[str] = None,
        ) -> None:
            after: Optional[str] = None
            while True:  # page until a short page (or error/foreign payload)
                request = SyncRequestToServer(
                    keys=req_keys, max_entries=page, after_key=after, prefix=prefix
                )
                try:
                    res = await self._peer_send(sid, info, request, timeout_s)
                except asyncio.CancelledError:
                    raise
                except Exception:
                    return
                if not isinstance(res.payload, SyncEntriesFromServer):
                    return
                entries = res.payload.entries
                if count is not None and entries:
                    # delta-vs-full transfer accounting (the
                    # incremental anti-entropy evidence on storage_stats)
                    self.metrics.mark(f"replica.resync-{count}-keys", len(entries))
                # Verify-behind-the-ack, batched per page: the
                # nudge/pull was acknowledged long ago; these checks run in
                # the background worker, so the page's certificates verify
                # CONCURRENTLY — on the fast path each is one memoized
                # aggregate, usually the very attestation some replica
                # already verified at Write2 time.  Adoption stays strictly
                # after verification: speculative state adoption would
                # trade safety for nothing.
                owned = [e for e in entries if self.store.owns(e.key)]
                if self.fast_path:
                    # Warm the aggregate memo for the whole page at once;
                    # the per-entry re-check below then hits the memo (no
                    # second signature round trip).
                    await asyncio.gather(
                        *(
                            self._check_certificate_fast(e.certificate)
                            for e in owned
                        )
                    )
                for entry in owned:
                    checked = await self._check_certificate_fast(
                        entry.certificate
                    )
                    if checked is None:
                        # fast path off, aggregate ineligible, or a failed
                        # aggregate: the attributing per-grant audit
                        checked = await self._check_certificate(
                            entry.certificate
                        )
                    if checked is None:
                        self.metrics.mark("replica.resync-bad-certificate")
                        continue
                    if self.store.apply_sync_entry(
                        replace(entry, certificate=checked)
                    ):
                        advanced_keys.add(entry.key)
                if len(entries) < page:
                    return
                after = entries[-1].key

        async def digest_page(sid, info, request) -> Optional[SyncDigestFromServer]:
            try:
                res = await self._peer_send(sid, info, request, timeout_s)
            except asyncio.CancelledError:
                raise
            except Exception:
                return None
            if not isinstance(res.payload, SyncDigestFromServer):
                return None  # earlier peer (or refusal): caller falls back
            return res.payload

        async def pull_peer_delta(sid, info) -> None:
            """Incremental anti-entropy: shard digests -> key
            digests for mismatched shards -> pull ONLY the differing keys.
            Peers that do not speak digests get the old full pull.  Digest
            comparisons are advisory (a lying peer causes a redundant or
            missed pull from ITSELF only); every transferred entry still
            re-validates through the Write2 path."""
            res = await digest_page(sid, info, SyncDigestRequestToServer())
            if res is None or res.shards is None:
                await pull_peer(sid, info, None, None, count="full")
                return
            local_shards = {
                t: (n, d) for t, n, d in self.store.export_shard_digests()
            }
            matched = 0
            mismatched: List[int] = []
            for token, n, digest in res.shards:
                if not 0 <= token < SHARD_TOKENS:
                    continue
                if self.server_id not in self.config.replica_set_for_token(token):
                    continue  # none of its keys are ours to apply
                have = local_shards.get(token)
                # compare_digest not for secrecy (digests derive from
                # public quorum-signed hashes) but uniformity: every
                # authenticator-shaped compare in this module is constant
                # time, so the const-time pass stays exception-free
                if have is not None and have[0] == n and hmac.compare_digest(
                    have[1], digest
                ):
                    matched += 1
                else:
                    mismatched.append(token)
            if matched:
                self.metrics.mark("replica.resync-shards-matched", matched)
            if not mismatched:
                return
            wanted = set(mismatched)
            local_keys = {
                key: d
                for key, token, d in self.store._iter_digests()
                if token in wanted
            }
            delta: List[str] = []
            keys_matched = 0
            after: Optional[str] = None
            while True:
                res = await digest_page(
                    sid,
                    info,
                    SyncDigestRequestToServer(
                        tokens=tuple(mismatched), max_entries=4096, after_key=after
                    ),
                )
                if res is None or res.keys is None:
                    return
                self.metrics.mark("replica.resync-digest-pages")
                for key, digest in res.keys:
                    if not self.store.owns(key):
                        continue
                    if hmac.compare_digest(local_keys.get(key, b""), digest):
                        keys_matched += 1
                    else:
                        delta.append(key)
                if len(res.keys) < 4096:
                    break
                after = res.keys[-1][0]
            if keys_matched:
                self.metrics.mark("replica.resync-keys-matched", keys_matched)
            for i in range(0, len(delta), page):
                await pull_peer(
                    sid, info, None, tuple(delta[i : i + page]), count="delta"
                )

        with self.metrics.timer("replica.resync"):
            # Pass 1 (x2): the _CONFIG_ keyspace alone — historical config
            # archives must be learned BEFORE the data certificates that are
            # validated against them (store.config_for_stamp), regardless of
            # key sort order.  Run twice: the first sweep walks the archive
            # catch-up chain (each install enables validating the next
            # stamp); the second then imports entries — notably the
            # CONFIG_CLUSTER document itself — whose certificates only
            # became checkable after the chain completed.  Skipped entirely
            # for targeted resyncs that name no config key.
            from ..cluster.config import CONFIG_KEY_PREFIX

            config_pass = key_tuple is None or any(
                k.startswith(CONFIG_KEY_PREFIX) for k in key_tuple
            )
            if config_pass:
                # keys=None here even for targeted resyncs: a nudge names
                # only the head document, but catching up REQUIRES the
                # _CONFIG_CLUSTER_CS_* rungs; the prefix bounds the sweep.
                for _ in range(2):
                    await asyncio.gather(
                        *(
                            pull_peer(sid, info, CONFIG_KEY_PREFIX, None)
                            for sid, info in peers_now()
                        )
                    )
            # Pass 2: the requested keys (config keys re-apply as no-ops).
            # A FULL resync (keys=None) goes digest-first — per-shard
            # rollups, then per-key digests for mismatched shards, then a
            # pull of only the difference — so a recovered-from-disk
            # replica ships deltas instead of the whole store; targeted
            # resyncs already name their keys.
            if key_tuple is None:
                await asyncio.gather(
                    *(pull_peer_delta(sid, info) for sid, info in peers_now())
                )
            else:
                await asyncio.gather(
                    *(
                        pull_peer(sid, info, None, key_tuple)
                        for sid, info in peers_now()
                    )
                )
        if advanced_keys:
            LOG.info("resync advanced %d objects", len(advanced_keys))
            self.metrics.mark("replica.resync-applied", len(advanced_keys))
        if self.storage.dirty:
            # resync applies stage commits like any other Write2: make the
            # pulled state durable before reporting it recovered
            await self.storage.flush()
        return len(advanced_keys)

    def _prepare_certificate(self, wc: WriteCertificate, defer_own: bool = False) -> tuple:
        """Sync half of certificate verification: resolve signer keys, run
        the own-grant compare, and emit the VerifyItems still needing real
        crypto.  Returns ``(server_ids, valid, items, item_idx)`` — the
        caller verifies ``items`` (alone or pooled with a whole batch's
        worth in one verifier round trip) and hands the bitmap slice to
        :meth:`_finish_certificate`.

        ``defer_own=True`` (set for envelopes whose OWN authentication is
        still pending in the pooled round trip): an own-grant signature
        cache miss becomes one more pooled VerifyItem instead of a
        synchronous re-SIGN on the event loop — an unauthenticated forger
        must not be able to buy ~650 us of loop-blocking host crypto per
        request.  With that, pre-auth certificate work is bounded at one
        pooled verify per RESOLVABLE signer id (fabricated ids resolve no
        key and cost nothing), i.e. no more than one authenticated Write2
        legitimately costs.

        Signer keys come from the configuration the certificate was formed
        under (a server removed since then still signed validly THEN; a
        fresh member learns old keys from the committed config archive).
        Same resolution the quorum layer uses — store.cert_config.
        """
        cert_cfg = self.store.cert_config(wc)
        server_ids = list(wc.grants.keys())
        valid = [False] * len(server_ids)
        items: List[VerifyItem] = []
        item_idx: List[int] = []
        for i, sid in enumerate(server_ids):
            mg = wc.grants[sid]
            key = cert_cfg.public_keys.get(sid)
            if key is None or mg.signature is None or mg.server_id != sid:
                continue
            if sid == self.server_id:
                # Our own grant: Ed25519 is deterministic (RFC 8032), so a
                # re-sign-and-compare equals a verify at a third of the cost
                # — and the write1 path cached the signature we issued, so
                # the common case is a dict compare with no crypto at all.
                sb = mg.signing_bytes()
                cached = self._own_grant_sigs.get(sb)
                if cached is None and defer_own:
                    item_idx.append(i)
                    items.append(VerifyItem(key, sb, mg.signature))
                    continue
                with self.metrics.timer("replica.crypto-local"):
                    if cached is None:
                        cached = self.keypair.sign(sb)
                    valid[i] = hmac.compare_digest(cached, mg.signature)
                continue
            item_idx.append(i)
            items.append(VerifyItem(key, mg.signing_bytes(), mg.signature))
        return (server_ids, valid, items, item_idx)

    def _finish_certificate(
        self, wc: WriteCertificate, prep: tuple, bitmap: "Sequence[bool]"
    ) -> Optional[WriteCertificate]:
        """Apply a verdict bitmap (aligned with prep's items) and rebuild
        the certificate from the surviving grants; None if nothing checks
        out (the datastore's quorum count then rejects thin certificates)."""
        server_ids, valid, _, item_idx = prep
        for i, ok in zip(item_idx, bitmap):
            valid[i] = bool(ok)
        kept = {sid: wc.grants[sid] for sid, ok in zip(server_ids, valid) if ok}
        if len(kept) != len(server_ids):
            self.metrics.mark("replica.dropped-grants", len(server_ids) - len(kept))
            for sid, ok in zip(server_ids, valid):
                # Per-signer attribution: a grant claiming sid that failed
                # its signature is evidence about the CARRIER of the
                # certificate, not proof against sid — but a replica whose
                # id keeps appearing on bad grants is the operator's first
                # suspect row.  Only MEMBER ids get a counter: fabricated
                # signer strings must not mint unbounded metric names
                # (counter cardinality stays bounded by the membership).
                if not ok and sid in self.config.public_keys:
                    self.metrics.mark(f"replica.bad-grant.{sid}")
        if not kept:
            return None
        self._note_grant_evidence(kept.values())
        return WriteCertificate(kept)

    def _note_grant_evidence(self, multigrants) -> None:
        """Equivocation detection over VALIDLY SIGNED grants only (a forged
        grant must never frame an honest signer): remember the transaction
        hash each signer committed to per (object, ts, configstamp); a
        conflicting re-observation is cryptographic proof the signer issued
        two grants for the same slot — count and surface it."""
        ledger = self._grant_ledger
        for mg in multigrants:
            for g in mg.grants.values():
                if g.status != Status.OK:
                    continue
                slot = (g.object_id, g.timestamp, g.configstamp, mg.server_id)
                seen = ledger.get(slot)
                if seen is None:
                    if len(ledger) >= GRANT_LEDGER_MAX:
                        ledger.pop(next(iter(ledger)))
                    ledger[slot] = (g.transaction_hash,)
                elif (
                    g.transaction_hash not in seen
                    and len(seen) < GRANT_LEDGER_SLOT_MAX
                ):
                    # Each DISTINCT conflicting hash convicts once; a
                    # retried certificate re-presenting the same lie must
                    # not inflate the published equivocation count, and a
                    # hash-spray against one slot stops counting (and
                    # growing) at the slot cap.
                    ledger[slot] = seen + (g.transaction_hash,)
                    self._equivocations[mg.server_id] = (
                        self._equivocations.get(mg.server_id, 0) + 1
                    )
                    self.metrics.mark(f"replica.equivocation.{mg.server_id}")
                    LOG.warning(
                        "EQUIVOCATION by %s: object %r ts=%d granted to two "
                        "transactions", mg.server_id, g.object_id, g.timestamp,
                    )
                    # Cryptographic conviction: ship the evidence with the
                    # flight ring (no envelope at this seam — the certificate
                    # may have arrived via resync as well as Write2).
                    self._convict(
                        "equivocation",
                        None,
                        {
                            "signer": mg.server_id,
                            "object": g.object_id,
                            "timestamp": g.timestamp,
                        },
                    )

    def client_grant_stats(self) -> Dict[str, object]:
        """Per-client grant/quota/reclaim accounting for the admin surfaces
        (/status "clients", ``mochi_client`` prom family, "/" Clients
        table): the replica-side mirror of the client SDK's per-peer
        suspicion ledger — reclaimed_from marks withholders, quota_refused
        marks hoarders (docs/OPERATIONS.md §4h)."""
        st = self.store.client_stats()
        st["quota_refusals_served"] = self.metrics.counters.get(
            "replica.write1-quota-refused", 0
        )
        st["banned_clients"] = len(self._client_bans)
        return st

    def evict_client(self, client_id: str, ban: bool = True) -> Dict[str, object]:
        """Policy eviction hook for one client identity — the safe seam the
        disconnect policy (not built yet) will drive from the
        suspicion/quota ledgers.  Drops the MAC session and (by default)
        bans re-handshakes; signed-envelope traffic is untouched.

        Await-race audit (why this shape): everything consulted here — the
        ``client_stats_map`` ledger entry, the session table, the ban book
        — and the act itself run in ONE loop turn with no ``await``, so a
        caller's check-then-act (read ledger, decide, evict) cannot be
        split by a concurrent batch.  The one window the pass flagged as
        structural is a batch already PAST auth, holding the session across
        its verify round trip: ``SessionTable.evict`` defers exactly that
        case (pinned ⇒ dropped at final unpin, in-flight responses still
        seal), and the ban book — not eviction timing — is what keeps the
        client out afterwards, since a fresh handshake legitimately
        supersedes a deferred drop.  Outstanding Write1 grants are NOT
        cancelled: revoking granted slots here would reintroduce the
        reclaim/slow-Write2 race the grant TTL closes — the grant TTL already bounds
        them, and the quota ledger entry survives (it is never evicted
        while outstanding), so a banned hoarder cannot shed its debt.
        """
        ledger = self.store.client_stats_map.get(client_id)
        disposition = self._sessions.evict(client_id)
        if ban and client_id not in self._client_bans:
            if len(self._client_bans) >= CLIENT_BANS_MAX:
                self._client_bans.pop(next(iter(self._client_bans)))
            self._client_bans[client_id] = None
        self.metrics.mark(f"replica.client-evicted.{disposition}")
        return {
            "client": client_id,
            "session": disposition,
            "banned": client_id in self._client_bans,
            "outstanding_grants": 0 if ledger is None else ledger["outstanding"],
        }

    def storage_stats(self) -> Dict[str, object]:
        """The /status "storage" surface (admin/http.py; docs/OPERATIONS.md
        §4i): engine counters (WAL bytes/entries, fsync policy + count,
        snapshot age, replay report) plus this replica's anti-entropy
        transfer accounting (how much state moved as DELTAS vs full pulls
        during resync — the incremental state-transfer evidence)."""
        st = self.storage.stats()
        c = self.metrics.counters
        st["anti_entropy"] = {
            "digest_pages": c.get("replica.resync-digest-pages", 0),
            "shards_matched": c.get("replica.resync-shards-matched", 0),
            "keys_matched": c.get("replica.resync-keys-matched", 0),
            "delta_keys_pulled": c.get("replica.resync-delta-keys", 0),
            "full_keys_pulled": c.get("replica.resync-full-keys", 0),
            "applied": c.get("replica.resync-applied", 0),
        }
        return st

    def byzantine_stats(self) -> Dict[str, object]:
        """Per-peer misbehavior evidence for the admin surfaces (/status
        "byzantine", ``mochi_byzantine`` prom family): proven equivocations
        plus bad-grant and resync-rejection attribution counters."""
        prefix = "replica.bad-grant."
        bad_grants = {
            name[len(prefix):]: n
            for name, n in self.metrics.counters.items()
            if name.startswith(prefix)
        }
        return {
            "equivocations": dict(self._equivocations),
            "bad_grants": bad_grants,
            "resync_bad_certificates": self.metrics.counters.get(
                "replica.resync-bad-certificate", 0
            ),
        }

    async def _check_certificate(self, wc: WriteCertificate) -> Optional[WriteCertificate]:
        """Verify every MultiGrant signature in a write certificate; drop
        invalid or unattributable grants (resync path; the request hot path
        pools the same prepare/finish steps across a whole drained batch in
        ``handle_batch``).

        This is the quorum-cert aggregation hot path: 2f+1 signature checks
        per Write2, batched into one verifier call.
        """
        prep = self._prepare_certificate(wc)
        items = prep[2]
        bitmap = await self._verify_counted(items) if items else []
        return self._finish_certificate(wc, prep, bitmap)

    async def _check_certificate_fast(
        self, wc: WriteCertificate
    ) -> Optional[WriteCertificate]:
        """Aggregate-only certificate check (resync path): the
        one-attestation verify, memoized cluster-wide by certificate hash,
        so a resync page of certs the cluster already committed costs zero
        signature verifies.  Returns None when the fast path is off, the
        aggregate is ineligible, or it FAILS — callers must then audit via
        ``_check_certificate`` (the attributing per-grant path) before any
        adoption; this method never adopts on failure itself."""
        if not self.fast_path:
            return None
        agg = self._aggregate_items(wc)
        if agg is None:
            return None
        akey, aitems, _server_ids = agg
        try:
            ok = await self._verify_aggregate_counted(akey, aitems)
        except asyncio.CancelledError:
            raise
        except Exception:
            ok = False
        if ok:
            self._note_grant_evidence(wc.grants.values())
            return WriteCertificate(dict(wc.grants))
        # Someone in the grant set lied (or the cert is malformed): the
        # caller pays the per-item audit so the conviction machinery can
        # attribute WHICH grant was bad.
        self.metrics.mark("replica.cert-agg-audit")
        return None

    def fastpath_stats(self) -> Dict[str, object]:
        """Fast-path observability: session/checkpoint posture and
        aggregate-verify effectiveness, for the admin surface and the
        benchmark records."""
        v = self.verifier
        return {
            "fast_path": self.fast_path,
            "client_sessions": len(self._sessions),
            "peer_sessions": len(self._peer_sessions),
            "checkpoint_ledgers": {
                sid: led.stats() for sid, led in self._ckpt_ledgers.items()
            },
            "peer_windows": {
                sid: {"pending": len(win.pending), "window": win.window,
                      "sent": win.sent}
                for sid, win in self._peer_windows.items()
            },
            "checkpoints_verified": self.metrics.counters.get(
                "replica.checkpoints-verified", 0
            ),
            "checkpoint_mismatches": self.metrics.counters.get(
                "replica.checkpoint-mismatch", 0
            ),
            "cert_agg_verified": self.metrics.counters.get(
                "replica.cert-agg-verified", 0
            ),
            "cert_agg_audits": self.metrics.counters.get(
                "replica.cert-agg-audit", 0
            ),
            "agg_hits": getattr(v, "agg_hits", None),
            "agg_misses": getattr(v, "agg_misses", None),
        }

