"""Protocol message vocabulary.

Same message set as the reference schema (``server/messages/MochiProtocol.proto``):
Operation/Transaction (``:20-43``), OperationResult (``:45-56``),
Read pair (``:72-87``), Write1ToServer (``:92-97``), Grant/MultiGrant
(``:107-124``), WriteCertificate (``:126-130``), Write1Ok/Write1Refused
(``:133-161``), Write2 pair (``:102-105,144-147``), RequestFailed (``:168-174``),
Hello ping pair (``:176-192``), and the ProtocolMessage envelope (``:194-213``)
— **plus** the signature fields the reference declared and never implemented
(``MochiProtocol.proto:116,123``; ``mochiDB.tex:135,202``): every MultiGrant
and every envelope carries an Ed25519 signature over canonical mcode bytes.

Messages are frozen dataclasses.  ``to_obj``/``from_obj`` convert to/from the
plain structures that :mod:`mochi_tpu_torch.protocol.codec` encodes; the envelope's
wire form is ``encode([tag, obj])``.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field, replace
from enum import IntEnum
from functools import cached_property
from types import MappingProxyType
from typing import Any, Dict, Mapping, Optional, Tuple, Type

from .codec import decode, decode_env, encode


def _frozen_map(d: "Mapping") -> "Mapping":
    """Read-only view for a payload's nested dict field.

    Payload dataclasses are ``frozen=True``, but a frozen dataclass only
    locks its ATTRIBUTES — a dict-valued field stayed mutable, and the
    envelope layer caches each payload's mcode encoding on the object
    (``Envelope._six_bytes`` / ``__dict__["_mcode"]``), so one post-
    construction ``mg.grants[k] = ...`` would silently desync the signing
    bytes from the object's contents.  A ``mappingproxy``
    makes that mutation raise ``TypeError`` at the mutation site instead.
    Encoding never sees the proxy (``to_obj`` builds fresh plain dicts);
    equality against plain dicts is preserved (proxy delegates ``__eq__``).
    """
    if isinstance(d, MappingProxyType):
        return d  # replace()/copy paths re-enter __post_init__; don't re-wrap
    return MappingProxyType(dict(d))


class Action(IntEnum):
    """Operation verbs (ref: ``MochiProtocol.proto:22-27``)."""

    READ = 0
    WRITE = 1
    DELETE = 2


class Status(IntEnum):
    """Per-operation / per-grant status (ref: ``MochiProtocol.proto:29-33,49-55``)."""

    OK = 0
    WRONG_SHARD = 1
    REFUSED = 2  # grant denied: timestamp already taken by another transaction


class FailType(IntEnum):
    """Request-failure taxonomy (ref: ``MochiProtocol.proto:168-174``)."""

    OLD_REQUEST = 0
    BAD_SIGNATURE = 1  # new: message failed signature verification
    BAD_CERTIFICATE = 2  # new: write certificate failed quorum/signature checks
    BAD_REQUEST = 3  # new: request failed input validation (e.g. seed range)
    OVERLOADED = 4  # new: admission control shed this request; retry with backoff
    # new: the sender's per-client outstanding-grant quota is exhausted
    # (server/store.py CLIENT_GRANT_QUOTA) — flow control against grant
    # hoarding, carried with a retry-after hint like OVERLOADED; an honest
    # client only sees it while its own earlier grants are still pending
    # commit/GC, so backing off and retrying is always the right response.
    QUOTA_EXCEEDED = 5


# Decode-path enum lookup: Enum.__call__ is ~3x a dict hit and these run on
# every operation/grant of every message.  Unknown values must stay a
# ValueError (fail-closed decode, same taxonomy as the enum constructor).
_ACTIONS = {int(a): a for a in Action}
_STATUSES = {int(s): s for s in Status}


def _enum(table, value, enum_cls):
    try:
        return table[value]
    except (KeyError, TypeError):
        raise ValueError(f"{value!r} is not a valid {enum_cls.__name__}") from None


# --------------------------------------------------------------------------
# Transactions


@dataclass(frozen=True)
class Operation:
    """One read/write/delete (ref: ``MochiProtocol.proto:20-39``;
    operand1=key, operand2=value)."""

    action: Action
    key: str
    value: Optional[bytes] = None

    def to_obj(self) -> Any:
        return [int(self.action), self.key, self.value]

    @classmethod
    def from_obj(cls, obj: Any) -> "Operation":
        # Hot decode path (every op of every txn on every replica): skip the
        # frozen-dataclass __init__ (one object.__setattr__ per field) and
        # the enum __call__ — measured ~5% of cluster CPU in config-1.
        action, key, value = obj
        op = object.__new__(cls)
        op.__dict__.update(action=_enum(_ACTIONS, action, Action), key=key, value=value)
        return op


@dataclass(frozen=True)
class Transaction:
    """Ordered multi-key operation list (ref: ``MochiProtocol.proto:41-43``)."""

    operations: Tuple[Operation, ...]

    def to_obj(self) -> Any:
        return [op.to_obj() for op in self.operations]

    @classmethod
    def from_obj(cls, obj: Any) -> "Transaction":
        return cls(tuple(Operation.from_obj(o) for o in obj))

    @property
    def keys(self) -> Tuple[str, ...]:
        return tuple(op.key for op in self.operations)


def transaction_hash(txn: Transaction) -> bytes:
    """SHA-512 over the canonical encoding of the transaction.

    The reference hashes Java serialization bytes (``Utils.java:135-153``);
    mcode gives a language-independent canonical form instead.
    """
    return hashlib.sha512(b"mochi.txn\x00" + encode(txn.to_obj())).digest()


# --------------------------------------------------------------------------
# Grants and certificates


@dataclass(frozen=True)
class Grant:
    """Per-object write grant for a prospective timestamp
    (ref: ``MochiProtocol.proto:107-113``)."""

    object_id: str
    timestamp: int
    configstamp: int
    transaction_hash: bytes
    status: Status = Status.OK

    def to_obj(self) -> Any:
        return [self.object_id, self.timestamp, self.configstamp, self.transaction_hash, int(self.status)]

    @classmethod
    def from_obj(cls, obj: Any) -> "Grant":
        oid, ts, cs, th, st = obj
        g = object.__new__(cls)
        g.__dict__.update(
            object_id=oid, timestamp=ts, configstamp=cs,
            transaction_hash=th, status=_enum(_STATUSES, st, Status),
        )
        return g


@dataclass(frozen=True)
class MultiGrant:
    """All grants a single server issues for one Write1, Ed25519-signed by
    that server (ref: ``MochiProtocol.proto:116-124`` — "MultiGrant, which is
    signed"; the ``// TODO: add signature`` is implemented here)."""

    grants: Dict[str, Grant]  # object_id -> Grant
    client_id: str
    server_id: str
    signature: Optional[bytes] = None

    def __post_init__(self) -> None:
        object.__setattr__(self, "grants", _frozen_map(self.grants))

    def signing_bytes(self) -> bytes:
        """Canonical bytes covered by the server's signature (excludes the
        signature field itself)."""
        return b"mochi.mgrant\x00" + encode(
            [self.server_id, self.client_id, {k: g.to_obj() for k, g in self.grants.items()}]
        )

    def with_signature(self, sig: bytes) -> "MultiGrant":
        return replace(self, signature=sig)

    def to_obj(self) -> Any:
        return [
            {k: g.to_obj() for k, g in self.grants.items()},
            self.client_id,
            self.server_id,
            self.signature,
        ]

    @classmethod
    def from_obj(cls, obj: Any) -> "MultiGrant":
        grants, client_id, server_id, sig = obj
        mg = object.__new__(cls)
        mg.__dict__.update(
            # decode path bypasses __init__ (and thus __post_init__): wrap
            # here too, same invariant as constructed instances
            grants=MappingProxyType({k: Grant.from_obj(g) for k, g in grants.items()}),
            client_id=client_id, server_id=server_id, signature=sig,
        )
        return mg


@dataclass(frozen=True)
class WriteCertificate:
    """2f+1 signed MultiGrants assembled by the client
    (ref: ``MochiProtocol.proto:126-130``)."""

    grants: Dict[str, MultiGrant]  # server_id -> MultiGrant

    def __post_init__(self) -> None:
        object.__setattr__(self, "grants", _frozen_map(self.grants))

    def to_obj(self) -> Any:
        return {sid: mg.to_obj() for sid, mg in self.grants.items()}

    @classmethod
    def from_obj(cls, obj: Any) -> "WriteCertificate":
        return cls({sid: MultiGrant.from_obj(mg) for sid, mg in obj.items()})


@dataclass(frozen=True)
class OperationResult:
    """Per-operation outcome (ref: ``MochiProtocol.proto:45-56``)."""

    value: Optional[bytes] = None
    current_certificate: Optional[WriteCertificate] = None
    existed: bool = False
    status: Status = Status.OK

    def to_obj(self) -> Any:
        cc = self.current_certificate.to_obj() if self.current_certificate else None
        return [self.value, cc, self.existed, int(self.status)]

    @classmethod
    def from_obj(cls, obj: Any) -> "OperationResult":
        value, cc, existed, st = obj
        res = object.__new__(cls)
        res.__dict__.update(
            value=value,
            current_certificate=WriteCertificate.from_obj(cc) if cc is not None else None,
            existed=existed, status=_enum(_STATUSES, st, Status),
        )
        return res


@dataclass(frozen=True)
class TransactionResult:
    """Results aligned with the transaction's operation order
    (ref: ``MochiProtocol.proto:58-70``)."""

    operations: Tuple[OperationResult, ...]

    def to_obj(self) -> Any:
        return [op.to_obj() for op in self.operations]

    @classmethod
    def from_obj(cls, obj: Any) -> "TransactionResult":
        return cls(tuple(OperationResult.from_obj(o) for o in obj))


# --------------------------------------------------------------------------
# Request / response payloads


@dataclass(frozen=True)
class ReadToServer:
    """1-round-trip read request (ref: ``MochiProtocol.proto:72-80``)."""

    client_id: str
    transaction: Transaction
    nonce: str

    def to_obj(self) -> Any:
        return [self.client_id, self.transaction.to_obj(), self.nonce]

    @classmethod
    def from_obj(cls, obj: Any) -> "ReadToServer":
        cid, txn, nonce = obj
        return cls(cid, Transaction.from_obj(txn), nonce)


@dataclass(frozen=True)
class ReadFromServer:
    """Read response (ref: ``MochiProtocol.proto:82-87``)."""

    result: TransactionResult
    nonce: str
    rid: str

    def to_obj(self) -> Any:
        return [self.result.to_obj(), self.nonce, self.rid]

    @classmethod
    def from_obj(cls, obj: Any) -> "ReadFromServer":
        res, nonce, rid = obj
        return cls(TransactionResult.from_obj(res), nonce, rid)


@dataclass(frozen=True)
class Write1ToServer:
    """Phase-1 write: request grants at epoch+seed
    (ref: ``MochiProtocol.proto:92-97``)."""

    client_id: str
    transaction: Transaction
    seed: int
    transaction_hash: bytes

    def to_obj(self) -> Any:
        return [self.client_id, self.transaction.to_obj(), self.seed, self.transaction_hash]

    @classmethod
    def from_obj(cls, obj: Any) -> "Write1ToServer":
        cid, txn, seed, th = obj
        return cls(cid, Transaction.from_obj(txn), seed, th)


@dataclass(frozen=True)
class Write1OkFromServer:
    """All grants issued (ref: ``MochiProtocol.proto:133-138``)."""

    multi_grant: MultiGrant
    current_certificates: Dict[str, WriteCertificate] = field(default_factory=dict)

    def __post_init__(self) -> None:
        object.__setattr__(
            self, "current_certificates", _frozen_map(self.current_certificates)
        )

    def to_obj(self) -> Any:
        return [self.multi_grant.to_obj(), {k: c.to_obj() for k, c in self.current_certificates.items()}]

    @classmethod
    def from_obj(cls, obj: Any) -> "Write1OkFromServer":
        mg, ccs = obj
        return cls(MultiGrant.from_obj(mg), {k: WriteCertificate.from_obj(c) for k, c in ccs.items()})


@dataclass(frozen=True)
class Write1RefusedFromServer:
    """Some grant denied: carries the conflicting state
    (ref: ``MochiProtocol.proto:153-161``)."""

    multi_grant: MultiGrant  # statuses indicate per-object grant/refusal
    current_certificates: Dict[str, WriteCertificate] = field(default_factory=dict)
    client_id: str = ""

    def __post_init__(self) -> None:
        object.__setattr__(
            self, "current_certificates", _frozen_map(self.current_certificates)
        )

    def to_obj(self) -> Any:
        return [
            self.multi_grant.to_obj(),
            {k: c.to_obj() for k, c in self.current_certificates.items()},
            self.client_id,
        ]

    @classmethod
    def from_obj(cls, obj: Any) -> "Write1RefusedFromServer":
        mg, ccs, cid = obj
        return cls(
            MultiGrant.from_obj(mg),
            {k: WriteCertificate.from_obj(c) for k, c in ccs.items()},
            cid,
        )


@dataclass(frozen=True)
class Write2ToServer:
    """Phase-2 write: commit with certificate (ref: ``MochiProtocol.proto:144-147``)."""

    write_certificate: WriteCertificate
    transaction: Transaction

    def to_obj(self) -> Any:
        return [self.write_certificate.to_obj(), self.transaction.to_obj()]

    @classmethod
    def from_obj(cls, obj: Any) -> "Write2ToServer":
        wc, txn = obj
        return cls(WriteCertificate.from_obj(wc), Transaction.from_obj(txn))


@dataclass(frozen=True)
class Write2AnsFromServer:
    """Write2 response (ref: ``MochiProtocol.proto:102-105``)."""

    result: TransactionResult
    rid: str

    def to_obj(self) -> Any:
        return [self.result.to_obj(), self.rid]

    @classmethod
    def from_obj(cls, obj: Any) -> "Write2AnsFromServer":
        res, rid = obj
        return cls(TransactionResult.from_obj(res), rid)


@dataclass(frozen=True)
class RequestFailedFromServer:
    """Typed failure response (ref: ``MochiProtocol.proto:168-174``).

    ``retry_after_ms`` (OVERLOADED only, 0 = no hint): the replica's
    backlog-drain estimate — the client's backoff path waits at least this
    long (jittered) before retrying, so a shedding cluster is not hammered
    at the client's loopback-sized retry cadence."""

    fail_type: FailType
    detail: str = ""
    retry_after_ms: int = 0

    def to_obj(self) -> Any:
        # The third element rides the wire only when it carries
        # information, so every failure EXCEPT a hinted OVERLOADED shed
        # stays byte-identical to the two-element form.  Same upgrade
        # posture as SyncRequestToServer's prefix field: new readers
        # tolerate the old form; an old reader facing the NEW form (a
        # hinted shed from an upgraded replica) fails decode and recovers
        # by timeout — upgrade replicas before long-lived clients if shed
        # hints matter during the transition.
        if self.retry_after_ms:
            return [int(self.fail_type), self.detail, self.retry_after_ms]
        return [int(self.fail_type), self.detail]

    @classmethod
    def from_obj(cls, obj: Any) -> "RequestFailedFromServer":
        # tolerate the 2-field pre-retry-after wire form (rolling upgrades)
        ft, detail = obj[:2]
        retry_after_ms = obj[2] if len(obj) > 2 else 0
        return cls(FailType(ft), detail, retry_after_ms)


@dataclass(frozen=True)
class HelloToServer:
    """Ping (ref: ``MochiProtocol.proto:176-183``)."""

    message: str = "hello"

    def to_obj(self) -> Any:
        return [self.message]

    @classmethod
    def from_obj(cls, obj: Any) -> "HelloToServer":
        return cls(obj[0])


@dataclass(frozen=True)
class HelloFromServer:
    """Pong (ref: ``MochiProtocol.proto:185-192``)."""

    message: str = "hello back"

    def to_obj(self) -> Any:
        return [self.message]

    @classmethod
    def from_obj(cls, obj: Any) -> "HelloFromServer":
        return cls(obj[0])


# --------------------------------------------------------------------------
# State-transfer / resync (the paper's UptoSpeed, ``mochiDB.tex:168-169`` —
# declared but never implemented in the reference; SURVEY.md §5 "failure
# detection").  Trustless by construction: a sync entry carries the full
# (transaction, write certificate) pair of the last commit, so the receiver
# validates it through the exact Write2 path (2f+1 signed grants, hash
# match, staleness check) — a Byzantine peer cannot forge state.


@dataclass(frozen=True)
class SyncEntry:
    """Last committed state of one object: (key, transaction, certificate)."""

    key: str
    transaction: Transaction
    certificate: WriteCertificate

    def to_obj(self) -> Any:
        return [self.key, self.transaction.to_obj(), self.certificate.to_obj()]

    @classmethod
    def from_obj(cls, obj: Any) -> "SyncEntry":
        key, txn, wc = obj
        return cls(key, Transaction.from_obj(txn), WriteCertificate.from_obj(wc))


@dataclass(frozen=True)
class SyncRequestToServer:
    """Pull request: give me your committed state for these keys (None = all
    keys you hold).  Pages of ``max_entries``, keys sorted ascending; pass
    the last key of the previous page as ``after_key`` to continue.
    ``prefix`` filters server-side — resync pulls the ``_CONFIG_`` keyspace
    FIRST so historical config archives are learned before the data
    certificates that need them."""

    keys: Optional[Tuple[str, ...]] = None
    max_entries: int = 1024
    after_key: Optional[str] = None
    prefix: Optional[str] = None

    def to_obj(self) -> Any:
        return [
            list(self.keys) if self.keys is not None else None,
            self.max_entries,
            self.after_key,
            self.prefix,
        ]

    @classmethod
    def from_obj(cls, obj: Any) -> "SyncRequestToServer":
        # tolerate the 3-field pre-prefix wire form (rolling upgrades)
        keys, max_entries, after_key = obj[:3]
        prefix = obj[3] if len(obj) > 3 else None
        return cls(tuple(keys) if keys is not None else None, max_entries, after_key, prefix)


@dataclass(frozen=True)
class SyncEntriesFromServer:
    """Response: committed entries (each independently verifiable)."""

    entries: Tuple[SyncEntry, ...]

    def to_obj(self) -> Any:
        return [e.to_obj() for e in self.entries]

    @classmethod
    def from_obj(cls, obj: Any) -> "SyncEntriesFromServer":
        return cls(tuple(SyncEntry.from_obj(e) for e in obj))


@dataclass(frozen=True)
class SyncDigestRequestToServer:
    """Anti-entropy digest pull (round 14: incremental state transfer).

    Full resync used to ship every (transaction, certificate) pair the
    peer held — megabytes to learn "you already match".  This message
    pair makes the exchange proportional to the DIFFERENCE instead, two
    granularities over one request type:

    * ``tokens=None`` — SHARD level: the peer rolls every token-ring
      shard it holds committed state for into ``(token, n_keys,
      digest)`` where ``digest`` XORs the per-key digests (order
      independent, so two replicas that applied the same commits in any
      order agree).  One small page covers the whole ring.
    * ``tokens=(...)`` — KEY level for exactly those shards: pages of
      ``(key, digest16)`` so the puller can name the differing keys.

    Digests are derived from the last committed transaction hash — the
    same hash the 2f+1 grant quorum signed — so a lying digest can at
    worst cause a redundant pull or a skipped pull of state the peer
    could not prove anyway; the actual transfer stays the certificate-
    validated ``SyncRequestToServer`` path.
    """

    tokens: Optional[Tuple[int, ...]] = None
    max_entries: int = 4096
    after_key: Optional[str] = None

    def to_obj(self) -> Any:
        return [
            list(self.tokens) if self.tokens is not None else None,
            self.max_entries,
            self.after_key,
        ]

    @classmethod
    def from_obj(cls, obj: Any) -> "SyncDigestRequestToServer":
        tokens, max_entries, after_key = obj
        return cls(
            tuple(int(t) for t in tokens) if tokens is not None else None,
            max_entries,
            after_key,
        )


@dataclass(frozen=True)
class SyncDigestFromServer:
    """Digest page: shard rollups (``tokens=None`` requests) or per-key
    digests (shard-targeted requests).  Exactly one of the two is set."""

    shards: Optional[Tuple[Tuple[int, int, bytes], ...]] = None
    keys: Optional[Tuple[Tuple[str, bytes], ...]] = None

    def to_obj(self) -> Any:
        return [
            [list(s) for s in self.shards] if self.shards is not None else None,
            [list(k) for k in self.keys] if self.keys is not None else None,
        ]

    @classmethod
    def from_obj(cls, obj: Any) -> "SyncDigestFromServer":
        shards, keys = obj
        return cls(
            tuple((int(t), int(n), bytes(d)) for t, n, d in shards)
            if shards is not None
            else None,
            tuple((str(k), bytes(d)) for k, d in keys)
            if keys is not None
            else None,
        )


@dataclass(frozen=True)
class NudgeSyncToServer:
    """Client hint: your grants for these keys lag the quorum — resync.
    Advisory only (the replica pulls and re-validates from its peers)."""

    keys: Tuple[str, ...]

    def to_obj(self) -> Any:
        return [list(self.keys)]

    @classmethod
    def from_obj(cls, obj: Any) -> "NudgeSyncToServer":
        return cls(tuple(obj[0]))


@dataclass(frozen=True)
class SyncAckFromServer:
    """Nudge acknowledgement: how many keys were scheduled for resync."""

    scheduled: int = 0

    def to_obj(self) -> Any:
        return [self.scheduled]

    @classmethod
    def from_obj(cls, obj: Any) -> "SyncAckFromServer":
        return cls(obj[0])


# --------------------------------------------------------------------------
# Verifier offload RPC (the north star's "gRPC sidecar" boundary,
# BASELINE.json: replica processes ship signature batches to the one process
# that owns the TPU).  In-process clusters don't need it; a real
# ``start_cluster.sh`` cluster is N separate processes and a chip has one
# owner, so N-1 of them would otherwise be stuck on the CPU path.


@dataclass(frozen=True)
class VerifyRequestToServer:
    """A batch of Ed25519 checks: [(public_key, message, signature), ...]."""

    items: Tuple[Tuple[bytes, bytes, bytes], ...]

    def to_obj(self) -> Any:
        return [[pk, msg, sig] for pk, msg, sig in self.items]

    @classmethod
    def from_obj(cls, obj: Any) -> "VerifyRequestToServer":
        return cls(tuple((pk, msg, sig) for pk, msg, sig in obj))


@dataclass(frozen=True)
class VerifyBitmapFromServer:
    """Validity bitmap aligned with the request's item order."""

    bitmap: Tuple[bool, ...]

    def to_obj(self) -> Any:
        return [bool(b) for b in self.bitmap]

    @classmethod
    def from_obj(cls, obj: Any) -> "VerifyBitmapFromServer":
        return cls(tuple(bool(b) for b in obj))


# --------------------------------------------------------------------------
# Session handshake (``crypto/session.py``): X25519 key agreement carried in
# Ed25519-signed envelopes; afterwards envelopes authenticate with a session
# MAC (~60x cheaper per hop) and Ed25519 is reserved for MultiGrants — the
# transferable quorum evidence a MAC could never provide.


@dataclass(frozen=True)
class SessionInitToServer:
    """Initiator's ephemeral X25519 public key + nonce (envelope must be
    Ed25519-signed; the signature is what stops a MITM key substitution)."""

    x25519_public: bytes
    nonce: bytes

    def to_obj(self) -> Any:
        return [self.x25519_public, self.nonce]

    @classmethod
    def from_obj(cls, obj: Any) -> "SessionInitToServer":
        return cls(obj[0], obj[1])


@dataclass(frozen=True)
class SessionAckFromServer:
    """Responder's half of the handshake (also Ed25519-signed)."""

    x25519_public: bytes
    nonce: bytes

    def to_obj(self) -> Any:
        return [self.x25519_public, self.nonce]

    @classmethod
    def from_obj(cls, obj: Any) -> "SessionAckFromServer":
        return cls(obj[0], obj[1])


# --------------------------------------------------------------------------
# Session checkpoints (round 18, ``crypto/session.py``): the fast path's
# retroactive identity binding.  Every CHECKPOINT_MSGS MAC'd envelopes (or
# CHECKPOINT_MS) the sender Ed25519-signs the digest list of everything it
# sealed in the window; the receiver's CheckpointLedger demands its accepted
# multiset be covered — a MAC forgery or replay is convicted with the signed
# declaration as transferable evidence.  Checkpoint envelopes themselves are
# ALWAYS signed: a MAC'd checkpoint is by definition a downgrade attempt.


@dataclass(frozen=True)
class SessionCheckpointToServer:
    """Signed declaration: digests of every MAC'd envelope the sender
    sealed on this session since its last verified checkpoint."""

    window: int
    digests: Tuple[bytes, ...]

    def to_obj(self) -> Any:
        return [self.window, list(self.digests)]

    @classmethod
    def from_obj(cls, obj: Any) -> "SessionCheckpointToServer":
        return cls(int(obj[0]), tuple(bytes(d) for d in obj[1]))


@dataclass(frozen=True)
class SessionCheckpointAckFromServer:
    """Receiver verdict on a checkpoint window (signed, answered in-kind).
    ``ok=False`` never rides this payload — mismatches are refused typed
    (BAD_CERTIFICATE) so the sender's failure handling is uniform."""

    window: int
    accepted: int  # messages the receiver had accepted in this window

    def to_obj(self) -> Any:
        return [self.window, self.accepted]

    @classmethod
    def from_obj(cls, obj: Any) -> "SessionCheckpointAckFromServer":
        return cls(int(obj[0]), int(obj[1]))


# --------------------------------------------------------------------------
# Envelope

_PAYLOAD_TYPES: Tuple[Type, ...] = (
    ReadToServer,
    ReadFromServer,
    Write1ToServer,
    Write1OkFromServer,
    Write1RefusedFromServer,
    Write2ToServer,
    Write2AnsFromServer,
    RequestFailedFromServer,
    HelloToServer,
    HelloFromServer,
    SyncRequestToServer,
    SyncEntriesFromServer,
    NudgeSyncToServer,
    SyncAckFromServer,
    VerifyRequestToServer,  # appended: existing wire tags stay stable
    VerifyBitmapFromServer,
    SessionInitToServer,
    SessionAckFromServer,
    SyncDigestRequestToServer,  # appended: existing wire tags stay stable
    SyncDigestFromServer,
    SessionCheckpointToServer,  # appended: existing wire tags stay stable
    SessionCheckpointAckFromServer,
)
_TAG_BY_TYPE = {cls: i for i, cls in enumerate(_PAYLOAD_TYPES)}


@dataclass(frozen=True)
class Envelope:
    """Wire envelope: payload + correlation ids + sender + signature
    (ref: ``ProtocolMessage``, ``MochiProtocol.proto:194-213``; msg_id
    correlation replaces the reference's FIFO promise queue,
    ``MochiClientHandler.java:67-75``)."""

    payload: Any
    msg_id: str
    sender_id: str
    reply_to: Optional[str] = None
    timestamp_ms: int = 0
    signature: Optional[bytes] = None
    mac: Optional[bytes] = None  # session MAC (``crypto/session.py``)
    # Causal-trace context (obs/trace.py), a TOLERATED new wire
    # field: ``(trace_id_bytes, span_id_bytes, flags)`` rides as an
    # OPTIONAL 9th envelope element — absent (None, the default), the wire
    # form is byte-identical to the untraced form, and current readers
    # accept both arities.  Tolerance is one-directional: an older
    # reader rejects the 9-element form at decode, so mixed-version
    # clusters must keep tracing off until the fleet is upgraded
    # (docs/OPERATIONS.md §4j "Upgrade posture").  Deliberately OUTSIDE
    # the signed prefix: the context is advisory observability, so a
    # tamperer can at worst mis-attribute spans, never influence a
    # protocol decision — and keeping it out of ``signing_bytes`` means
    # attaching/stripping it can never invalidate a signature or MAC
    # computed by an older peer.
    trace: Optional[tuple] = None

    @cached_property
    def _payload_obj(self) -> Any:
        # Each envelope is encoded twice per side (auth bytes + wire bytes);
        # the payload tree dominates both, so build it once.  Sound because
        # payloads are frozen dataclasses.  cached_property writes straight
        # to __dict__, bypassing the frozen __setattr__.
        return self.payload.to_obj()

    @cached_property
    def _six_bytes(self) -> bytes:
        """mcode encoding of the 6 authenticated fields (a 6-element list).

        This is the one payload-tree walk per envelope: the wire encoding is
        assembled from it by concatenation (``encode_envelope``), and
        receivers recover it as a *slice* of the incoming frame
        (``decode_envelope``), so neither side ever encodes the tree twice.
        The 2-byte header is always T_LIST + varint(6) = b"\\x07\\x06".

        The PAYLOAD's encoding is additionally cached on the payload object
        itself (``__dict__["_mcode"]``, bypassing the frozen ``__setattr__``
        like ``cached_property`` does): a client fan-out wraps ONE payload
        in n per-target envelopes (distinct msg_id + session MAC), and at
        n=64 with a 9.8 KB 43-grant certificate the payload tree walk was
        96% of each envelope's encode cost, paid 64 times per Write2
        (config-6 profile).  mcode is concatenative, so splicing the
        cached element bytes between the freshly encoded tag and tail
        produces byte-identical output — pinned by
        ``tests/test_messages.py::test_six_bytes_splice_is_byte_identical``.
        """
        tag = _TAG_BY_TYPE[type(self.payload)]
        pd = self.payload.__dict__
        pb = pd.get("_mcode")
        if pb is None:
            pb = encode(self._payload_obj)
            pd["_mcode"] = pb
        tail = encode(
            [self.msg_id, self.sender_id, self.reply_to, self.timestamp_ms]
        )
        return b"\x07\x06" + encode(tag) + pb + tail[2:]

    def signing_bytes(self) -> bytes:
        """Canonical bytes covered by BOTH auth mechanisms (signature or
        session MAC) — everything except the auth fields themselves."""
        return b"mochi.env\x00" + self._six_bytes

    def _with_cache(self, **changes) -> "Envelope":
        # Copy-with-changes without dataclasses.replace(): replace() re-runs
        # the frozen __init__ (object.__setattr__ per field) and this runs
        # once or twice per message on the cluster hot path.  A __dict__
        # copy also carries the cached _payload_obj along for free.
        env = object.__new__(Envelope)
        env.__dict__.update(self.__dict__)
        env.__dict__.update(changes)
        return env

    def with_signature(self, sig: bytes) -> "Envelope":
        return self._with_cache(signature=sig)

    def with_mac(self, tag: bytes) -> "Envelope":
        return self._with_cache(mac=tag)


def _enc_auth(v: Optional[bytes]) -> bytes:
    """Encode one auth field (None or short bytes) — the trailing two wire
    elements.  Signatures are 64 bytes and MACs 32, so the varint length is
    a single byte; the general encoder handles anything longer."""
    if v is None:
        return b"\x00"  # T_NONE
    if len(v) < 0x80:
        return b"\x05" + bytes((len(v),)) + v  # T_BYTES + 1-byte varint
    return encode(v)


def encode_envelope(env: Envelope) -> bytes:
    # Wire = T_LIST(8) + the cached 6 authenticated elements + sig + mac.
    # The seal/sign step already computed _six_bytes (signing_bytes), and
    # with_mac/with_signature carry the cache, so this is pure concatenation.
    # A trace context (round 15) appends as a 9th, UNauthenticated element
    # — emitted only when present, so untraced traffic stays byte-identical
    # to the pre-trace wire form (and on the native decode fast path).
    base = env._six_bytes[2:] + _enc_auth(env.signature) + _enc_auth(env.mac)
    if env.trace is None:
        return b"\x07\x08" + base
    return b"\x07\x09" + base + encode(list(env.trace))


def decode_envelope(data: bytes) -> Envelope:
    # Canonical-header check: the signed-prefix reconstruction below
    # assumes the outer varint is the single byte 0x08 — or 0x09 for the
    # traced form.  The codec readers reject non-minimal varints too; this
    # guard keeps the _six_bytes slice sound whichever codec decoded the
    # frame.
    if len(data) < 2 or data[1] not in (0x08, 0x09):
        raise ValueError("mcode: envelope header must be canonical T_LIST(8|9)")
    vals, off6 = decode_env(data)
    tag, payload_obj, msg_id, sender_id, reply_to, ts, sig, mac = vals[:8]
    trace = None
    if len(vals) > 8 and isinstance(vals[8], list) and len(vals[8]) == 3:
        # Advisory field: anything malformed decodes as "no trace" rather
        # than costing the (validly authenticated) envelope that carried it
        # — obs.trace.TraceContext.from_wire re-validates the element types.
        trace = tuple(vals[8])
    if not 0 <= tag < len(_PAYLOAD_TYPES):
        raise ValueError(f"unknown payload tag {tag}")
    payload = _PAYLOAD_TYPES[tag].from_obj(payload_obj)
    env = object.__new__(Envelope)  # skip the frozen-dataclass __init__
    env.__dict__.update(
        payload=payload,
        msg_id=msg_id,
        sender_id=sender_id,
        reply_to=reply_to,
        timestamp_ms=ts,
        signature=sig,
        mac=mac,
        trace=trace,
        # The signed prefix is a contiguous slice of the frame: recovering
        # it here means authenticating this envelope (signing_bytes) never
        # re-encodes the payload tree it just decoded.
        _payload_obj=payload_obj,
        _six_bytes=b"\x07\x06" + bytes(data[2:off6]),
    )
    return env
