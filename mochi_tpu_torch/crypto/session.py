"""Authenticated session keys: X25519 ECDH bound to Ed25519 identities.

Why this exists (the trust-model argument, VERDICT r1 task 7): envelope
authentication is a *channel* property — each hop only needs the receiver to
know the bytes came from the claimed peer.  A MAC under a session key gives
exactly that at ~2 µs/message.  Ed25519 signatures (~120 µs verify on this
host) are reserved for the protocol artifacts that must be *transferable* —
MultiGrants inside write certificates, which replicas hand to other replicas
as third-party-checkable quorum evidence.  A MAC could never serve there
(anyone holding the session key can forge one); a channel doesn't need a
signature.  The reference has neither (it never authenticates anything —
SURVEY.md preamble); this completes its declared design the fast way.

Handshake (piggybacked on the normal envelope transport, see
``protocol.messages.SessionInitToServer``): initiator sends a fresh X25519
public key + nonce in an Ed25519-signed envelope; responder replies with its
own, also signed.  Both derive

    key = HKDF-SHA256(X25519(a, B), info = ids || nonces || "mochi.session")

A MITM cannot substitute X25519 keys without breaking the Ed25519 envelope
signatures, and the nonces bind the key to this handshake.  Session MACs
then cover the same canonical envelope bytes the signature would have
(``Envelope.signing_bytes``), so replay characteristics are identical to the
signature scheme (msg_id/timestamp are covered; the store's idempotency
handles redelivery either way).
"""

from __future__ import annotations

import hashlib
import hmac
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

try:  # optional accelerator — see crypto/keys.py; fallback is pure Python
    from cryptography.hazmat.primitives.asymmetric.x25519 import (
        X25519PrivateKey,
        X25519PublicKey,
    )
    from cryptography.hazmat.primitives.serialization import Encoding, PublicFormat

    _HAVE_HOST_CRYPTO = True
except ImportError:  # pragma: no cover - exercised on bare environments
    _HAVE_HOST_CRYPTO = False

_INFO = b"mochi.session.v1"


@dataclass(frozen=True)
class Handshake:
    """One side's ephemeral handshake state.

    ``private`` is an ``X25519PrivateKey`` handle when OpenSSL is available,
    or the raw 32-byte scalar when running on the pure-Python fallback —
    :func:`derive_key` dispatches on the type, so mixed clusters (one side
    with OpenSSL, one without) derive the same session key.
    """

    private: object
    public_bytes: bytes
    nonce: bytes


def new_handshake() -> Handshake:
    if not _HAVE_HOST_CRYPTO:
        from . import hostfallback

        seed = os.urandom(32)
        return Handshake(seed, hostfallback.x25519_public(seed), os.urandom(16))
    priv = X25519PrivateKey.generate()
    pub = priv.public_key().public_bytes(Encoding.Raw, PublicFormat.Raw)
    return Handshake(priv, pub, os.urandom(16))


def derive_key(
    hs: Handshake,
    peer_public: bytes,
    peer_nonce: bytes,
    initiator_id: str,
    responder_id: str,
    initiated: bool,
) -> bytes:
    """Both sides call this with the SAME (initiator, responder) ordering."""
    if isinstance(hs.private, (bytes, bytearray)):
        from . import hostfallback

        shared = hostfallback.x25519(hs.private, peer_public)
    else:
        shared = hs.private.exchange(X25519PublicKey.from_public_bytes(peer_public))
    if initiated:
        nonces = hs.nonce + peer_nonce
    else:
        nonces = peer_nonce + hs.nonce
    material = (
        shared
        + initiator_id.encode()
        + b"\x00"
        + responder_id.encode()
        + b"\x00"
        + nonces
    )
    # Single-block HKDF-extract/expand (output = one SHA256 block)
    prk = hmac.new(_INFO, material, hashlib.sha256).digest()
    return hmac.new(prk, b"\x01" + _INFO, hashlib.sha256).digest()


def mac(session_key: bytes, data: bytes) -> bytes:
    # hmac.digest is the one-shot C path (no HMAC-object construction);
    # on the cluster hot path this runs four times per message hop.
    return hmac.digest(session_key, data, "sha256")


def seal(envelope, session_key: bytes):
    """Attach the session MAC over an envelope's canonical auth bytes —
    the one sealing idiom shared by clients, replicas and the verifier
    service."""
    return envelope.with_mac(mac(session_key, envelope.signing_bytes()))


def mac_ok(session_key: bytes, data: bytes, tag: bytes) -> bool:
    return hmac.compare_digest(mac(session_key, data), tag)


# --------------------------------------------------------------------------
# Fast-path posture + signed checkpoints (round 18).
#
# The session MAC authenticates each envelope to the RECEIVER; it proves
# nothing to a third party, and if the session key ever leaks (or a session
# table is corrupted) the whole MAC window is unattributable.  Periodic
# signed checkpoints close that: every CHECKPOINT_MSGS messages (or
# CHECKPOINT_MS, whichever first) the sender Ed25519-signs the list of
# digests of every MAC'd envelope it sent since the last verified
# checkpoint.  The receiver, which recorded the digest of every MAC'd
# envelope it ACCEPTED, demands its accepted multiset be covered by the
# signed declaration — so any message the receiver accepted that the sender
# never signed for (a MAC forgery, a replay within or across windows) is
# convicted retroactively with transferable evidence, while messages the
# sender sent but the receiver never saw (drops, in-flight) are simply
# carried forward.  Declarations are ~DIGEST_LEN bytes per message,
# amortized: the fast path keeps per-message crypto at one HMAC while the
# identity binding arrives one signature per window.

#: Messages per checkpoint window (sender-side trigger).
CHECKPOINT_MSGS = int(os.environ.get("MOCHI_CHECKPOINT_MSGS", "512"))
#: Milliseconds per checkpoint window (sender-side trigger).
CHECKPOINT_MS = float(os.environ.get("MOCHI_CHECKPOINT_MS", "2000"))
#: Receiver-side hard cap: a sender this many accepted-but-unattested
#: messages behind gets typed refusals until it re-handshakes — a Byzantine
#: sender must not ride the MAC discount indefinitely while dodging the
#: signed audit trail.  4x the window tolerates ack loss + clock skew.
OVERDUE_FACTOR = 4

_CKPT_DOMAIN = b"mochi.ckpt.v1\x00"
DIGEST_LEN = 16  # 128-bit collision resistance: plenty for an audit ledger


def fast_path_enabled(explicit: Optional[bool] = None) -> bool:
    """Resolve the fast-path posture: an explicit constructor argument wins;
    otherwise the MOCHI_FAST_PATH env knob (default ON).  OFF means every
    envelope rides per-message Ed25519 and certificates verify grant by
    grant — the pre-round-18 posture, kept as the A/B and rollback leg."""
    if explicit is not None:
        return bool(explicit)
    return os.environ.get("MOCHI_FAST_PATH", "1") != "0"


def window_digest(signing_bytes: bytes) -> bytes:
    """Digest of one MAC'd envelope's canonical auth bytes as it appears in
    a checkpoint declaration (domain-separated from every other hash in the
    protocol)."""
    return hashlib.sha256(_CKPT_DOMAIN + signing_bytes).digest()[:DIGEST_LEN]


class SessionWindow:
    """Sender-side checkpoint state for ONE session: the digests of every
    MAC'd envelope sealed since the last VERIFIED checkpoint.

    ``take`` snapshots the current declaration without clearing it —
    concurrent sends during the checkpoint round trip simply append, and a
    lost checkpoint (or refused ack) keeps everything for the next attempt
    — and ``committed`` retires exactly the snapshot after a positive ack.
    """

    __slots__ = ("pending", "started_at", "window", "sent", "last_error")

    def __init__(self) -> None:
        self.pending: List[bytes] = []
        self.started_at = time.monotonic()
        self.window = 0
        self.sent = 0  # lifetime MAC'd envelopes noted (observability)
        self.last_error: Optional[str] = None

    def note(self, signing_bytes: bytes) -> None:
        self.pending.append(window_digest(signing_bytes))
        self.sent += 1

    def due(self) -> bool:
        if not self.pending:
            return False
        return (
            len(self.pending) >= CHECKPOINT_MSGS
            or (time.monotonic() - self.started_at) * 1e3 >= CHECKPOINT_MS
        )

    def overdue_risk(self) -> bool:
        """True when the unattested backlog nears the receiver's hard cap —
        the sender must checkpoint NOW or start eating typed refusals."""
        return len(self.pending) >= (OVERDUE_FACTOR - 1) * CHECKPOINT_MSGS

    def take(self) -> Tuple[int, Tuple[bytes, ...]]:
        """Snapshot (window, declaration) for a checkpoint attempt."""
        return self.window, tuple(self.pending)

    def committed(self, n: int) -> None:
        """Positive ack for a ``take`` snapshot of length ``n``."""
        del self.pending[:n]
        self.window += 1
        self.started_at = time.monotonic()


class CheckpointLedger:
    """Receiver-side audit ledger for ONE session: the digest multiset of
    every MAC'd envelope accepted since the last verified checkpoint, plus
    the carry of declared-but-not-yet-seen digests (messages signed for by
    the sender that are still in flight — or dropped — when the checkpoint
    lands).

    ``verify`` returns None when the signed declaration covers everything
    accepted; otherwise a human-readable reason — an accepted message the
    sender never signed for is exactly a MAC forgery or a replay, and the
    caller convicts with the declaration as transferable evidence.
    """

    __slots__ = ("accepted", "carry", "count_since", "verified_windows",
                 "mismatches")

    #: Declared-but-unseen digests carried across windows; past this the
    #: session state is no longer reconcilable (pathological loss) and the
    #: receiver demands a fresh handshake rather than risk convicting an
    #: honest sender on evicted carry.
    CARRY_MAX = 8192

    def __init__(self) -> None:
        self.accepted: Dict[bytes, int] = {}
        self.carry: Dict[bytes, int] = {}
        self.count_since = 0
        self.verified_windows = 0
        self.mismatches = 0

    def note(self, signing_bytes: bytes) -> bool:
        """Record one accepted MAC'd envelope.  False = the sender is past
        the overdue cap (caller refuses the envelope, typed)."""
        if self.count_since >= OVERDUE_FACTOR * CHECKPOINT_MSGS:
            return False
        h = window_digest(signing_bytes)
        c = self.carry.get(h)
        if c:  # already attested by a prior declaration: covered
            if c == 1:
                del self.carry[h]
            else:
                self.carry[h] = c - 1
            return True
        self.accepted[h] = self.accepted.get(h, 0) + 1
        self.count_since += 1
        return True

    def verify(self, declared: Sequence[bytes]) -> Optional[str]:
        """Check a signed declaration against the accepted multiset.  None
        on success (ledger advances); else the conviction reason (ledger
        state is kept — the evidence must outlive the verdict)."""
        remaining: Dict[bytes, int] = {}
        for h in declared:
            h = bytes(h)
            remaining[h] = remaining.get(h, 0) + 1
        for h, n in self.accepted.items():
            if remaining.get(h, 0) < n:
                self.mismatches += 1
                return (
                    "accepted MAC'd message absent from the signed "
                    "checkpoint declaration (forged or replayed in the "
                    "MAC window)"
                )
        for h, n in self.accepted.items():
            left = remaining[h] - n
            if left:
                remaining[h] = left
            else:
                del remaining[h]
        # declared-but-unseen: carry forward so late arrivals stay covered
        for h, n in remaining.items():
            self.carry[h] = self.carry.get(h, 0) + n
        if len(self.carry) > self.CARRY_MAX:
            return "carry overflow"  # caller resets the session, no conviction
        self.accepted.clear()
        self.count_since = 0
        self.verified_windows += 1
        return None

    def stats(self) -> Dict[str, int]:
        return {
            "unattested": self.count_since,
            "carry": sum(self.carry.values()),
            "verified_windows": self.verified_windows,
            "mismatches": self.mismatches,
        }
