"""Host-side Ed25519 signing and verification.

The reference *declares* signatures and never implements them
(``MochiProtocol.proto:123`` "TODO: add signature"; ``mochiDB.tex:202`` "Our
implementation lacks PKI support").  Here they are first-class: replicas and
clients hold Ed25519 keypairs; signing and the default CPU verify path use the
host ``cryptography`` library (OpenSSL) — the "BouncyCastle analog" of
BASELINE.json — while the device batch-verify path lives in
:mod:`mochi_tpu_torch.crypto.batch_verify`.

``cryptography`` is optional: on a bare ``numpy+torch+pytest`` environment the
import below fails soft and every operation routes to the pure-Python
fallback (:mod:`mochi_tpu_torch.crypto.hostfallback`, built on the repo's own
curve arithmetic).  Verdicts are identical either way — strict canonical
prechecks here, then the cofactorless check — so mixed clusters agree on
every signature.  The fallback import is deferred to first use: with OpenSSL
present it never loads.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

try:  # optional accelerator; see module docstring
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives.asymmetric.ed25519 import (
        Ed25519PrivateKey,
        Ed25519PublicKey,
    )
    from cryptography.hazmat.primitives.serialization import (
        Encoding,
        NoEncryption,
        PrivateFormat,
        PublicFormat,
    )

    _HAVE_HOST_CRYPTO = True
except ImportError:  # pragma: no cover - exercised on bare environments
    import logging

    _HAVE_HOST_CRYPTO = False
    logging.getLogger(__name__).warning(
        "cryptography (OpenSSL) not installed: Ed25519/X25519 use the "
        "pure-Python fallback (~100x slower, variable-time). Production "
        "deployments should `pip install mochi-tpu[host-crypto]`."
    )


def _fallback():
    from . import hostfallback

    return hostfallback


@dataclass(frozen=True)
class KeyPair:
    """Raw Ed25519 keypair: 32-byte seed + 32-byte compressed public key."""

    private_seed: bytes
    public_key: bytes

    def sign(self, message: bytes) -> bytes:
        return sign(self.private_seed, message)


def generate_keypair() -> KeyPair:
    if not _HAVE_HOST_CRYPTO:
        import os

        seed = os.urandom(32)
        return KeyPair(seed, _fallback().public_from_seed(seed))
    priv = Ed25519PrivateKey.generate()
    seed = priv.private_bytes(Encoding.Raw, PrivateFormat.Raw, NoEncryption())
    pub = priv.public_key().public_bytes(Encoding.Raw, PublicFormat.Raw)
    return KeyPair(seed, pub)


def keypair_from_seed(seed: bytes) -> KeyPair:
    if not _HAVE_HOST_CRYPTO:
        return KeyPair(seed, _fallback().public_from_seed(seed))
    priv = Ed25519PrivateKey.from_private_bytes(seed)
    pub = priv.public_key().public_bytes(Encoding.Raw, PublicFormat.Raw)
    return KeyPair(seed, pub)


# Parsing raw bytes into OpenSSL key handles costs as much as the crypto op
# itself; replicas/clients reuse the same few keys for every message, so the
# parsed handles are cached (bounded: a cluster touches n_servers + clients).
@lru_cache(maxsize=4096)
def _private_key(private_seed: bytes) -> "Ed25519PrivateKey":
    return Ed25519PrivateKey.from_private_bytes(private_seed)


@lru_cache(maxsize=65536)
def _public_key(public_key: bytes) -> "Ed25519PublicKey":
    return Ed25519PublicKey.from_public_bytes(public_key)


def sign(private_seed: bytes, message: bytes) -> bytes:
    if not _HAVE_HOST_CRYPTO:
        return _fallback().sign(private_seed, message)
    return _private_key(private_seed).sign(message)


# Strict RFC 8032 canonical-encoding prechecks.  OpenSSL's ref10 decode
# accepts a handful of non-canonical point encodings (y >= p reduced mod p);
# the device path rejects them.  For BFT safety every replica must reach the
# SAME verdict on the same bytes regardless of which backend it runs, so the
# CPU path applies the identical strict prechecks before OpenSSL.
_P = (1 << 255) - 19
_L = (1 << 252) + 27742317777372353535851937790883648493


def _canonical(public_key: bytes, signature: bytes) -> bool:
    if len(public_key) != 32 or len(signature) != 64:
        return False
    y_a = int.from_bytes(public_key, "little") & ((1 << 255) - 1)
    y_r = int.from_bytes(signature[:32], "little") & ((1 << 255) - 1)
    s = int.from_bytes(signature[32:], "little")
    if public_key[31] & 0x80 and y_a in (1, _P - 1):
        # x = 0 with the sign bit set has no decoding (RFC 8032 section
        # 5.1.3 step 4).  The device path and the pure-Python engine reject
        # such a key; OpenSSL's decoder accepts it as x = 0, so it is
        # refused here, before any engine, to keep every engine's verdict
        # the same.  (R needs no such check: OpenSSL re-encodes R, and the
        # encoding of an x = 0 point never carries the sign bit.)
        return False
    return y_a < _P and y_r < _P and s < _L


def host_crypto_engine() -> str:
    """Which engine :func:`verify` routes to on THIS host: ``"openssl"``
    (the ``cryptography`` wheel), ``"native-c"`` (the lazily-built
    ``native/hbatch.c`` verification engine), or ``"pure-python"`` (the
    :mod:`~mochi_tpu_torch.crypto.hostfallback` bignum engine).  Benchmark
    records stamp this so the recurring "wheel-less host inflates write
    latency" caveat is machine-readable provenance, not prose
    (benchmarks/run_all.py, bench.py)."""
    if _HAVE_HOST_CRYPTO:
        return "openssl"
    try:
        return "native-c" if _fallback().has_native() else "pure-python"
    except Exception:  # pragma: no cover - loader breakage
        return "pure-python"


def register_known_signers(pubs) -> bool:
    """Pre-promote known signers (cluster replica identities) in the host
    verify engine; returns whether the hint reached an engine that uses it.

    With OpenSSL present this is a no-op (its verify has no per-signer
    state worth warming), and likewise with the native-C engine (its
    Straus ladder rebuilds the per-item table in-call; no signer state).
    On toolchain-less wheel-less hosts the pure-Python engine keeps
    per-signer fixed-window tables (:mod:`~mochi_tpu_torch.crypto.hostfallback`,
    the host analog of the device comb) that normally require two verified
    signatures to earn; pre-promotion makes the FIRST certificate check
    from a cluster identity run combed.  O(1) per key — table builds stay
    lazy (first verify), so boot cost is nil.
    """
    if _HAVE_HOST_CRYPTO:
        return False
    fb = _fallback()
    if fb.has_native():
        return False
    return fb.prime_signers(pubs)


def verify(public_key: bytes, message: bytes, signature: bytes) -> bool:
    """Single-signature CPU verify; returns False on any malformed input.

    Verdict is bit-for-bit identical to the device batch path
    (:mod:`mochi_tpu_torch.crypto.batch_verify`): strict canonical-encoding
    prechecks, then the cofactorless check (OpenSSL, or the pure-Python
    fallback when ``cryptography`` is absent).
    """
    if not _canonical(public_key, signature):
        return False
    if not _HAVE_HOST_CRYPTO:
        return _fallback().verify(public_key, message, signature)
    try:
        _public_key(public_key).verify(signature, message)
        return True
    except (InvalidSignature, ValueError):
        return False
