"""Pure-Python Ed25519 + X25519 host fallback (no ``cryptography`` needed).

The host ``cryptography`` wheel (OpenSSL) is an *optional* accelerator: on a
bare ``numpy+torch+pytest`` environment :mod:`mochi_tpu_torch.crypto.keys` and
:mod:`mochi_tpu_torch.crypto.session` fall back to this module, so every layer —
replicas, clients, the verifier service, the whole test tree — runs without
it.  Built on the repo's own curve arithmetic: the constants and the
extended-coordinate a=-1 addition law below are the integer originals of
:mod:`mochi_tpu_torch.crypto.field` / :mod:`mochi_tpu_torch.crypto.curve` (same
add-2008-hwcd-3 formulas the device data plane runs; see ``curve.add``),
evaluated on Python ints instead of limb tensors.

Semantics match :func:`mochi_tpu_torch.crypto.keys.verify` exactly: callers run
the strict canonical-encoding prechecks first, then this module applies the
cofactorless check ``[S]B == R + [h]A`` — the same verdict OpenSSL and the
device batch path produce, so a mixed cluster (some nodes with OpenSSL, some
without) still agrees on every signature, which BFT safety requires.

NOT constant-time: Python big-int arithmetic is variable-time by nature and
the double-and-add ladder branches on scalar bits.  That is an accepted
property of the *fallback* (same posture as the reference's total absence
of crypto); production deployments install ``cryptography``.  The
variable-time operations are confined to this module so the constant-time
checker's scope stays meaningful everywhere else.

Native-C engine: on hosts with a toolchain but no ``cryptography`` wheel,
:func:`verify`, :func:`sign` and :func:`x25519` route through
``native/hbatch.c`` — full Ed25519 verification (Straus ladder on 51-bit
limbs, the same cofactorless check), deterministic RFC 8032 signing
(byte-identical to this module and OpenSSL — the replica's own-grant
re-sign-and-compare depends on that) and RFC 7748 X25519.  Differential
suite: ``tests/test_torch_native.py``.  Key expansion and the curve math
below stay pure Python: the fallback when no C toolchain exists, and the
implementation the native engine is tested against.
"""

from __future__ import annotations

import hashlib
from functools import lru_cache
from typing import Optional, Tuple

from .field import BX_INT, BY_INT, D_INT, L_INT, P_INT, SQRT_M1_INT

_P = P_INT
_L = L_INT
_D2 = (2 * D_INT) % _P

# Extended twisted-Edwards coordinates (X, Y, Z, T): x = X/Z, y = Y/Z,
# T = XY/Z — the exact layout of ``curve.Point``, on ints.
_Pt = Tuple[int, int, int, int]
_IDENT: _Pt = (0, 1, 1, 0)
_BASE: _Pt = (BX_INT, BY_INT, 1, (BX_INT * BY_INT) % _P)


def _pt_add(p: _Pt, q: _Pt) -> _Pt:
    """Complete unified addition (add-2008-hwcd-3, a=-1) — ``curve.add``
    on ints.  Complete: also serves as doubling and handles the identity."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % _P
    b = (y1 + x1) * (y2 + x2) % _P
    c = t1 * _D2 % _P * t2 % _P
    d = 2 * z1 * z2 % _P
    e = b - a
    f = d - c
    g = d + c
    h = b + a
    return (e * f % _P, g * h % _P, f * g % _P, e * h % _P)


def _scalar_mul(k: int, p: _Pt) -> _Pt:
    """Variable-base [k]P, MSB-first double-and-add (variable-time — see
    module docstring)."""
    acc = _IDENT
    for bit in bin(k)[2:] if k else "":
        acc = _pt_add(acc, acc)
        if bit == "1":
            acc = _pt_add(acc, p)
    return acc


@lru_cache(maxsize=1)
def _base_table() -> Tuple[Tuple[_Pt, ...], ...]:
    """Fixed-base window table: TB[w][d] = [d * 16^w]B for d in 0..15
    (built by ``_window_table``, defined with the signer comb).

    Makes a base-point multiply <=64 additions instead of ~256 doubles +
    ~128 adds — signing is the fallback's hot path (every envelope and
    every MultiGrant a replica issues goes through it)."""
    return _window_table(_BASE)


def _mul_base(k: int) -> _Pt:
    # NO zero-digit skip here, unlike _mul_signer: base multiplies run with
    # SECRET scalars (the signing nonce r, the private scalar a), and a
    # skip would make per-signature timing correlate with the nonce's
    # zero-nibble count — partial-nonce leakage is a known lattice vector
    # for key recovery.  The fallback is variable-time at the bignum level
    # regardless (module docstring), but there is no reason to add a
    # branch-per-secret-nibble on top for a ~6% saving.  _mul_signer's
    # skip is verify-only, where k = h is public.
    acc = _IDENT
    for w, row in enumerate(_base_table()):
        acc = _pt_add(acc, row[(k >> (4 * w)) & 15])
    return acc


# ---------------------------------------------------------------- signer comb
#
# Per-SIGNER window tables: the host analog of the device comb registry
# (crypto/comb.py) — a replica set re-verifies the same few cluster
# identities forever, so the variable-base half of every verify ([h]A, a
# ~380-addition double-and-add ladder) collapses to <=63 table additions
# once A's table exists.  Tables are built on a key's SECOND appearance
# (a counter, not the table, is the first-touch cost), so a one-shot
# forgery under a random key can never make us pay the ~960-addition
# build — repeat signers amortize it in two verifies.

_TABLE_PROMOTE_AFTER = 2
# The promotion tracker is bounded by the TABLE cache size: letting more
# keys reach promoted state than the LRU can hold would thrash it — cyclic
# access over more promoted signers than entries rebuilds the table every
# verify, inverting the comb into a ~2.7x slowdown.  When the tracker
# fills, it resets and keys re-earn promotion, so only the hot subset ever
# holds tables.
_TABLE_CACHE_SIZE = 128
_seen_signers: dict = {}  # compressed key -> VERIFIED count (bounded)
# Keys promoted by explicit registration (cluster identities via
# prime_signers).  They survive the reset-when-full below: organic signers
# re-earn promotion after a reset, but a boot-time-registered replica
# identity must never silently fall back to the ladder because 128 client
# keys verified in between.  Insertion-ordered and bounded by the table
# cache size: when full, the OLDEST primed key is evicted — a long-lived
# process that re-registers across reconfigurations (or a test session
# booting many clusters) keeps hints for the CURRENT membership, not the
# first 128 identities it ever saw.  Values are unused (dict-as-ordered-set).
_primed_signers: dict = {}


def _reset_signer_tracker() -> None:
    """Reset-when-full, preserving primed (registered) identities."""
    _seen_signers.clear()
    for pk in _primed_signers:
        _seen_signers[pk] = _TABLE_PROMOTE_AFTER


def _window_table(point: _Pt) -> Tuple[Tuple[_Pt, ...], ...]:
    """TB[w][d] = [d * 16^w]P — the shared 4-bit fixed-window table
    construction behind both the basepoint table and per-signer tables."""
    table = []
    step = point
    for _ in range(64):
        row = [_IDENT]
        for _ in range(15):
            row.append(_pt_add(row[-1], step))
        table.append(tuple(row))
        step = _pt_add(row[8], row[8])  # 16 * step
    return tuple(table)


# Cache covers the north-star n=64 membership plus clients/headroom
# (worst-case memory ~50 MB at ≈400 KB/table, only ever paid on wheel-less
# fallback hosts); the promotion tracker above guarantees the promoted set
# never exceeds it.
@lru_cache(maxsize=_TABLE_CACHE_SIZE)
def _signer_table(compressed: bytes) -> Optional[Tuple[Tuple[_Pt, ...], ...]]:
    """Window table for the signer's point A (None: not a point)."""
    point = _decompress(compressed)
    if point is None:
        return None
    return _window_table(point)


def prime_signers(pubs) -> bool:
    """Pre-promote known signers (cluster identities) so their FIRST verify
    runs on the windowed comb table instead of earning promotion with two
    ~380-addition ladder verifies.  Called via
    :func:`mochi_tpu_torch.crypto.keys.register_known_signers` from the verifier
    SPI's ``register_signers`` at replica boot and on reconfiguration.

    O(1) per key: only the promotion counter is touched — the ~960-addition
    table build stays lazy (first verify), and keys that are not canonical
    curve points are skipped (they can never verify, so a table would be
    wasted).  Primed keys are REMEMBERED across the organic tracker's
    reset-when-full (``_reset_signer_tracker``): a flood of distinct
    client signers must not demote boot-registered cluster identities back
    to the ladder.  Bounded at the table-cache size with oldest-first
    eviction (re-registration refreshes recency), so the promoted set can
    never outgrow the LRU (which would invert the comb into table-rebuild
    thrash — see ``_TABLE_CACHE_SIZE``) and the hints always describe the
    most recently registered memberships.
    """
    primed = False
    for pk in pubs:
        pk = bytes(pk)
        if pk in _primed_signers:
            # refresh recency (dict preserves insertion order = LRU order)
            _primed_signers[pk] = _primed_signers.pop(pk)
            primed = True
            continue
        if len(pk) != 32 or _decompress(pk) is None:
            continue
        # Cap at HALF the table cache (= the n=64 design-size membership):
        # a primed set that filled the whole tracker would re-fill it on
        # every reset and starve organic client signers of promotion
        # forever, while primed + organic together overflowed the table
        # LRU into rebuild thrash.  Oldest-first eviction keeps the hints
        # on the most recently registered memberships.
        while len(_primed_signers) >= _TABLE_CACHE_SIZE // 2:
            _primed_signers.pop(next(iter(_primed_signers)))  # evict oldest
        _primed_signers[pk] = True
        _seen_signers[pk] = max(_seen_signers.get(pk, 0), _TABLE_PROMOTE_AFTER)
        primed = True
    return primed


def _mul_signer(k: int, table: Tuple[Tuple[_Pt, ...], ...]) -> _Pt:
    acc = _IDENT
    for w, row in enumerate(table):
        digit = (k >> (4 * w)) & 15
        if digit:
            acc = _pt_add(acc, row[digit])
    return acc


def _compress(p: _Pt) -> bytes:
    x, y, z, _ = p
    zinv = pow(z, _P - 2, _P)
    x = x * zinv % _P
    y = y * zinv % _P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def _decompress(b: bytes) -> Optional[_Pt]:
    """RFC 8032 §5.1.3 point decoding — ``curve.decompress`` on ints.
    Returns None for non-points (callers already rejected y >= p)."""
    if len(b) != 32:
        return None
    enc = int.from_bytes(b, "little")
    sign = enc >> 255
    y = enc & ((1 << 255) - 1)
    if y >= _P:
        return None
    yy = y * y % _P
    u = (yy - 1) % _P
    v = (D_INT * yy + 1) % _P
    # candidate root x = u * v^3 * (u*v^7)^((p-5)/8)
    x = u * pow(v, 3, _P) % _P * pow(u * pow(v, 7, _P) % _P, (_P - 5) // 8, _P) % _P
    vxx = v * x % _P * x % _P
    if vxx == u:
        pass
    elif u != 0 and vxx == _P - u:
        x = x * SQRT_M1_INT % _P
    else:
        return None
    if x == 0 and sign:
        return None
    if (x & 1) != sign:
        x = _P - x
    return (x, y, 1, x * y % _P)


def _pt_eq(p: _Pt, q: _Pt) -> bool:
    """Projective equality: X1*Z2 == X2*Z1 and Y1*Z2 == Y2*Z1."""
    x1, y1, z1, _ = p
    x2, y2, z2, _ = q
    return (x1 * z2 - x2 * z1) % _P == 0 and (y1 * z2 - y2 * z1) % _P == 0


# ------------------------------------------------------------------ Ed25519


@lru_cache(maxsize=4096)
def _expand_seed(seed: bytes) -> Tuple[int, bytes, bytes]:
    """RFC 8032 §5.1.5 key expansion -> (clamped scalar, prefix, public).
    Cached for the same reason keys.py caches OpenSSL key handles: a node
    signs thousands of messages under the same few seeds."""
    if len(seed) != 32:
        # contract parity with Ed25519PrivateKey.from_private_bytes
        raise ValueError("An Ed25519 private key is 32 bytes long")
    h = hashlib.sha512(seed).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, h[32:], _compress(_mul_base(a))


def public_from_seed(seed: bytes) -> bytes:
    return _expand_seed(bytes(seed))[2]


@lru_cache(maxsize=4096)
def _native_sign_material(seed: bytes) -> Tuple[bytes, bytes, bytes]:
    """(clamped scalar LE bytes, prefix, public) for the native signer —
    the byte-form twin of _expand_seed's cached int expansion."""
    a, prefix, pub = _expand_seed(seed)
    return a.to_bytes(32, "little"), prefix, pub


def sign(private_seed: bytes, message: bytes) -> bytes:
    """RFC 8032 §5.1.6 — bit-compatible with OpenSSL's deterministic sign
    (the replica's own-grant re-sign-and-compare depends on determinism).
    Routed through the native engine when built; the pure-Python path
    below is the reference implementation it must match byte-for-byte."""
    seed = bytes(private_seed)
    mod = _native_engine()
    if mod is not None:
        a_bytes, prefix, pub = _native_sign_material(seed)
        return mod.sign_prepared(a_bytes, prefix, pub, bytes(message))
    a, prefix, pub = _expand_seed(seed)
    r = int.from_bytes(hashlib.sha512(prefix + message).digest(), "little") % _L
    r_bytes = _compress(_mul_base(r))
    k = int.from_bytes(
        hashlib.sha512(r_bytes + pub + message).digest(), "little"
    ) % _L
    s = (r + k * a) % _L
    return r_bytes + s.to_bytes(32, "little")


# Verification is a pure function of its three byte inputs, so memoizing is
# sound — and in-process clusters (testing/virtual_cluster.py) make it pay
# hard: all rf replicas share one interpreter and each independently checks
# the SAME 2f+1 certificate grants per Write2, so the cache turns rf*(2f+1)
# multi-millisecond pure-Python verifies into (2f+1) plus dict hits.
# Cached on (key, sig, H(R||A||M)) rather than the message itself so the
# cache holds 160 bytes per entry, not arbitrarily large envelope bodies;
# the SHA-512 recomputed per call is noise next to the EC math it skips.
@lru_cache(maxsize=4096)
def _verify_cached(public_key: bytes, signature: bytes, h_digest: bytes) -> bool:
    r_point = _decompress(signature[:32])
    if r_point is None:
        return False
    s = int.from_bytes(signature[32:], "little")
    h = int.from_bytes(h_digest, "little") % _L
    # Repeat VERIFIED signers (cluster identities) get the windowed comb
    # table — [h]A in <=63 additions instead of the ~380-addition ladder.
    # Only successful verifications count toward promotion: forged-
    # signature floods under rotating bogus keys must neither pay the
    # ~960-addition table build nor evict legitimate signers' tables.
    if _seen_signers.get(public_key, 0) >= _TABLE_PROMOTE_AFTER:
        table = _signer_table(public_key)
        if table is None:
            return False
        ha = _mul_signer(h, table)
    else:
        a_point = _decompress(public_key)
        if a_point is None:
            return False
        ha = _scalar_mul(h, a_point)
    ok = _pt_eq(_mul_base(s), _pt_add(r_point, ha))
    if ok:
        if len(_seen_signers) >= _TABLE_CACHE_SIZE and public_key not in _seen_signers:
            # promoted set must fit the table cache; primed (registered)
            # identities are re-seeded by the reset, organic keys re-earn
            _reset_signer_tracker()
        _seen_signers[public_key] = _seen_signers.get(public_key, 0) + 1
    return ok


# ------------------------------------------------------- native-C engine
#
# native/hbatch.c's verify_batch: the full cofactorless check in C, built at
# first use with the system toolchain (as the codec's mcode.c and the
# batched-h prepare).  None when no toolchain / MOCHI_NO_NATIVE=1 — the
# pure-Python engine above then carries verification.

_NATIVE_UNSET = object()
_native = _NATIVE_UNSET


def _native_engine():
    global _native
    if _native is _NATIVE_UNSET:
        from ..native import get_hbatch

        _native = get_hbatch()
    return _native


def has_native() -> bool:
    """Whether :func:`verify` routes through the native-C engine."""
    return _native_engine() is not None


# Same cache shape and key as _verify_cached (the two engines are verdict-
# identical, but separate caches keep "which engine answered" honest for
# the differential suite): 160 bytes per entry, and in-process clusters
# dedup the rf-way re-check of identical certificate grants.
@lru_cache(maxsize=4096)
def _native_verify_cached(public_key: bytes, signature: bytes, h_digest: bytes) -> bool:
    mod = _native_engine()
    return mod.verify_batch(public_key, signature, mod.reduce512(h_digest)) == b"\x01"


def verify(public_key: bytes, message: bytes, signature: bytes) -> bool:
    """Cofactorless ``[S]B == R + [h]A``.  Callers (``keys.verify``) have
    already enforced canonical encodings (y < p, S < L, lengths)."""
    public_key = bytes(public_key)
    signature = bytes(signature)
    h_digest = hashlib.sha512(signature[:32] + public_key + bytes(message)).digest()
    if len(public_key) == 32 and len(signature) == 64 and _native_engine() is not None:
        return _native_verify_cached(public_key, signature, h_digest)
    return _verify_cached(public_key, signature, h_digest)


# ------------------------------------------------------------------ X25519

_A24 = 121665


def x25519(private_bytes: bytes, peer_public: bytes) -> bytes:
    """RFC 7748 §5 X25519 on Python ints (Montgomery ladder).

    Same contract as ``X25519PrivateKey.exchange``: raises ``ValueError``
    on an all-zero shared secret (small-order peer point) and on
    wrong-length key material — a mixed cluster must reject the same
    malformed handshake bytes on both backends."""
    if len(private_bytes) != 32:
        raise ValueError("An X25519 private key is 32 bytes long")
    if len(peer_public) != 32:
        raise ValueError("An X25519 public key is 32 bytes long")
    mod = _native_engine()
    # hasattr-gated per call, not folded into _native_engine's own gate: a
    # module with Ed25519 but no x25519 keeps the Ed25519 fast path while
    # THIS function falls back to Python.
    if mod is not None and hasattr(mod, "x25519"):
        shared = mod.x25519(bytes(private_bytes), bytes(peer_public))
        if not any(shared):
            raise ValueError("X25519 shared secret is all zeros (small-order point)")
        return shared
    k = int.from_bytes(bytes(private_bytes), "little")
    k &= (1 << 254) - 8
    k |= 1 << 254
    u = int.from_bytes(bytes(peer_public), "little") & ((1 << 255) - 1)
    x1, x2, z2, x3, z3 = u, 1, 0, u, 1
    swap = 0
    for t in reversed(range(255)):
        k_t = (k >> t) & 1
        swap ^= k_t
        if swap:
            x2, x3 = x3, x2
            z2, z3 = z3, z2
        swap = k_t
        a = (x2 + z2) % _P
        aa = a * a % _P
        b = (x2 - z2) % _P
        bb = b * b % _P
        e = (aa - bb) % _P
        c = (x3 + z3) % _P
        d = (x3 - z3) % _P
        da = d * a % _P
        cb = c * b % _P
        x3 = (da + cb) % _P
        x3 = x3 * x3 % _P
        z3 = (da - cb) % _P
        z3 = z3 * z3 % _P * x1 % _P
        x2 = aa * bb % _P
        z2 = e * (aa + _A24 * e) % _P
    if swap:
        x2, x3 = x3, x2
        z2, z3 = z3, z2
    shared = x2 * pow(z2, _P - 2, _P) % _P
    if shared == 0:
        raise ValueError("X25519 shared secret is all zeros (small-order point)")
    return shared.to_bytes(32, "little")


def x25519_public(private_bytes: bytes) -> bytes:
    """Public key = X25519(private, 9) — the Montgomery basepoint."""
    return x25519(private_bytes, (9).to_bytes(32, "little"))
