"""Property-based fuzzing (hypothesis): codec, envelope, signed-digit recode.

The mcode codec is the trust root of the whole signature scheme (wire bytes
== signing bytes), so its invariants get generative coverage beyond the
hand-picked cases in test_codec.py:

* round-trip identity for arbitrary nested values on the pure-Python
  reference implementation;
* canonicality: semantically equal inputs encode to identical bytes
  (dict insertion order must not matter — this is what makes signing
  bytes canonical);
* the C extension agrees byte-for-byte with the Python reference, on
  valid values AND on arbitrary garbage (accept/reject must match: a
  divergence would let an attacker craft frames that split replicas).
"""

import string

import pytest

# hypothesis is optional (absent on the bare CI image): generative tests
# skip individually, while the deterministic boundary sweeps below — which
# need no generator — keep running.  The shim keeps the @given-decorated
# definitions importable.
try:
    from hypothesis import given, settings, strategies as st

    HAVE_HYPOTHESIS = True
except ImportError:  # pragma: no cover - exercised on bare environments
    HAVE_HYPOTHESIS = False

    def given(*_a, **_k):
        def deco(fn):
            return pytest.mark.skip(reason="hypothesis not installed")(fn)

        return deco

    def settings(*_a, **_k):
        def deco(fn):
            return fn

        return deco

    class _StrategyStub:
        def __getattr__(self, _name):
            return lambda *a, **k: None

    st = _StrategyStub()  # type: ignore[assignment]

from mochi_tpu_torch.protocol import (  # noqa: E402
    Envelope,
    HelloToServer,
    decode_envelope,
    encode_envelope,
)
from mochi_tpu_torch.protocol.codec import _decode_py, _encode_py  # noqa: E402

try:
    from mochi_tpu_torch.native import get_mcode

    _native = get_mcode()
except Exception:  # pragma: no cover - cc unavailable
    _native = None

needs_native = pytest.mark.skipif(_native is None, reason="no C toolchain")


# mcode value domain: None/bool/int/bytes/str and lists/dicts thereof
_scalar = st.one_of(
    st.none(),
    st.booleans(),
    # full codec range incl. [2^63, 2^64) — where a signed-64-bit bug in
    # the C decoder would be most likely to diverge from Python bignum
    st.integers(min_value=-(2**64), max_value=2**64 - 1),
    st.binary(max_size=64),
    st.text(max_size=32),
)
_value = st.recursive(
    _scalar,
    lambda children: st.one_of(
        st.lists(children, max_size=6),
        st.dictionaries(st.text(string.printable, max_size=8), children, max_size=6),
    ),
    max_leaves=25,
)


@settings(max_examples=200, deadline=None)
@given(_value)
def test_python_codec_roundtrip(value):
    assert _decode_py(_encode_py(value)) == value


@settings(max_examples=100, deadline=None)
@given(st.dictionaries(st.text(max_size=8), _scalar, max_size=8))
def test_canonical_dict_order(d):
    """Insertion order must not leak into the canonical bytes."""
    reordered = dict(sorted(d.items(), reverse=True))
    assert _encode_py(reordered) == _encode_py(d)
    if _native is not None:
        assert _native.encode(reordered) == _native.encode(d)


@needs_native
@settings(max_examples=200, deadline=None)
@given(_value)
def test_native_matches_python(value):
    blob = _encode_py(value)
    assert _native.encode(value) == blob  # byte-identical canonical form
    assert _native.decode(blob) == value


@needs_native
@settings(max_examples=150, deadline=None)
@given(st.binary(max_size=96))
def test_decoders_never_crash_and_agree_on_garbage(blob):
    """Arbitrary bytes either decode identically on both paths or raise on
    both — a divergence would let an attacker craft frames that one replica
    accepts and another rejects."""
    try:
        py_val = _decode_py(blob)
        py_ok = True
    except Exception:
        py_ok = False
    try:
        c_val = _native.decode(blob)
        c_ok = True
    except Exception:
        c_ok = False
    assert py_ok == c_ok
    if py_ok:
        assert py_val == c_val


@settings(max_examples=50, deadline=None)
@given(
    msg=st.text(max_size=24),
    msg_id=st.text(string.hexdigits, min_size=1, max_size=32),
    sender=st.text(max_size=24),
    reply_to=st.one_of(st.none(), st.text(max_size=16)),
    ts=st.integers(min_value=0, max_value=2**53),
    sig=st.one_of(st.none(), st.binary(min_size=64, max_size=64)),
    mac=st.one_of(st.none(), st.binary(min_size=32, max_size=32)),
)
def test_envelope_roundtrip(msg, msg_id, sender, reply_to, ts, sig, mac):
    env = Envelope(HelloToServer(msg), msg_id, sender, reply_to, ts, sig, mac)
    back = decode_envelope(encode_envelope(env))
    assert back.payload == env.payload
    assert (back.msg_id, back.sender_id, back.reply_to) == (msg_id, sender, reply_to)
    assert (back.timestamp_ms, back.signature, back.mac) == (ts, sig, mac)
    # auth bytes never cover the auth fields
    assert back.signing_bytes() == env.signing_bytes()


def test_recode_signed4_exact_over_random_scalars():
    """Vectorized check: sum(mag * (-1)^neg * 16^k) reconstructs the scalar
    exactly for random scalars < 2^253 plus the edge cases; the port's
    recode (digits from the scalar bytes) equals the reference's (digits
    from its bit tensor) digit for digit."""
    import numpy as np
    import torch

    import jax
    from mochi_tpu.crypto import curve as ref_curve
    from mochi_tpu_torch.crypto.curve import digits4_from_bytes, recode_signed4

    rng = np.random.default_rng(7)
    scalars = [0, 1, (1 << 253) - 1, (1 << 252) + 27742317777372353535851937790883648492]
    scalars += [int.from_bytes(rng.bytes(32), "little") & ((1 << 253) - 1) for _ in range(60)]
    raw = np.frombuffer(b"".join(s.to_bytes(32, "little") for s in scalars), dtype=np.uint8).reshape(-1, 32)
    mag, neg = recode_signed4(digits4_from_bytes(torch.from_numpy(raw.copy())))
    mag = mag.numpy()
    neg = neg.numpy()
    assert mag.max() <= 8
    for i, s in enumerate(scalars):
        acc = 0
        for k in range(64):
            d = int(mag[k, i]) * (-1 if neg[k, i] else 1)
            acc += d * (16**k)
        assert acc == s, (i, s)
    bits = np.unpackbits(raw, axis=1, bitorder="little").astype(np.int32)
    ref_mag, ref_neg = jax.jit(ref_curve.recode_signed4)(ref_curve.digits4_from_bits(bits.T))
    assert np.array_equal(np.asarray(ref_mag), mag) and np.array_equal(np.asarray(ref_neg), neg)


def test_vectorized_prepare_matches_per_item_reference():
    """The numpy-vectorized ``batch_verify.prepare_packed`` (its scalars
    unpacked to bits) must agree with a straightforward per-item reference
    on pre_ok and on every tensor row where pre_ok holds (rejected lanes
    are don't-care: the device bitmap is masked by pre_ok), and with the
    reference package's ``prepare_packed`` array for array, h and pre_ok
    included.  Coverage includes malformed lengths, the y >= p and S >= L
    canonicity boundaries, the x-parity bit, and random garbage."""
    import hashlib

    import numpy as np

    from mochi_tpu_torch.crypto import batch_verify as bv, field as F, keys
    from mochi_tpu_torch.verifier.spi import VerifyItem

    def prepare_ref(items):
        n = len(items)
        y_a = np.zeros((n, F.NLIMBS), np.int32)
        y_r = np.zeros((n, F.NLIMBS), np.int32)
        sign_a = np.zeros(n, np.int32)
        sign_r = np.zeros(n, np.int32)
        s_bits = np.zeros((n, 256), np.int32)
        h_bits = np.zeros((n, 256), np.int32)
        pre_ok = np.zeros(n, bool)
        for i, it in enumerate(items):
            if len(it.public_key) != 32 or len(it.signature) != 64:
                continue
            a = bytes(it.public_key)
            r = bytes(it.signature[:32])
            s = int.from_bytes(it.signature[32:], "little")
            ya = int.from_bytes(a, "little") & ((1 << 255) - 1)
            yr = int.from_bytes(r, "little") & ((1 << 255) - 1)
            if ya >= F.P_INT or yr >= F.P_INT or s >= F.L_INT:
                continue
            h = (
                int.from_bytes(
                    hashlib.sha512(r + a + bytes(it.message)).digest(), "little"
                )
                % F.L_INT
            )
            y_a[i] = F.int_to_limbs(ya)
            y_r[i] = F.int_to_limbs(yr)
            sign_a[i] = a[31] >> 7
            sign_r[i] = r[31] >> 7
            s_bits[i] = np.unpackbits(
                np.frombuffer(s.to_bytes(32, "little"), np.uint8),
                bitorder="little",
            )
            h_bits[i] = np.unpackbits(
                np.frombuffer(h.to_bytes(32, "little"), np.uint8),
                bitorder="little",
            )
            pre_ok[i] = True
        return y_a, sign_a, y_r, sign_r, s_bits, h_bits, pre_ok

    rng = np.random.default_rng(0xF00D)
    kp = keys.generate_keypair()
    P, L = F.P_INT, F.L_INT

    def enc(v, hi=0):
        return (v | (hi << 255)).to_bytes(32, "little")

    items = [
        VerifyItem(kp.public_key, b"m%d" % i, kp.sign(b"m%d" % i))
        for i in range(40)
    ]
    items += [
        VerifyItem(b"short", b"m", kp.sign(b"m")),
        VerifyItem(kp.public_key, b"m", b"tiny"),
        VerifyItem(b"", b"", b""),
    ]
    for ya in (P - 1, P, P + 1, (1 << 255) - 1, 0, 19):
        for hi in (0, 1):
            items.append(VerifyItem(enc(ya, hi), b"x", kp.sign(b"x")))
    for sval in (L - 1, L, L + 1, (1 << 256) - 1, 0):
        sig = kp.sign(b"y")[:32] + (sval % (1 << 256)).to_bytes(32, "little")
        items.append(VerifyItem(kp.public_key, b"y", sig))
    for yr in (P - 1, P, P + 19):
        items.append(
            VerifyItem(kp.public_key, b"z", enc(yr) + kp.sign(b"z")[32:])
        )
    for _ in range(60):
        items.append(VerifyItem(rng.bytes(32), rng.bytes(8), rng.bytes(64)))

    from mochi_tpu.crypto import batch_verify as ref_bv
    from mochi_tpu.verifier.spi import VerifyItem as RefItem

    ref = prepare_ref(items)
    packed = bv.prepare_packed(items)
    got = (*packed[:4], *(np.unpackbits(b, axis=1, bitorder="little").astype(np.int32) for b in packed[4:6]),
           packed[6])
    assert np.array_equal(ref[6], got[6]), "pre_ok diverged"
    ok = ref[6]
    for k in range(6):
        assert np.array_equal(ref[k][ok], got[k][ok]), k
    theirs = ref_bv.prepare_packed([RefItem(it.public_key, it.message, it.signature) for it in items])
    for k, (a, b) in enumerate(zip(theirs, packed)):
        assert a.dtype == b.dtype and np.array_equal(a, b), k


def test_field_loose_limb_invariant_under_random_op_chains():
    """Every field op must (a) keep limbs in [0, LOOSE] — the invariant the
    per-op bound proofs in field.py's docstrings rely on — and (b) agree
    with python-int arithmetic mod p, and (c) equal the reference's op
    limb for limb.  Random 40-op chains over random loose inputs; any
    bound violation would be a latent int32-overflow seed in a later
    multiply."""
    import numpy as np
    import torch

    import jax
    from mochi_tpu.crypto import field as RF

    from mochi_tpu_torch.crypto import field as F

    rng = np.random.default_rng(0x10053)
    B = 4

    def rand_loose():
        arr = rng.integers(0, F.LOOSE + 1, size=(F.NLIMBS, B)).astype(np.int32)
        vals = [
            sum(int(arr[i, j]) << (F.RADIX * i) for i in range(F.NLIMBS))
            for j in range(B)
        ]
        return arr, vals

    a, va = rand_loose()
    b, vb = rand_loose()
    ops = [
        ("add", lambda M, x, y: M.add(x, y), lambda u, v: u + v),
        ("sub", lambda M, x, y: M.sub(x, y), lambda u, v: u - v),
        ("mul", lambda M, x, y: M.mul(x, y), lambda u, v: u * v),
        ("square", lambda M, x, y: M.square(x), lambda u, v: u * u),
        ("neg", lambda M, x, y: M.neg(x), lambda u, v: -u),
        ("mul3", lambda M, x, y: M.mul_small(x, 3), lambda u, v: u * 3),
        ("mul121666", lambda M, x, y: M.mul_small(x, 486), lambda u, v: u * 486),
    ]
    for step in range(40):
        name, dev_op, int_op = ops[rng.integers(len(ops))]
        out = dev_op(F, torch.from_numpy(a).to(F.DTYPE), torch.from_numpy(b).to(F.DTYPE)).numpy().astype(np.int32)
        assert (out >= 0).all() and (out <= F.LOOSE).all(), (
            step, name, int(out.min()), int(out.max()),
        )
        assert np.array_equal(np.asarray(dev_op(RF, a, b)), out), (step, name)
        got = F.limbs_to_int_batch(F.canonical(torch.from_numpy(out).to(F.DTYPE)).numpy())
        want = [int_op(u, v) % F.P_INT for u, v in zip(va, vb)]
        assert got == want, (step, name)
        assert F.limbs_to_int_batch(np.asarray(jax.jit(RF.canonical)(out))) == want
        b, vb = a, va
        a, va = out, got


# ---------------------------------------------------------------------------
# Epoch exhaustion (paper procedure, mochiDB.tex:162-163): per-object epochs
# grow without bound — one epoch per committed write — so the protocol must
# stay EXACT past every representation boundary a long-lived deployment can
# cross: the float53 line (a single float contamination silently corrupts
# odd timestamps > 2^53) and the codec's varint byte-length boundaries up to
# the full uint64 range the wire format guarantees.


def _epoch_store_pair():
    from mochi_tpu_torch.cluster import ClusterConfig
    from mochi_tpu_torch.server.store import DataStore

    cfg = ClusterConfig.build(
        {f"server-{i}": f"127.0.0.1:{8001 + i}" for i in range(4)}, rf=4
    )
    return [DataStore(f"server-{i}", cfg) for i in range(4)]


def _drive_epoch_rounds(base: int, seed: int, rounds: int) -> None:
    """Shared drive for the generative and deterministic epoch tests:
    grant issuance, codec roundtrip, commit and epoch advance/GC at a huge
    per-object epoch, every step checked bit-exact."""
    from mochi_tpu_torch.protocol import (
        Action,
        Operation,
        Transaction,
        Write1OkFromServer,
        Write1ToServer,
        Write2AnsFromServer,
        Write2ToServer,
        WriteCertificate,
        transaction_hash,
    )
    from mochi_tpu_torch.server.store import EPOCH_UNIT, GRANT_GC_EPOCHS

    stores = _epoch_store_pair()
    epoch = (base // EPOCH_UNIT) * EPOCH_UNIT
    key = "exhaust"
    for s in stores:
        s._get_or_create(key).current_epoch = epoch

    for r in range(rounds):
        txn = Transaction((Operation(Action.WRITE, key, b"v%d" % r),))
        blind = Transaction((Operation(Action.WRITE, key, None),))
        req = Write1ToServer("client-e", blind, seed, transaction_hash(txn))
        responses = [s.process_write1(req) for s in stores]
        assert all(isinstance(x, Write1OkFromServer) for x in responses)
        want_ts = epoch + seed  # exact python-int arithmetic, never float
        for x in responses:
            g = x.multi_grant.grants[key]
            assert g.timestamp == want_ts
            # a float anywhere in the path would round odd ts > 2^53
            assert isinstance(g.timestamp, int)
        wc = WriteCertificate(
            {x.multi_grant.server_id: x.multi_grant for x in responses}
        )

        # wire-exactness of the huge timestamps: python codec roundtrip,
        # and the C codec agrees byte-for-byte when available
        blob = _encode_py(wc.to_obj())
        assert WriteCertificate.from_obj(_decode_py(blob)).grants[
            stores[0].server_id
        ].grants[key].timestamp == want_ts
        if _native is not None:
            assert _native.encode(wc.to_obj()) == blob
            assert _native.decode(blob) == _decode_py(blob)

        answers = [s.process_write2(Write2ToServer(wc, txn)) for s in stores]
        for ans in answers:
            assert isinstance(ans, Write2AnsFromServer)
        epoch = (want_ts // EPOCH_UNIT) * EPOCH_UNIT + EPOCH_UNIT
        for s in stores:
            sv = s.data[key]
            assert sv.current_epoch == epoch  # exact advance, no drift
            # grant GC horizon arithmetic stays exact at huge epochs
            assert all(e >= epoch - GRANT_GC_EPOCHS for e in sv.grants)


@settings(max_examples=40, deadline=None)
@given(
    # epoch bases straddling float53, varint byte boundaries, and uint64
    base=st.one_of(
        st.integers(min_value=2**53 - 10_000, max_value=2**53 + 10_000),
        st.integers(min_value=2**56 - 10_000, max_value=2**56 + 10_000),
        st.integers(min_value=2**63 - 10_000, max_value=2**63 + 10_000),
        st.integers(min_value=0, max_value=2**64 - 2_000_000),
    ),
    seed=st.integers(min_value=0, max_value=999),
    rounds=st.integers(min_value=1, max_value=3),
)
def test_epochs_past_2_53_stay_exact(base, seed, rounds):
    """Grant issuance, epoch advance, grant GC and the wire codec must be
    bit-exact when per-object epochs exceed 2^53 (and up to uint64)."""
    _drive_epoch_rounds(base, seed, rounds)


@pytest.mark.parametrize(
    "base",
    [
        2**53 - 1_000,  # last fully float-exact epoch
        2**53 + 1,      # first odd value a float path would corrupt
        2**53 + 999,
        2**56 - 5,      # varint 8->9 byte boundary region
        2**56 + 123,
        2**63 - 7,      # int64 sign boundary (a C codec's danger zone)
        2**63 + 1_001,
        2**64 - 2_000_000,  # near the wire format's uint64 ceiling
    ],
)
def test_epochs_boundary_sweep_deterministic(base):
    """Hypothesis-free pinned sweep of the same drive at every
    representation boundary, so the property holds on bare CI images too
    (the paper's epoch-exhaustion procedure, mochiDB.tex:162-163)."""
    _drive_epoch_rounds(base, seed=777, rounds=2)
