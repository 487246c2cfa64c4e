"""The port's native host code (``mochi_tpu_torch/native``) on the CPU.

Differential contracts, tolerance zero (bytes and verdicts):

* the codec: the port's native ``_mcode``, its pure-Python codec and the
  JAX package's ``mochi_tpu.protocol.codec`` encode hypothesis-fuzzed
  structural values to the same bytes and decode them back; the envelope
  decoder takes 8- and 9-element envelopes and refuses trailing bytes;
* ``h_batch`` equals hashlib plus a Python bignum mod L, and
  ``prepare_packed`` returns the same arrays with and without
  ``MOCHI_NO_NATIVE`` on the verify tests' adversarial corpus;
* the native Ed25519 engine's verdicts equal OpenSSL's and the pure-Python
  engine's, and on the key with x = 0 and the sign bit set (which OpenSSL
  accepts) the device path's rejection (ROADMAP.md Queue C);
* native signing equals the pure signer, native X25519 RFC 7748 and
  OpenSSL;
* the extensions are built under ``build/native/``, never in the package.
"""

from __future__ import annotations

import hashlib
import os
import random

import numpy as np
import pytest
from cryptography.hazmat.primitives.asymmetric.x25519 import X25519PrivateKey, X25519PublicKey
from hypothesis import given, settings, strategies as st

from mochi_tpu.crypto import keys as jkeys
from mochi_tpu.protocol import codec as jcodec
from mochi_tpu_torch import native as N
from mochi_tpu_torch.crypto import batch_verify as BV
from mochi_tpu_torch.crypto import hostfallback as hf
from mochi_tpu_torch.crypto import keys
from mochi_tpu_torch.protocol import codec
from mochi_tpu_torch.verifier.spi import VerifyItem
from test_torch_verify import LOW_ORDER, _low_order_corpus, _mixed_corpus

L = (1 << 252) + 27742317777372353535851937790883648493


@pytest.fixture(scope="module")
def mcode():
    mod = N.get_mcode()
    assert mod is not None, N.native_status()
    return mod


@pytest.fixture(scope="module")
def hb():
    mod = N.get_hbatch()
    assert mod is not None, N.native_status()
    return mod


@pytest.fixture
def pure_engine(monkeypatch):
    """hostfallback with its native routing switched off."""
    monkeypatch.setattr(hf, "_native", None)
    return hf


# ------------------------------------------------------------------ build


def test_extensions_build_under_build_native_and_register_in_the_port(mcode, hb):
    status = N.native_status()
    assert status["_mcode"]["built"] and status["_hbatch"]["built"], status
    for name, mod in (("_mcode", mcode), ("_hbatch", hb)):
        path = os.path.realpath(mod.__file__)
        assert os.path.dirname(path) == os.path.realpath(N.BUILD_DIR), path
        assert os.path.basename(path).startswith(name + "-")
        assert mod.__name__ == f"mochi_tpu_torch.native.{name}"
    pkg = os.path.dirname(os.path.realpath(N.__file__))
    assert not [f for f in os.listdir(pkg) if f.endswith(".so")]
    assert N.so_path("_mcode") == N.BUILD_DIR / os.path.basename(mcode.__file__)


def test_native_status_names_why_a_module_is_off(monkeypatch):
    monkeypatch.setenv("MOCHI_NO_NATIVE", "1")
    assert N.get_mcode() is None and N.get_hbatch() is None
    assert N.native_status() == {
        "_mcode": {"built": False, "error": "MOCHI_NO_NATIVE is set"},
        "_hbatch": {"built": False, "error": "MOCHI_NO_NATIVE is set"},
    }


def test_a_failed_build_is_reported_and_falls_back(monkeypatch, tmp_path):
    monkeypatch.setattr(N, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(N, "_cached", {})
    monkeypatch.setattr(N, "_errors", {})
    monkeypatch.setenv("CC", str(tmp_path / "no-such-compiler"))
    assert N.get_mcode() is None
    status = N.native_status()
    assert not status["_mcode"]["built"] and "no-such-compiler" in status["_mcode"]["error"]
    assert not list(tmp_path.iterdir())  # no temporary file is left behind


# ------------------------------------------------------------------ codec

_scalars = (
    st.none()
    | st.booleans()
    | st.integers(min_value=-(2**63), max_value=2**64 - 1)
    | st.binary(max_size=40)
    | st.text(max_size=20)
)
_values = st.recursive(
    _scalars,
    lambda inner: st.lists(inner, max_size=5) | st.dictionaries(st.text(max_size=8), inner, max_size=5),
    max_leaves=24,
)


@settings(max_examples=300, deadline=None, derandomize=True)
@given(_values)
def test_encode_is_byte_equal_across_native_pure_and_the_reference(mcode, value):
    wire = mcode.encode(value)
    assert wire == codec._encode_py(value) == jcodec._encode_py(value) == jcodec.encode(value)
    assert mcode.decode(wire) == codec._decode_py(wire) == value


def test_the_bound_codec_is_native(mcode):
    assert codec.encode is mcode.encode and codec.decode is mcode.decode


def _envelope(n: int) -> list:
    return [1, "client-7", b"\x01" * 8, 42, b"nonce", [b"payload", {"k": 1}], b"\x02" * 64, None, {"t": 1}][:n]


@pytest.mark.parametrize("n", [8, 9])
def test_decode_env_takes_both_envelope_forms(mcode, n):
    wire = codec._encode_py(_envelope(n))
    assert codec.decode_env(wire) == codec._decode_env_py(wire) == jcodec._decode_env_py(wire)
    values, off6 = codec.decode_env(wire)
    assert values == _envelope(n) and 0 < off6 < len(wire)
    if n == 8:
        assert mcode.decode_env(wire) == codec._decode_env_py(wire)


@pytest.mark.parametrize("n", [8, 9])
def test_decode_env_rejects_trailing_bytes_and_other_lengths(n):
    wire = codec._encode_py(_envelope(n))
    with pytest.raises(ValueError):
        codec.decode_env(wire + b"\x00")
    with pytest.raises(ValueError):
        codec._decode_env_py(wire + b"\x00")
    with pytest.raises(ValueError):
        codec.decode_env(codec._encode_py(_envelope(7)))


@pytest.mark.parametrize("bad", [
    b"", b"\xff", b"\x03", b"\x05\x05ab", b"\x00\x00", b"\x08\x01\x03\x01\x00",
    b"\x07\xff\xff\xff\xff\x7f", b"\x03" + b"\x80" * 10 + b"\x02",
])
def test_decode_errors_agree(mcode, bad):
    for dec in (mcode.decode, codec._decode_py, jcodec._decode_py):
        with pytest.raises(ValueError):
            dec(bad)


def test_encode_errors_agree(mcode):
    nested = None
    for _ in range(40):
        nested = [nested]
    for value, err in ((2**64, TypeError), ({1: "x"}, TypeError), (1.5, TypeError), (nested, ValueError)):
        for enc in (mcode.encode, codec._encode_py, jcodec._encode_py):
            with pytest.raises(err):
                enc(value)


# -------------------------------------------------------------- h_batch


def test_h_batch_equals_hashlib_and_bignum(hb):
    rng = random.Random(16)
    n = 96
    rs, as_ = rng.randbytes(32 * n), rng.randbytes(32 * n)
    lengths = [0, 1, 111, 112, 127, 128, 129, 4096] + [rng.randrange(0, 4097) for _ in range(n - 8)]
    msgs = [rng.randbytes(k) for k in lengths]
    out = hb.h_batch(rs, as_, b"".join(msgs), np.asarray(lengths, dtype=np.uint64).tobytes())
    for i, m in enumerate(msgs):
        want = int.from_bytes(hashlib.sha512(rs[32 * i:32 * i + 32] + as_[32 * i:32 * i + 32] + m).digest(),
                              "little") % L
        assert out[32 * i:32 * i + 32] == want.to_bytes(32, "little"), i


def test_h_batch_refuses_inconsistent_buffers(hb):
    with pytest.raises(ValueError):
        hb.h_batch(b"\x00" * 32, b"\x00" * 32, b"", (5).to_bytes(8, "little"))
    with pytest.raises(ValueError):
        hb.h_batch(b"\x00" * 64, b"\x00" * 64, b"", (1 << 63).to_bytes(8, "little") * 2)


def test_prepare_packed_is_identical_with_and_without_native(hb, monkeypatch):
    rows = _mixed_corpus() + _low_order_corpus()
    items = [VerifyItem(*r) for r in rows]
    called = []
    monkeypatch.setattr(BV, "_hbatch", lambda: called.append(1) or hb)
    native = BV.prepare_packed(items)
    assert called
    monkeypatch.undo()
    monkeypatch.setenv("MOCHI_NO_NATIVE", "1")
    assert BV._hbatch() is None
    pure = BV.prepare_packed(items)
    for a, b in zip(native, pure):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert native[6].any() and not native[6].all()  # h and pre_ok, on both kinds of lane


# ------------------------------------------------------ the Ed25519 engine


def _engine_verdicts(engine, rows):
    """keys.verify with ``engine`` as its host engine: the canonical
    prechecks, then the engine's cofactorless check."""
    return [keys._canonical(pub, sig) and engine.verify(pub, msg, sig) for pub, msg, sig in rows]


def test_native_verdicts_equal_openssl_and_the_pure_engine(hb, monkeypatch):
    rows = _mixed_corpus() + _low_order_corpus()
    assert hf.has_native()
    native = _engine_verdicts(hf, rows)
    openssl = [jkeys.verify(*r) for r in rows]
    assert native == openssl == [keys.verify(*r) for r in rows]
    assert any(native) and not all(native)
    monkeypatch.setattr(hf, "_native", None)
    assert _engine_verdicts(hf, rows) == native


def test_native_engine_rejects_x0_with_the_sign_bit_as_the_device_does(hb):
    """OpenSSL accepts A = (x = 0, sign 1) when [S]B == R; the device path
    (here its plain version on CPU tensors) rejects it, and so must the
    native engine itself, below keys.verify's own refusal."""
    r = 12345
    s_eq_r = hf._compress(hf._mul_base(r)) + r.to_bytes(32, "little")
    rows = [(enc[:31] + bytes([enc[31] | 0x80]), b"m%d" % i, s_eq_r) for i, enc in enumerate(LOW_ORDER[:2])]
    device = BV.verify_batch([VerifyItem(*t) for t in rows], device="cpu")
    assert device == [False, False]
    h = b"".join(hashlib.sha512(s_eq_r[:32] + pub + m).digest() for pub, m, _ in rows)
    hs = b"".join(hb.reduce512(h[64 * i:64 * i + 64]) for i in range(len(rows)))
    assert hb.verify_batch(b"".join(p for p, _, _ in rows), s_eq_r * len(rows), hs) == b"\x00\x00"
    assert [hf.verify(*t) for t in rows] == device
    assert [keys.verify(*t) for t in rows] == device
    # the same R and S under the identity key (x = 0, no sign bit) verify
    assert hf.verify(LOW_ORDER[0], b"m0", s_eq_r)


def test_native_verify_batch_isolates_items(hb):
    kp = keys.generate_keypair()
    msgs = [b"item-%d" % i for i in range(8)]
    sigs = [bytearray(kp.sign(m)) for m in msgs]
    sigs[3][7] ^= 1
    sigs[6][40] ^= 1
    hs = b"".join(hb.reduce512(hashlib.sha512(bytes(s[:32]) + kp.public_key + m).digest())
                  for s, m in zip(sigs, msgs))
    bitmap = hb.verify_batch(kp.public_key * 8, b"".join(bytes(s) for s in sigs), hs)
    assert bitmap == bytes(0 if i in (3, 6) else 1 for i in range(8))


def test_native_sign_equals_the_pure_signer_and_openssl(hb, pure_engine):
    rng = random.Random(99)
    for i in range(24):
        seed = rng.randbytes(32)
        msg = rng.randbytes(rng.randrange(0, 300))
        a, prefix, pub = hf._expand_seed(seed)
        native = hb.sign_prepared(a.to_bytes(32, "little"), prefix, pub, msg)
        assert native == pure_engine.sign(seed, msg) == keys.sign(seed, msg), i


def test_host_crypto_engine_names_the_engine(monkeypatch):
    assert keys.host_crypto_engine() == "openssl"  # this host has the wheel
    monkeypatch.setattr(keys, "_HAVE_HOST_CRYPTO", False)
    assert keys.host_crypto_engine() == "native-c"
    assert keys.register_known_signers([keys.generate_keypair().public_key]) is False
    monkeypatch.setattr(hf, "_native", hf._NATIVE_UNSET)
    monkeypatch.setenv("MOCHI_NO_NATIVE", "1")
    assert keys.host_crypto_engine() == "pure-python"


# ------------------------------------------------------------------ X25519

BASEPOINT = (9).to_bytes(32, "little")
RFC7748_VECTORS = [  # §5.2
    ("a546e36bf0527c9d3b16154b82465edd62144c0ac1fc5a18506a2244ba449ac4",
     "e6db6867583030db3594c1a424b15f7c726624ec26b3353b10a903a6d0ab1c4c",
     "c3da55379de9c6908e94ea4df28d084f32eccf03491c71f754b4075577a28552"),
    ("4b66e9d4d1b4673c5ad22691957d6af5c11b6421e0ea01d42ca4169e7918ba0d",
     "e5210f12786811d3f4b7959d0538ae2c31dbe7106fc03c3efc4cd549c715a493",
     "95cbde9476e8907d7aade45cb4b873f88b595a68799fa152e6f8f7647aac7957"),
]


def _openssl_x25519(private: bytes, peer: bytes) -> bytes:
    return X25519PrivateKey.from_private_bytes(private).exchange(X25519PublicKey.from_public_bytes(peer))


@pytest.mark.parametrize("k_hex,u_hex,want_hex", RFC7748_VECTORS)
def test_x25519_rfc7748_vectors(hb, k_hex, u_hex, want_hex):
    k, u, want = (bytes.fromhex(h) for h in (k_hex, u_hex, want_hex))
    assert hb.x25519(k, u) == hf.x25519(k, u) == _openssl_x25519(k, u) == want


def test_x25519_iterated_ladder(hb):
    """RFC 7748 §5.2's iteration, 1 and 1000 rounds."""
    k = u = BASEPOINT
    k, u = hb.x25519(k, u), k
    assert k.hex() == "422c8e7a6227d7bca1350b3e2bb7279f7897b87bb6854b783c60e80311ae3079"
    for _ in range(999):
        k, u = hb.x25519(k, u), k
    assert k.hex() == "684cf59ba83309552800ef566f2f4d3c1c3887c49360e3875f2eb94d99532c51"


def test_x25519_random_agreement_and_rejections(hb, pure_engine):
    rng = random.Random(20261018)
    for i in range(40):
        priv = rng.randbytes(32)
        peer = bytearray(hb.x25519(rng.randbytes(32), BASEPOINT))
        if i % 3 == 0:
            peer[31] |= 0x80  # RFC 7748 masks bit 255
        peer = bytes(peer)
        assert hb.x25519(priv, peer) == pure_engine.x25519(priv, peer) == _openssl_x25519(priv, peer), i
    for private, peer in ((b"\x00" * 31, BASEPOINT), (b"\x00" * 32, b"\x00" * 33)):
        with pytest.raises(ValueError):
            pure_engine.x25519(private, peer)
    with pytest.raises(ValueError):
        pure_engine.x25519(b"\x01" * 32, b"\x00" * 32)  # small order: all-zero secret


def test_x25519_small_order_point_is_refused_on_the_native_path(hb, monkeypatch):
    monkeypatch.setattr(hf, "_native", hb)
    with pytest.raises(ValueError):
        hf.x25519(b"\x01" * 32, b"\x00" * 32)
