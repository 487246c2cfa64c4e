"""Known-answer tests for the pure-Python host crypto fallback.

The fallback must be *bit-compatible* with OpenSSL (deterministic RFC 8032
signing; identical cofactorless verify verdicts): a mixed cluster — some
nodes with the ``cryptography`` wheel, some on the fallback — must agree on
every signature, or BFT quorums split on honest traffic.  The RFC vectors
pin that compatibility without needing OpenSSL installed.
"""

import pytest

from mochi_tpu_torch.crypto import hostfallback as hf
from mochi_tpu_torch.crypto import keys

# RFC 8032 §7.1 TEST 1-3: (seed, public, message, signature)
RFC8032_VECTORS = [
    (
        "9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60",
        "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a",
        "",
        "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e06522490155"
        "5fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b",
    ),
    (
        "4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb",
        "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c",
        "72",
        "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da"
        "085ac1e43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00",
    ),
    (
        "c5aa8df43f9f837bedb7442f31dcb7b166d38535076f094b85ce3a2e0b4458f7",
        "fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025",
        "af82",
        "6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3ac"
        "18ff9b538d16f290ae67f760984dc6594a7c15e9716ed28dc027beceea1ec40a",
    ),
]


@pytest.mark.parametrize("seed_h,pub_h,msg_h,sig_h", RFC8032_VECTORS)
def test_rfc8032_sign_and_verify(seed_h, pub_h, msg_h, sig_h):
    seed = bytes.fromhex(seed_h)
    pub = bytes.fromhex(pub_h)
    msg = bytes.fromhex(msg_h)
    sig = bytes.fromhex(sig_h)
    assert hf.public_from_seed(seed) == pub
    assert hf.sign(seed, msg) == sig
    assert hf.verify(pub, msg, sig)
    assert not hf.verify(pub, msg + b"x", sig)
    tampered = bytearray(sig)
    tampered[0] ^= 1
    assert not hf.verify(pub, msg, bytes(tampered))


def test_rfc7748_diffie_hellman_vector():
    # RFC 7748 §6.1
    a = bytes.fromhex(
        "77076d0a7318a57d3c16c17251b26645df4c2f87ebc0992ab177fba51db92c2a"
    )
    b = bytes.fromhex(
        "5dab087e624a8a4b79e17f8b83800ee66f3bb1292618b6fd1c2f8b27ff88e0eb"
    )
    a_pub = bytes.fromhex(
        "8520f0098930a754748b7ddcb43ef75a0dbf3a0d26381af4eba4a98eaa9b4e6a"
    )
    b_pub = bytes.fromhex(
        "de9edb7d7b7dc1b4d35b61c2ece435373f8343c85b78674dadfc7e146f882b4f"
    )
    shared = bytes.fromhex(
        "4a5d9d5ba4ce2de1728e3bf480350f25e07e21c947d19e3376f09b3c1e161742"
    )
    assert hf.x25519_public(a) == a_pub
    assert hf.x25519_public(b) == b_pub
    assert hf.x25519(a, b_pub) == shared
    assert hf.x25519(b, a_pub) == shared


def test_x25519_rejects_small_order_peer():
    with pytest.raises(ValueError):
        hf.x25519(b"\x42" * 32, b"\x00" * 32)


def test_wrong_length_key_material_rejected():
    # Contract parity with OpenSSL: cryptography raises ValueError on
    # non-32-byte keys, and a mixed cluster must reject the same malformed
    # handshake/seed bytes on both backends rather than silently masking.
    with pytest.raises(ValueError):
        hf.x25519(b"\x42" * 31, b"\x17" * 32)
    with pytest.raises(ValueError):
        hf.x25519(b"\x42" * 32, b"\x17" * 33)
    with pytest.raises(ValueError):
        hf.public_from_seed(b"\x01" * 31)
    with pytest.raises(ValueError):
        hf.sign(b"\x01" * 33, b"msg")


def test_keys_module_roundtrip_whatever_backend():
    # keys.* must work identically whether OpenSSL is installed or not —
    # this asserts the public surface, not the backend.
    kp = keys.generate_keypair()
    sig = kp.sign(b"quorum evidence")
    assert len(sig) == 64 and len(kp.public_key) == 32
    assert keys.verify(kp.public_key, b"quorum evidence", sig)
    assert not keys.verify(kp.public_key, b"forged evidence", sig)
    # determinism (RFC 8032): the replica own-grant compare depends on it
    assert kp.sign(b"quorum evidence") == sig
    # derived keypair agrees
    kp2 = keys.keypair_from_seed(kp.private_seed)
    assert kp2.public_key == kp.public_key


def test_fallback_agrees_with_host_library_if_present():
    try:
        from cryptography.hazmat.primitives.asymmetric.ed25519 import (
            Ed25519PrivateKey,
        )
        from cryptography.hazmat.primitives.serialization import (
            Encoding,
            NoEncryption,
            PrivateFormat,
            PublicFormat,
        )
    except ImportError:
        pytest.skip("cryptography not installed; differential check skipped")
    priv = Ed25519PrivateKey.generate()
    seed = priv.private_bytes(Encoding.Raw, PrivateFormat.Raw, NoEncryption())
    pub = priv.public_key().public_bytes(Encoding.Raw, PublicFormat.Raw)
    msg = b"differential"
    assert hf.public_from_seed(seed) == pub
    assert hf.sign(seed, msg) == priv.sign(msg)
    assert hf.verify(pub, msg, priv.sign(msg))


def test_session_handshake_on_current_backend():
    from mochi_tpu_torch.crypto import session

    h1 = session.new_handshake()
    h2 = session.new_handshake()
    k1 = session.derive_key(h1, h2.public_bytes, h2.nonce, "c", "s", True)
    k2 = session.derive_key(h2, h1.public_bytes, h1.nonce, "c", "s", False)
    assert k1 == k2 and len(k1) == 32


def test_signatures_and_shared_secrets_equal_the_reference():
    """Seeded keys through the port's pure-Python engine and the
    reference's: equal public keys, equal (deterministic) signatures,
    equal verdicts on valid, forged and non-canonical signatures, and
    equal X25519 shared secrets."""
    import numpy as np

    from mochi_tpu.crypto import hostfallback as ref_hf

    rng = np.random.default_rng(8032)
    for k in range(6):
        seed, msg = rng.bytes(32), rng.bytes(int(rng.integers(0, 80)))
        pub = hf.public_from_seed(seed)
        assert pub == ref_hf.public_from_seed(seed)
        sig = hf.sign(seed, msg)
        assert sig == ref_hf.sign(seed, msg)
        forged = sig[:32] + bytes([sig[32] ^ 1]) + sig[33:]
        big_s = sig[:32] + (int.from_bytes(sig[32:], "little") + (1 << 252)).to_bytes(32, "little")
        for s in (sig, forged, big_s):
            assert hf.verify(pub, msg, s) == ref_hf.verify(pub, msg, s)
        a, b = rng.bytes(32), rng.bytes(32)
        assert hf.x25519_public(a) == ref_hf.x25519_public(a)
        assert hf.x25519(a, hf.x25519_public(b)) == ref_hf.x25519(b, ref_hf.x25519_public(a))
