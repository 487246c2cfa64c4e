"""The reference's verify and tally against RFC 8032 and hand-built lanes."""

import random

import numpy as np
import pytest
import torch

from portbench import ed25519 as E
from portbench.reference import Field, Reference, ints_to_limbs, limbs_to_ints, tally

# RFC 8032 section 7.1, tests 1-3: (secret key, public key, message, signature)
RFC_8032 = [
    ("9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60",
     "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a", "",
     "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e06522490155"
     "5fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b"),
    ("4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb",
     "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c", "72",
     "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da"
     "085ac1e43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00"),
    ("c5aa8df43f9f837bedb7442f31dcb7b166d38535076f094b85ce3a2e0b4458f7",
     "fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025", "af82",
     "6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3ac"
     "18ff9b538d16f290ae67f760984dc6594a7c15e9716ed28dc027beceea1ec40a"),
]


@pytest.fixture(scope="module")
def vectors():
    return [tuple(bytes.fromhex(x) for x in v) for v in RFC_8032]


@pytest.fixture(scope="module")
def ref():
    return Reference("cpu")


@pytest.mark.parametrize("i", range(3))
def test_keys_and_signatures_match_rfc8032(vectors, i):
    sk, pk, msg, sig = vectors[i]
    assert E.keypair(sk)[2] == pk
    assert E.sign(sk, msg) == sig
    assert E.verify(pk, msg, sig)


def test_reference_accepts_rfc8032_and_rejects_altered_lanes(vectors, ref):
    pubs, msgs, sigs, want = [], [], [], []
    for sk, pk, msg, sig in vectors:
        s = int.from_bytes(sig[32:], "little")
        cases = [
            (msg, sig, True),
            (msg + b"x", sig, False),  # forged: the signature covers other bytes
            (msg, sig[:32] + (s + E.L).to_bytes(32, "little"), False),  # non-canonical S
            (msg, bytes([sig[0] ^ 1]) + sig[1:], False),  # R altered
            (msg, sig[:32] + ((s + 1) % E.L).to_bytes(32, "little"), False),  # S altered
        ]
        for m, g, ok in cases:
            pubs.append(pk)
            msgs.append(m)
            sigs.append(g)
            want.append(ok)
    got = ref.verdicts(pubs, msgs, sigs)
    assert got.tolist() == want
    assert got.tolist() == [E.verify(p, m, g) for p, m, g in zip(pubs, msgs, sigs)]


def test_control_accepts_the_malleated_signature(vectors, ref):
    """The control drops S < L, so S + L of a valid signature verifies."""
    sk, pk, msg, sig = vectors[0]
    s = int.from_bytes(sig[32:], "little")
    bad = sig[:32] + (s + E.L).to_bytes(32, "little")
    assert ref.verdicts([pk], [msg], [bad]).tolist() == [False]
    assert ref.verdicts([pk], [msg], [bad], check_s=False).tolist() == [True]
    assert E.verify(pk, msg, bad, check_s=False)


def test_reference_rejects_bad_encodings(ref):
    _a, _prefix, pk = E.keypair(bytes(range(32)))
    msg = b"grant|user0000000000000000042|ts=7"
    sig = E.sign(bytes(range(32)), msg)
    y_big = ((1 << 255) - 1).to_bytes(32, "little")  # y >= p: not canonical
    got = ref.verdicts([pk, pk, y_big, pk[:31]], [msg] * 4, [sig, y_big + sig[32:], sig, sig])
    assert got.tolist() == [True, False, False, False]


def test_reference_matches_the_plain_verify_on_random_lanes(ref):
    rng = random.Random(5)
    pubs, msgs, sigs = [], [], []
    for i in range(12):
        seed = bytes(rng.randrange(256) for _ in range(32))
        pk = E.keypair(seed)[2]
        msg = b"read|user%019d|rid=%d" % (rng.randrange(10**19), i)
        sig = E.sign(seed, msg)
        if i % 3 == 1:
            sig = sig[:40] + bytes([sig[40] ^ 0x10]) + sig[41:]
        pubs.append(pk)
        msgs.append(msg)
        sigs.append(sig)
    got = ref.verdicts(pubs, msgs, sigs)
    assert got.tolist() == [E.verify(p, m, s) for p, m, s in zip(pubs, msgs, sigs)]
    assert 0 < got.sum() < len(got)


def test_field_invert_and_multiply_are_exact():
    f = Field("cpu")
    rng = random.Random(1)
    xs = [rng.randrange(1, E.P) for _ in range(8)] + [E.P - 1, 1, 2**255 - 20]
    ys = [rng.randrange(E.P) for _ in xs]
    a = torch.from_numpy(ints_to_limbs(xs)).T.contiguous()
    b = torch.from_numpy(ints_to_limbs(ys)).T.contiguous()
    prod = limbs_to_ints(f.mul(a, b))
    assert [v % E.P for v in prod] == [x * y % E.P for x, y in zip(xs, ys)]
    inv = limbs_to_ints(f.invert(a))
    assert [v % E.P for v in inv] == [pow(x, E.P - 2, E.P) for x in xs]
    # the loosest inputs the multiply takes: every limb just below 2^21
    top = torch.full((16, 1), float(2**21 - 1), dtype=torch.float64)
    v = sum((2**21 - 1) << (16 * i) for i in range(16))
    assert limbs_to_ints(f.mul(top, top))[0] % E.P == v * v % E.P
    out = f.mul(top, top)
    assert float(out.max()) < 2**17 and float(out.min()) >= 0


def test_tally_counts_and_commits():
    verdicts = np.array([True, True, False, True, True, True])
    ids = np.array([0, 0, 0, 1, 2, 2], dtype=np.int32)
    counts, committed = tally(verdicts, ids, 4, 2)
    assert counts.tolist() == [2, 1, 2, 0]
    assert committed.tolist() == [True, False, True, False]
    with pytest.raises(ValueError):
        tally(verdicts, np.array([0, 0, 0, 1, 2, 4]), 4, 2)
