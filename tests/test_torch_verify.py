"""The port's batch verify on the CPU against the JAX package and OpenSSL.

``prepare_packed`` must return arrays identical to the JAX package's, and
the port's ``verify_batch`` (the kernel's plain version on CPU tensors)
must give the same bitmap as the JAX package's ``verify_batch`` (bucket 16,
as its own tier-1 runs it) and as ``mochi_tpu.crypto.keys.verify`` on the
mixed corpus of ``tests/test_crypto_jax.py`` and the low-order corpora of
``tests/test_native_ed25519.py``.  Tolerance zero: these are verdicts.
"""

import random

import numpy as np
import pytest
import torch

from mochi_tpu.crypto import batch_verify as JBV
from mochi_tpu.crypto import hostfallback as jhf
from mochi_tpu.crypto import keys as jkeys
from mochi_tpu.verifier.spi import VerifyItem as JItem
from mochi_tpu_torch.crypto import batch_verify as BV
from mochi_tpu_torch.crypto import cuda_verify as CV
from mochi_tpu_torch.crypto import keys
from mochi_tpu_torch.verifier.spi import VerifyItem

P = (1 << 255) - 19
L = (1 << 252) + 27742317777372353535851937790883648493
LOW_ORDER = [
    (1).to_bytes(32, "little"),
    (P - 1).to_bytes(32, "little"),
    (0).to_bytes(32, "little"),
    bytes.fromhex("c7176a703d4dd84fba3c0b760d10670f2a2053fa2c39ccc64ec7fd7792ac03fa"),
    bytes.fromhex("26e8958fc2b227b045c3f489f2ef98f0d5dfac05d3c63339b13802886d53fc05"),
]


def _mixed_corpus():
    """The valid/forged/malformed matrix of tests/test_crypto_jax.py."""
    kps = [keys.generate_keypair() for _ in range(6)]
    out = []
    for i, kp in enumerate(kps):
        m = f"txn-{i}".encode() * (i + 1)
        out.append((kp.public_key, m, kp.sign(m)))
    out.append((kps[0].public_key, b"evil", kps[0].sign(b"good")))
    s = bytearray(kps[1].sign(b"x"))
    s[3] ^= 1
    out.append((kps[1].public_key, b"x", bytes(s)))
    s = bytearray(kps[2].sign(b"x2"))
    s[40] ^= 1
    out.append((kps[2].public_key, b"x2", bytes(s)))
    out.append((kps[3].public_key, b"y", kps[4].sign(b"y")))
    out.append((b"\xff" * 32, b"z", kps[0].sign(b"z")))
    sig = bytearray(kps[5].sign(b"w"))
    sig[32:] = b"\xff" * 31 + b"\x0f"
    out.append((kps[5].public_key, b"w", bytes(sig)))
    out.append((b"\x01" * 31, b"t", kps[0].sign(b"t")))
    out.append((kps[0].public_key, b"t", b"\x02" * 63))
    out.append((kps[0].public_key, b"", kps[0].sign(b"")))
    return out


def _low_order_corpus():
    """Low-order keys and R, the identity-key forgery, S + L and y >= p
    (tests/test_native_ed25519.py)."""
    rng = random.Random(7)
    r = rng.randrange(L)
    r_enc = jhf._compress(jhf._mul_base(r))
    s_eq_r = r_enc + r.to_bytes(32, "little")
    kp = keys.generate_keypair()
    honest = kp.sign(b"m")
    out = [(LOW_ORDER[0], msg, s_eq_r) for msg in (b"", b"any message at all")]
    out += [(LOW_ORDER[1], b"order two %d" % i, s_eq_r) for i in range(4)]
    for enc in LOW_ORDER:
        out.append((enc, b"m", honest))
        out.append((kp.public_key, b"m", enc + honest[32:]))
    s = int.from_bytes(honest[32:], "little")
    out.append((kp.public_key, b"m", honest[:32] + (s + L).to_bytes(32, "little")))
    for y in (P, P + 1, (1 << 255) - 20):
        bad = y.to_bytes(32, "little")
        out.append((bad, b"m", honest))
        out.append((kp.public_key, b"m", bad + honest[32:]))
    return out


def _jax_verdicts(rows):
    out = []
    for i in range(0, len(rows), 16):
        out += JBV.verify_batch([JItem(*r) for r in rows[i : i + 16]], bucket=16)
    return out


@pytest.fixture(scope="module")
def corpus():
    rows = _mixed_corpus() + _low_order_corpus()
    return rows, _jax_verdicts(rows)


def test_prepare_packed_is_identical_to_the_reference(corpus):
    rows, _ = corpus
    mine = BV.prepare_packed([VerifyItem(*r) for r in rows])
    ref = JBV.prepare_packed([JItem(*r) for r in rows])
    assert len(mine) == len(ref) == 7
    for a, b in zip(mine, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_verify_batch_matches_the_reference_and_openssl(corpus):
    rows, jax_out = corpus
    mine = BV.verify_batch([VerifyItem(*r) for r in rows], device="cpu")
    openssl = [jkeys.verify(*r) for r in rows]
    assert mine == jax_out == openssl
    assert [keys.verify(*r) for r in rows] == openssl
    assert any(mine) and not all(mine)
    # the low-order branch is exercised: the identity key accepts S = r
    n_mixed = len(_mixed_corpus())
    assert mine[n_mixed] and mine[n_mixed + 1]


def test_x0_with_sign_bit_key_is_rejected_by_every_port_engine():
    """A = (x = 0, sign 1) has no RFC 8032 decoding.  The JAX package's
    device path rejects it, and so must the port's kernel path and its
    keys.verify, whichever host engine that runs (ROADMAP.md Queue C)."""
    r = 12345
    s_eq_r = jhf._compress(jhf._mul_base(r)) + r.to_bytes(32, "little")
    rows = [(enc[:31] + bytes([enc[31] | 0x80]), b"m%d" % i, s_eq_r)
            for i, enc in enumerate(LOW_ORDER[:2])]
    assert BV.verify_batch([VerifyItem(*t) for t in rows], device="cpu") == [False, False]
    assert _jax_verdicts(rows) == [False, False]
    assert [keys.verify(*t) for t in rows] == [False, False]


def test_from_reference_prepared_and_wrapper_on_cpu(corpus):
    rows, jax_out = corpus
    arrays = JBV.prepare_packed([JItem(*r) for r in rows])
    tens = CV.from_reference_prepared(arrays, "cpu")
    assert [t.dtype for t in tens] == [torch.int32] * 4 + [torch.uint8] * 2
    before = dict(CV.launches)
    bitmap = CV.verify_prepared_packed(*tens)
    assert CV.launches == before  # the plain version is no kernel launch
    assert bitmap.dtype == torch.bool and bitmap.shape == (len(rows),)
    assert np.logical_and(bitmap.numpy(), arrays[6]).tolist() == jax_out
    with pytest.raises(ValueError):
        CV.verify_prepared_packed(*(t.to("meta") for t in tens))


def test_empty_and_all_rejected_batches_skip_the_device():
    assert BV.verify_batch([], device="cpu") == []
    kp = keys.generate_keypair()
    garbage = [VerifyItem(kp.public_key, b"g%d" % i, kp.sign(b"g%d" % i)[:32] + b"\xff" * 32)
               for i in range(8)]
    before = BV.device_dispatch_count()
    assert BV.verify_batch(garbage, device="cpu") == [False] * 8
    assert BV.device_dispatch_count() == before


def test_chunked_stream_keeps_order_and_skips_garbage_chunk(monkeypatch):
    monkeypatch.setattr(BV, "MAX_LAUNCH", 4)
    kp = keys.generate_keypair()
    good = [VerifyItem(kp.public_key, b"c%d" % i, kp.sign(b"c%d" % i)) for i in range(4)]
    garbage = [VerifyItem(it.public_key, it.message, it.signature[:32] + b"\xff" * 32) for it in good]
    forged = [VerifyItem(it.public_key, it.message + b"!", it.signature) for it in good]
    stream = good + garbage + forged[:2] + good[:2] + good
    before_d, before_i = BV.device_dispatch_count(), BV.device_item_count()
    assert BV.verify_batch(stream, device="cpu") == [True] * 4 + [False] * 6 + [True] * 6
    assert BV.device_dispatch_count() == before_d + 3  # the garbage chunk never launched
    assert BV.device_item_count() == before_i + 12


def test_backend_crossover_and_signer_registration():
    kp = keys.generate_keypair()
    items = [VerifyItem(kp.public_key, b"m", kp.sign(b"m"))]
    backend = BV.TorchBatchBackend(device="cpu", min_device_items=2)
    before = BV.device_dispatch_count()
    assert list(backend(items)) == [True]
    assert backend.crossover_batches == 1 and BV.device_dispatch_count() == before
    assert list(backend(items * 2)) == [True, True]
    assert BV.device_dispatch_count() == before + 1
    backend.register_signers([kp.public_key, kp.public_key])
    assert backend.registered_signers == [kp.public_key]


def test_backend_reads_the_crossover_knob(monkeypatch):
    monkeypatch.setenv("MOCHI_DEVICE_MIN_BATCH", "7")
    assert BV.TorchBatchBackend(device="cpu").min_device_items == 7
    monkeypatch.setenv("MOCHI_DEVICE_MIN_BATCH", "junk")
    assert BV.TorchBatchBackend(device="cpu").min_device_items == 0


@pytest.mark.slow
def test_matches_the_pallas_kernel_in_interpret_mode():
    from mochi_tpu.crypto import pallas_verify as PV

    kp = jkeys.generate_keypair()
    rows = []
    for i in range(6):
        msg = b"pallas %d" % i
        sig = bytearray(kp.sign(msg))
        if i in (2, 4):
            sig[1] ^= 0x40
        rows.append((kp.public_key, msg, bytes(sig)))
    pallas = np.asarray(PV.verify_prepared_pallas(*JBV.prepare([JItem(*r) for r in rows])[:6], block=8))
    mine = CV.verify_prepared_packed(*CV.from_reference_prepared(
        BV.prepare_packed([VerifyItem(*r) for r in rows]), "cpu"))
    assert mine.tolist() == pallas.tolist() == [True, True, False, True, False, True]


# ------------------------------------------------- MOCHI_SKEW_IMPL=mxu


def test_plain_verify_under_mxu_equals_pad_and_openssl(corpus, monkeypatch):
    """The plain verify with every rank-2 multiply through ``_mul_mxu`` gives
    the bitmap it gives on the schoolbook, and OpenSSL's verdicts, on the
    mixed and low-order corpus."""
    from mochi_tpu_torch.crypto import curve
    from mochi_tpu_torch.crypto import field as F

    rows, jax_out = corpus
    arrays = BV.prepare_packed([VerifyItem(*r) for r in rows])
    tens = CV.from_reference_prepared(arrays, "cpu")
    pad = curve.verify_prepared_packed(*tens)
    monkeypatch.setattr(F, "SKEW_IMPL", "mxu")
    used = []
    real = F._mul_mxu
    monkeypatch.setattr(F, "_mul_mxu", lambda a, b: used.append(1) or real(a, b))
    mxu = curve.verify_prepared_packed(*tens)
    assert used and torch.equal(mxu, pad)
    assert np.logical_and(mxu.numpy(), arrays[6]).tolist() == jax_out == [jkeys.verify(*r) for r in rows]


def test_mxu_wrapper_on_cpu_runs_the_plain_version_and_counts_by_skew(corpus, monkeypatch):
    """On CPU tensors the wrapper runs the plain verify under the switch it
    reads at the call (no launch counted for either skew), the batch
    multiply runs the plain ``_mul_mxu``, and the mxu kernel's basepoint
    table holds the reference's Niels entries integer for integer."""
    from mochi_tpu.crypto import curve as JC
    from mochi_tpu_torch.crypto import field as F

    assert CV.SKEWS == ("pad", "mxu") and set(CV.launches) == set(CV.launch_logs) == {"pad", "mxu"}
    assert CV.skew() == ("mxu" if F.SKEW_IMPL == "mxu" else "pad")
    rows, jax_out = corpus
    arrays = BV.prepare_packed([VerifyItem(*r) for r in rows])
    monkeypatch.setattr(F, "SKEW_IMPL", "mxu")
    assert CV.skew() == "mxu"
    before = (dict(CV.launches), CV.mul_launches)
    bitmap = CV.verify_prepared_packed(*CV.from_reference_prepared(arrays, "cpu"))
    assert np.logical_and(bitmap.numpy(), arrays[6]).tolist() == jax_out
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.integers(0, F.LOOSE + 1, (F.NLIMBS, 9)).astype(np.int32))
    got = CV.fe_mul_mxu(a, a.flip(1))
    assert got.dtype == torch.int32 and torch.equal(got.to(F.DTYPE), F.mul(a.to(F.DTYPE), a.flip(1).to(F.DTYPE)))
    assert (dict(CV.launches), CV.mul_launches) == before
    monkeypatch.setattr(F, "SKEW_IMPL", "shift")
    assert CV.skew() == "pad"
    tab = CV.basepoint_table17()
    assert tab.shape == (9, 3, 17) and tab.dtype == np.int32
    for c, ref in enumerate((JC._B_TAB_YPX, JC._B_TAB_YMX, JC._B_TAB_XY2D)):
        np.testing.assert_array_equal(tab[:, c], ref)


@pytest.mark.slow
def test_plain_verify_under_mxu_equals_the_reference_under_mxu(corpus, monkeypatch):
    """The reference's general verify program under ``mxu``, traced afresh
    (its cached ``_verify_packed_jit`` would not retrace when the module
    global flips), against the port's plain verify under ``mxu``."""
    import jax

    from mochi_tpu.crypto import curve as JC
    from mochi_tpu.crypto import field as JF
    from mochi_tpu_torch.crypto import curve
    from mochi_tpu_torch.crypto import field as F

    rows, jax_out = corpus
    arrays = JBV.prepare_packed([JItem(*r) for r in rows])
    monkeypatch.setattr(JF, "SKEW_IMPL", "mxu")
    monkeypatch.setattr(F, "SKEW_IMPL", "mxu")
    ref = np.asarray(jax.jit(JC.verify_prepared_packed)(*arrays[:6]))
    mine = curve.verify_prepared_packed(*CV.from_reference_prepared(arrays, "cpu"))
    assert mine.tolist() == ref.tolist()
    assert np.logical_and(ref, arrays[6]).tolist() == jax_out
