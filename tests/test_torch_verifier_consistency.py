"""The reference's review regressions on the port: host/device verdict
parity, and the chunking that carries a batch above one launch.

For BFT safety every replica must reach the SAME verdict on the same bytes
regardless of verify backend; divergence lets an adversary split honest
replicas' quorums (review finding on non-canonical encodings).  The
"device" path here is the kernels' plain versions on the CPU.  The
reference's two bucket-readiness cases pin XLA's per-shape compile, which a
CUDA kernel does not have; the window cases stand in their place.
"""

import numpy as np
import pytest
import torch

from mochi_tpu_torch.crypto import batch_verify, keys
from mochi_tpu_torch.verifier.spi import VerifyItem

P = (1 << 255) - 19
L = (1 << 252) + 27742317777372353535851937790883648493


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain versions run small tensors: one intra-op thread keeps this
    file's worker from contending with the others' for the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_non_canonical_pubkey_rejected_on_both_paths():
    # Non-canonical identity encoding: y = p+1 ≡ 1 (the identity point),
    # R = identity, S = 0 satisfies OpenSSL's decode-mod-p check but MUST be
    # rejected identically everywhere.
    pub = (P + 1).to_bytes(32, "little")
    sig = (1).to_bytes(32, "little") + (0).to_bytes(32, "little")
    msg = b"split-brain attempt"
    assert keys.verify(pub, msg, sig) is False
    assert batch_verify.verify_batch([VerifyItem(pub, msg, sig)], device="cpu") == [False]


def test_non_canonical_r_and_s_rejected_on_both_paths():
    kp = keys.generate_keypair()
    msg = b"hello"
    sig = bytearray(kp.sign(msg))
    # S >= L
    bad_s = sig[:32] + (L).to_bytes(32, "little")
    assert keys.verify(kp.public_key, msg, bytes(bad_s)) is False
    assert batch_verify.verify_batch([VerifyItem(kp.public_key, msg, bytes(bad_s))], device="cpu") == [False]
    # R with y >= p
    bad_r = (P + 3).to_bytes(32, "little") + sig[32:]
    assert keys.verify(kp.public_key, msg, bytes(bad_r)) is False
    assert batch_verify.verify_batch([VerifyItem(kp.public_key, msg, bytes(bad_r))], device="cpu") == [False]


def test_valid_signatures_still_pass_both_paths():
    kp = keys.generate_keypair()
    msg = b"canonical"
    sig = kp.sign(msg)
    assert keys.verify(kp.public_key, msg, sig) is True
    assert batch_verify.verify_batch([VerifyItem(kp.public_key, msg, sig)], device="cpu") == [True]


def _window_items(n_valid: int, n_rejected: int, seed: int = 0):
    """Valid signatures of two keys, a few forged, then host-rejected items
    (S >= L, a short key): the expected verdicts beside them."""
    rng = np.random.default_rng(seed)
    kps = [keys.keypair_from_seed(bytes([7 + k]) * 32) for k in range(2)]
    items, want = [], []
    for i in range(n_valid):
        kp = kps[i % 2]
        msg = b"w%d" % i + rng.bytes(8)
        sig = kp.sign(msg)
        ok = i % 9 != 4
        if not ok:
            sig = sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]
        items.append(VerifyItem(kp.public_key, msg, sig))
        want.append(ok)
    good = items[0]
    for i in range(n_rejected):
        if i % 2:
            items.append(VerifyItem(good.public_key, good.message, good.signature[:32] + L.to_bytes(32, "little")))
        else:
            items.append(VerifyItem(good.public_key[:31], good.message, good.signature))
        want.append(False)
    return items, want


def _count_window(monkeypatch):
    """Wrap the launch path: chunks launched, peak in flight, empty chunks."""
    st = {"in_flight": 0, "peak": 0, "chunks": 0, "empty": 0, "threads": set()}
    dispatch0, readback0, prepare0 = batch_verify._dispatch, batch_verify._readback, batch_verify.prepare_packed

    def dispatch(prepared, device, k=0, comb=None):
        launched = dispatch0(prepared, device, k, comb)
        st["chunks"] += 1
        st["empty"] += launched[0] is None
        st["in_flight"] += 1
        st["peak"] = max(st["peak"], st["in_flight"])
        return launched

    def readback(launched):
        st["in_flight"] -= 1
        return readback0(launched)

    def prepare(items):
        import threading

        st["threads"].add(threading.current_thread().name)
        return prepare0(items)

    monkeypatch.setattr(batch_verify, "_dispatch", dispatch)
    monkeypatch.setattr(batch_verify, "_readback", readback)
    monkeypatch.setattr(batch_verify, "prepare_packed", prepare)
    return st


def test_backend_chunks_behind_a_window_of_four(monkeypatch):
    """Replaces the reference's ready-bucket case (XLA's per-shape compile
    readiness has no counterpart on the card): a batch above MAX_LAUNCH is
    cut into chunks that a prepare worker thread prepares ahead, with at
    most four launched and not yet read back, and every verdict right."""
    monkeypatch.setattr(batch_verify, "MAX_LAUNCH", 16)
    st = _count_window(monkeypatch)
    items, want = _window_items(90, 30)
    backend = batch_verify.TorchBatchBackend(device="cpu", min_device_items=0)
    assert list(backend(items)) == want
    assert st["chunks"] == 8 and st["peak"] == batch_verify._PIPELINE_DEPTH == 4 and st["in_flight"] == 0
    assert any(name.startswith("mochi-prep") for name in st["threads"])


def test_all_rejected_chunk_launches_nothing_in_the_window(monkeypatch):
    """Replaces the reference's failed-bucket case: a chunk whose items the
    host prechecks all reject goes through the window without reaching the
    device and is not counted as a dispatch, its verdicts all False."""
    monkeypatch.setattr(batch_verify, "MAX_LAUNCH", 16)
    st = _count_window(monkeypatch)
    items, want = _window_items(16, 48)
    batch_verify.reset_counts()
    assert batch_verify.verify_batch(items, device="cpu") == want
    assert st["chunks"] == 4 and st["empty"] == 3
    assert batch_verify.device_dispatch_count() == 1 and batch_verify.device_item_count() == 16


def test_a_launch_failure_in_the_window_raises(monkeypatch):
    """No fallback hides a failed launch: the third chunk's launch error
    reaches the caller of verify_batch, with no verdicts returned."""
    monkeypatch.setattr(batch_verify, "MAX_LAUNCH", 16)
    dispatch0, calls = batch_verify._dispatch, []

    def dispatch(prepared, device, k=0, comb=None):
        calls.append(len(prepared[6]))
        if len(calls) == 3:
            raise RuntimeError("launch refused in the window")
        return dispatch0(prepared, device, k, comb)

    monkeypatch.setattr(batch_verify, "_dispatch", dispatch)
    items, _ = _window_items(64, 0)
    with pytest.raises(RuntimeError, match="launch refused in the window"):
        batch_verify.verify_batch(items, device="cpu")
    assert calls == [16, 16, 16]


def test_a_mixed_batch_of_one_chunk_each_launches_both_before_reading(monkeypatch):
    """A mixed batch whose comb and general halves each fit one launch
    launches both before reading either back, prepared on the caller's
    thread (the reference's mixed single-chunk case)."""
    from mochi_tpu_torch.crypto.comb import SignerRegistry

    st = _count_window(monkeypatch)
    items, want = _window_items(12, 2)
    reg = SignerRegistry("cpu")
    reg.register_all([items[0].public_key])
    assert batch_verify.verify_batch(items, device="cpu", registry=reg) == want
    assert st["chunks"] == 2 and st["peak"] == 2
    assert not any(name.startswith("mochi-prep") for name in st["threads"])


def test_window_verdicts_equal_the_reference_at_three_chunk_sizes(monkeypatch):
    """The same items through the reference's verify_batch (its own
    chunking at its smallest bucket) and the port's at three chunk sizes,
    comb and general routes mixed: verdicts equal each other, OpenSSL's
    and the expected ones, never more than four chunks in flight."""
    from mochi_tpu.crypto import batch_verify as ref_bv
    from mochi_tpu.verifier.spi import VerifyItem as RefItem
    from mochi_tpu_torch.crypto.comb import SignerRegistry

    items, want = _window_items(48, 16, seed=3)
    monkeypatch.setattr(ref_bv, "MAX_BUCKET", 16)
    ref = ref_bv.verify_batch([RefItem(i.public_key, i.message, i.signature) for i in items])
    assert ref == want
    assert [keys.verify(i.public_key, i.message, i.signature) for i in items] == want
    reg = SignerRegistry("cpu")
    reg.register_all([items[1].public_key])
    st = _count_window(monkeypatch)
    for size in (16, 32, 64):
        monkeypatch.setattr(batch_verify, "MAX_LAUNCH", size)
        st["peak"] = 0
        assert batch_verify.verify_batch(items, device="cpu", registry=reg) == ref, size
        assert 1 <= st["peak"] <= 4 and st["in_flight"] == 0


def test_small_batches_take_the_cpu_crossover(monkeypatch):
    """Below min_device_items the backend must verify on OpenSSL without
    touching the device path (a device launch costs a fixed round trip
    that would poison commit latency for thin traffic)."""
    calls = []
    real = batch_verify.verify_batch

    def spy(items, device="cuda", registry=None, comb_gen=None):
        calls.append(len(items))
        return real(items, device=device, registry=registry, comb_gen=comb_gen)

    monkeypatch.setattr(batch_verify, "verify_batch", spy)
    backend = batch_verify.TorchBatchBackend(device="cpu", min_device_items=64)
    kp2 = keys.generate_keypair()
    items = [VerifyItem(kp2.public_key, b"c%d" % i, kp2.sign(b"c%d" % i)) for i in range(20)]
    bad = bytearray(items[4].signature)
    bad[1] ^= 1
    items[4] = VerifyItem(items[4].public_key, items[4].message, bytes(bad))
    out = backend(items)
    assert list(out) == [i != 4 for i in range(20)]
    assert not calls, "device path was used below the crossover"
    # at/above the threshold the device path engages
    big = [VerifyItem(kp2.public_key, b"d%d" % i, kp2.sign(b"d%d" % i)) for i in range(64)]
    assert all(backend(big))
    assert calls, "device path not used at the crossover"
