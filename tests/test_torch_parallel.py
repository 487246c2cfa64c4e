"""The port's multi-device data plane against the JAX package, on the CPU.

The quorum tally's plain version against the reference's own expression
(``jnp.zeros(n).at[ids].add(v, mode="drop")``), including its index rule
for negative and out-of-range ids, and the CUDA slot rule (``tally.cuh``,
built here with g++) against the same; ``pad_to_multiple`` byte for byte;
``make_quorum_step`` over an 8-slice CPU mesh on ``tests/test_parallel.py``'s
cases; the lanes the reference's step counts although the host rejected
them; the sharded backend and verifier on CPU slices, behind the verifier
service; and the ``cuda-sharded`` service backend refusing to start without
a card.  Tolerance zero throughout: these are counts and verdicts.
"""

import asyncio
import ctypes
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mochi_tpu.crypto import batch_verify as JBV
from mochi_tpu.crypto import keys as jkeys
from mochi_tpu.parallel import sharded as JS
from mochi_tpu.verifier.spi import VerifyItem as JItem
from mochi_tpu_torch import kernels
from mochi_tpu_torch.crypto import batch_verify as BV
from mochi_tpu_torch.crypto import cuda_verify as CV
from mochi_tpu_torch.crypto import keys
from mochi_tpu_torch.parallel import make_mesh, make_quorum_step, make_sharded_verify, pad_to_multiple
from mochi_tpu_torch.parallel import sharded as S
from mochi_tpu_torch.verifier.cuda import CudaBatchVerifier, ShardedCudaBatchBackend, ShardedCudaBatchVerifier
from mochi_tpu_torch.verifier.spi import VerifyItem

P = (1 << 255) - 19
L = (1 << 252) + 27742317777372353535851937790883648493
B_ENC = bytes.fromhex("5866666666666666666666666666666666666666666666666666666666666666")


def run(coro, timeout=240):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _signed_items(n, forge=()):
    """tests/test_parallel.py's batch: key i from seed (i + 7) % 251, the
    first signature byte flipped on the forged lanes."""
    items = []
    for i in range(n):
        kp = keys.keypair_from_seed(bytes([(i + 7) % 251] * 32))
        msg = b"parallel test %d" % i
        sig = bytearray(kp.sign(msg))
        if i in forge:
            sig[0] ^= 0xFF
        items.append(VerifyItem(kp.public_key, msg, bytes(sig)))
    return items


def _reference_tally(bitmap, pre_ok, ids, n_groups):
    votes = jnp.asarray(np.logical_and(bitmap, pre_ok).astype(np.int32))
    return np.asarray(jnp.zeros(n_groups, dtype=jnp.int32).at[jnp.asarray(ids)].add(votes, mode="drop"))


def _tally_case(name):
    rng = np.random.default_rng(sum(name.encode()))
    if name == "empty":
        return np.zeros(0, bool), np.zeros(0, bool), np.zeros(0, np.int32), 5
    if name == "one group":
        n, g = 300, 1
    elif name == "the wrap example":
        ids = np.asarray([0, 1, -1, 3, 4, -5, -6, 2], np.int32)
        return np.ones(8, bool), np.ones(8, bool), ids, 4
    else:
        n, g = 5000, 37
    ids = rng.integers(-3 * g, 3 * g, size=n).astype(np.int32)
    ids[:4] = [-g, -g - 1, g, g - 1]  # the edges of the wrap and of the drop
    return rng.random(n) < 0.8, rng.random(n) < 0.9, ids, g


@pytest.mark.parametrize("name", ["the wrap example", "seeded, wrap and drop", "one group", "empty"])
def test_segment_tally_equals_the_reference_scatter(name):
    bitmap, pre_ok, ids, g = _tally_case(name)
    want = _reference_tally(bitmap, pre_ok, ids, g)
    got = S.segment_tally(torch.from_numpy(bitmap), torch.from_numpy(pre_ok), torch.from_numpy(ids), g)
    assert got.dtype == torch.int32 and got.tolist() == want.tolist()
    if name == "the wrap example":
        assert want.tolist() == [1, 1, 1, 2]
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(S.cuda_tally.quorum_tally(torch.from_numpy(bitmap), torch.from_numpy(pre_ok),
                                                 torch.from_numpy(ids), g), got)
    assert S.commit(got, 3).tolist() == (want >= 3).tolist()


SLOT_SHIM = r"""
#include "tally.cuh"
extern "C" void t_slots(const int32_t* ids, int n, int n_groups, int32_t* out) {
  for (int i = 0; i < n; ++i) out[i] = quorum_slot(ids[i], n_groups);
}
"""


def test_the_kernel_slot_rule_equals_the_reference(tmp_path):
    """csrc/tally.cuh, the slot rule the tally kernel applies per lane, built
    for the host: its slots, counted, equal the reference's scatter."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host build of the slot rule needs it")
    (tmp_path / "slots.cpp").write_text(SLOT_SHIM)
    so = tmp_path / "slots.so"
    proc = subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-Wall", "-Werror",
                           "-I", str(kernels.CSRC), "-o", str(so), str(tmp_path / "slots.cpp")],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(so))
    i32p = ctypes.POINTER(ctypes.c_int32)
    for g in (0, 1, 4, 37):
        ids = np.concatenate([np.arange(-3 * g - 2, 3 * g + 3),
                              [-(1 << 31), (1 << 31) - 1, -(1 << 31) + 1]]).astype(np.int32)
        out = np.empty_like(ids)
        lib.t_slots(ids.ctypes.data_as(i32p), len(ids), g, out.ctypes.data_as(i32p))
        kept = out >= 0
        assert (out[kept] < g).all() if g else not kept.any()
        counted = np.bincount(out[kept], minlength=g)
        assert counted.tolist() == _reference_tally(np.ones(len(ids), bool), np.ones(len(ids), bool), ids, g).tolist()


def test_pad_to_multiple_is_byte_equal_to_the_reference():
    rng = np.random.default_rng(4)
    for n, multiple in [(10, 8), (16, 8), (1, 3), (0, 4), (37, 2)]:
        arrays = (rng.integers(0, 1 << 15, (n, 17)).astype(np.int32), rng.integers(0, 2, n).astype(np.int32),
                  rng.integers(0, 256, (n, 32)).astype(np.uint8), rng.random(n) < 0.5,
                  rng.integers(0, 5, n).astype(np.int32))
        mine, m = pad_to_multiple(arrays, n, multiple, dead_group=5)
        ref, m_ref = JS.pad_to_multiple(arrays, n, multiple, dead_group=5)
        assert m == m_ref and m % multiple == 0
        for a, b in zip(mine, ref):
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.fixture(scope="module")
def mesh8():
    return make_mesh(devices=["cpu"] * 8)


def test_quorum_step_tally_and_commit(mesh8):
    # tests/test_parallel.py's case: 4 slots x 4 votes, forged items 1 (slot
    # 1), 2, 6, 10 (slot 2); with threshold 3 slots {0, 1, 3} commit
    n, n_groups = 16, 4
    group_ids = (np.arange(n) % n_groups).astype(np.int32)
    prepared = BV.prepare_packed(_signed_items(n, forge={1, 2, 6, 10}))
    bitmap, counts, committed = make_quorum_step(mesh8, n_groups)(*prepared, group_ids, np.int32(3))
    assert counts.dtype == torch.int32 and counts.tolist() == [4, 3, 1, 4]
    assert committed.dtype == torch.bool and committed.tolist() == [True, True, False, True]
    assert bitmap.shape == (16,) and int(bitmap.sum()) == 12


def test_quorum_step_dead_group_padding(mesh8):
    n, n_groups = 10, 3
    group_ids = (np.arange(n) % n_groups).astype(np.int32)
    prepared = BV.prepare_packed(_signed_items(n))
    arrays, m = pad_to_multiple((*prepared, group_ids), n, 8, dead_group=n_groups)
    assert m == 16
    bitmap, counts, committed = make_quorum_step(mesh8, n_groups + 1)(*arrays, np.int32(4))
    assert bitmap[:n].all() and not bitmap[n:].any()
    assert counts[:n_groups].tolist() == np.bincount(group_ids, minlength=n_groups).tolist()
    assert counts[n_groups] == 0 and committed.tolist() == [True, False, False, False]


def test_quorum_step_refuses_an_unpadded_batch(mesh8):
    prepared = BV.prepare_packed(_signed_items(3))
    with pytest.raises(ValueError, match="pad it with pad_to_multiple"):
        make_quorum_step(mesh8, 2)(*prepared, np.zeros(3, np.int32), 1)
    with pytest.raises(ValueError, match="negative"):
        make_quorum_step(mesh8, -1)
    with pytest.raises(ValueError, match="one type"):
        make_mesh(devices=["cpu", "meta"])


def _host_rejected_items():
    """Two lanes the host prechecks reject but whose device lanes accept
    (h stays 0 there, so the device checks only [S]B == R): A the
    non-canonical y = p + 1 with R = B, S = 1; a valid A with R = B,
    S = L + 1."""
    kp = keys.keypair_from_seed(bytes([3] * 32))
    return [
        VerifyItem((P + 1).to_bytes(32, "little"), b"rejected 1", B_ENC + (1).to_bytes(32, "little")),
        VerifyItem(kp.public_key, b"rejected 2", B_ENC + (L + 1).to_bytes(32, "little")),
    ]


def test_quorum_step_does_not_count_host_rejected_lanes():
    bad = _host_rejected_items()
    assert [jkeys.verify(i.public_key, i.message, i.signature) for i in bad] == [False, False]
    assert [keys.verify(i.public_key, i.message, i.signature) for i in bad] == [False, False]
    items = bad + _signed_items(2)
    prepared = BV.prepare_packed(items)
    assert prepared[6].tolist() == [False, False, True, True]
    # the device lanes (the plain version of the kernel) accept all four
    raw = CV.verify_prepared_packed(*CV.from_reference_prepared(prepared, "cpu"))
    assert raw.tolist() == [True] * 4
    mesh = make_mesh(devices=["cpu", "cpu"])
    bitmap, counts, committed = make_quorum_step(mesh, 1)(*prepared, np.zeros(4, np.int32), 3)
    assert bitmap.tolist() == [False, False, True, True]
    assert counts.tolist() == [2] and committed.tolist() == [False]


@pytest.mark.slow
def test_the_reference_device_program_accepts_the_host_rejected_lanes():
    """The reference's own device program says True on both lanes (its
    callers AND with pre_ok; its quorum step does not)."""
    bad = [JItem(i.public_key, i.message, i.signature) for i in _host_rejected_items()]
    *arrays, pre_ok = JBV.prepare_packed(bad)
    assert pre_ok.tolist() == [False, False]
    padded = [np.pad(a, [(0, 14)] + [(0, 0)] * (a.ndim - 1)) for a in arrays]
    assert np.asarray(JBV._verify_packed_jit(*padded))[:2].tolist() == [True, True]


@pytest.mark.slow
def test_quorum_step_equals_the_reference_step_on_its_8_device_mesh(mesh8):
    import jax

    n, n_groups = 24, 5
    items = _signed_items(n, forge={0, 5, 11, 17})
    group_ids = np.random.default_rng(8).integers(-n_groups, n_groups + 2, n).astype(np.int32)
    ref_step = JS.make_quorum_step(JS.make_mesh(8, devices=jax.devices()[:8]), n_groups)
    jitems = [JItem(i.public_key, i.message, i.signature) for i in items]
    r_bitmap, r_counts, r_committed = ref_step(*JBV.prepare(jitems)[:6], group_ids, np.int32(2))
    bitmap, counts, committed = make_quorum_step(mesh8, n_groups)(*BV.prepare_packed(items), group_ids, 2)
    assert bitmap.tolist() == np.asarray(r_bitmap).tolist()
    assert counts.tolist() == np.asarray(r_counts).tolist()
    assert committed.tolist() == np.asarray(r_committed).tolist()


def test_sharded_verify_forms_on_cpu_slices():
    items = _signed_items(6, forge={4})
    want = [i != 4 for i in range(6)]
    mesh = make_mesh(devices=["cpu"] * 3)
    jitems = [JItem(i.public_key, i.message, i.signature) for i in items]
    # the reference's bit-tensor form, packed on the host
    assert make_sharded_verify(mesh)(*JBV.prepare(jitems)[:6]).tolist() == want
    packed = BV.prepare_packed(items)
    assert S.make_sharded_verify_packed(mesh)(*packed[:6]).tolist() == want
    from mochi_tpu_torch.crypto import comb

    reg = comb.SignerRegistry("cpu")
    reg.register_all([i.public_key for i in items])
    kidx = np.asarray([reg.index_of(i.public_key) for i in items], np.int32)
    assert S.make_sharded_verify_comb(mesh)(reg, kidx, *packed[2:6]).tolist() == want


def test_sharded_backend_keeps_the_reference_semantics():
    """All-rejected skips the device; each slice that launches is one
    dispatch; comb routing is all-or-nothing per batch; verdicts equal the
    single-device backend's and OpenSSL's."""
    backend = ShardedCudaBatchBackend(make_mesh(devices=["cpu", "cpu"]), min_device_items=0)
    assert backend.n_devices == 2
    good = _signed_items(3, forge={1})
    garbage = [VerifyItem(i.public_key, i.message, i.signature[:32] + b"\xff" * 32) for i in good]
    BV.reset_counts()
    assert backend(garbage) == [False] * 3
    assert BV.device_dispatch_count() == 0
    assert backend(garbage + good[:1]) == [False, False, False, True]  # slice 0 is rejected whole
    assert BV.device_dispatch_count() == 1 and BV.device_item_count() == 2
    backend.register_signers([i.public_key for i in good])
    stranger = keys.generate_keypair()
    mixed = good + garbage + [VerifyItem(stranger.public_key, b"s", stranger.sign(b"s"))]
    want = [keys.verify(i.public_key, i.message, i.signature) for i in mixed]
    assert want == [True, False, True, False, False, False, True]
    assert backend(mixed) == want  # slices of 3 and 4 items, no padding
    assert BV.device_dispatch_count() == 3 and BV.comb_dispatch_count() == 0
    assert BV.device_item_count() == 9
    assert BV.comb_routing_counts() == {"comb_items": 0, "ladder_items": 7, "mixed_batches": 0}
    registered = [good[0], good[2], good[1]]
    assert backend(registered) == [True, True, False]
    assert BV.comb_dispatch_count() == 2 and BV.comb_routing_counts()["comb_items"] == 3
    assert BV.verify_batch(mixed, "cpu") == want


def test_sharded_verifier_behind_the_service_and_remote_verifier():
    """As tests/test_verifier_service.py runs the reference's sharded
    verifier: a mixed batch split over CPU slices answers what OpenSSL
    answers, here through the port's service and the reference's client."""
    from mochi_tpu.verifier.service import RemoteVerifier as JRemoteVerifier
    from mochi_tpu_torch.verifier.service import VerifierService

    kp = keys.generate_keypair()
    items, expect = [], []
    for i in range(10):
        msg = b"sh%d" % i
        sig = kp.sign(msg)
        if i % 6 == 2:
            sig = bytes([sig[0] ^ 1]) + sig[1:]
        items.append(JItem(kp.public_key, msg, sig))
        expect.append(i % 6 != 2)

    async def main():
        v = ShardedCudaBatchVerifier(devices=["cpu", "cpu"], max_delay_s=0.001, min_device_items=0,
                                     signers=[kp.public_key])
        assert v.backend.n_devices == 2 and v.max_batch == 2 * BV.MAX_LAUNCH
        service = VerifierService(port=0, verifier=v, secret=bytes(range(32)))
        await service.start()
        rv = JRemoteVerifier("127.0.0.1", service.bound_port, secret=bytes(range(32)), timeout_s=120)
        try:
            BV.reset_counts()
            assert await rv.verify_batch(items) == expect
            assert rv.fallback_batches == 0 and v.fallback_batches == 0
            assert BV.comb_routing_counts()["comb_items"] == 10
            st = service.status()["verifier"]["inner"]
            assert st["type"] == "ShardedCudaBatchVerifier" and st["comb"]["registered_signers"] == 1
        finally:
            await rv.close()
            await service.close()

    run(main())


def test_sharded_verifier_and_service_refuse_to_run_without_a_card(monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ShardedCudaBatchVerifier()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(devices=["cuda:0"])
        assert CudaBatchVerifier(device="cpu").backend.device.type == "cpu"
    if not torch.cuda.is_available():
        out = subprocess.run(
            [sys.executable, "-m", "mochi_tpu_torch.verifier.service", "--port", "0", "--backend", "cuda-sharded"],
            capture_output=True, text=True, timeout=120,
        )
        assert out.returncode != 0 and "no CUDA device" in out.stderr
        assert "READY" not in out.stdout
