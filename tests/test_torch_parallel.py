"""The port's multi-device data plane against the JAX package, on the CPU.

The quorum tally's plain version against the reference's own expression
(``jnp.zeros(n).at[ids].add(v, mode="drop")``), including its index rule
for negative and out-of-range ids, and the CUDA slot rule and a warp's
walk of the tally kernel with the fused commit (``tally.cuh``, built here
with g++, the warp intrinsics emulated by its serial twin) against the
same; ``make_quorum_step`` on one slice taking the fused tally-and-commit;
``pad_to_multiple`` byte for byte;
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


WALK_SHIM = r"""
#include "tally.cuh"
// The kernel's grid, serially: every warp of 32 MOCHI_TALLY_STEPS lanes (at
// least one, as the fused launch) walks its lanes into `counts`, then the
// last block's `threads` threads write the commits.  Returns the adds.
extern "C" int t_walk(const uint8_t* bitmap, const uint8_t* pre_ok, const int32_t* ids, int n, int n_groups,
                      int threshold, int threads, int32_t* counts, uint8_t* committed, int32_t* log, int cap) {
  const int lanes = 32 * MOCHI_TALLY_STEPS;
  const int warps = n > 0 ? (n + lanes - 1) / lanes : 1;
  int n_log = 0;
  for (int g = 0; g < n_groups; ++g) counts[g] = 0;
  for (int w = 0; w < warps; ++w) {
    const tally_serial_warp ln{w, log, cap, &n_log};
    tally_warp_walk(ln, bitmap, pre_ok, ids, (int64_t)w * lanes, n, n_groups, counts);
  }
  for (int t = 0; t < threads; ++t) tally_commit_slots(counts, n_groups, threshold, committed, t, threads);
  return n_log;
}
extern "C" int t_lanes_a_warp(void) { return 32 * MOCHI_TALLY_STEPS; }
"""


@pytest.fixture(scope="module")
def walk_lib(tmp_path_factory):
    """csrc/tally.cuh's warp walk and its serial twin (32 lanes in one
    thread, the warp intrinsics emulated), built for the host with g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host build of the tally walk needs it")
    d = tmp_path_factory.mktemp("walk")
    (d / "walk.cpp").write_text(WALK_SHIM)
    so = d / "walk.so"
    proc = subprocess.run([gxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-Wall", "-Werror", "-fwrapv",
                           "-I", str(kernels.CSRC), "-o", str(so), str(d / "walk.cpp")],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(so))


def _walk(lib, bitmap, pre_ok, ids, g, threshold):
    """The twin's counts, commits and adds, each add (warp, step, slot, votes)."""
    n = len(ids)
    bitmap, pre_ok = (np.ascontiguousarray(a, dtype=np.uint8) for a in (bitmap, pre_ok))
    ids = np.ascontiguousarray(ids, dtype=np.int32)
    counts, committed = np.empty(g, np.int32), np.empty(g, np.uint8)
    cap = 4 * n + 64
    log = np.empty((cap, 4), np.int32)
    u8p, i32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32)
    adds = lib.t_walk(bitmap.ctypes.data_as(u8p), pre_ok.ctypes.data_as(u8p), ids.ctypes.data_as(i32p), n, g,
                      threshold, 128, counts.ctypes.data_as(i32p), committed.ctypes.data_as(u8p),
                      log.ctypes.data_as(i32p), cap)
    assert adds <= cap
    return counts, committed.astype(bool), log[:adds]


def _walk_case(name):
    """(bitmap, pre_ok, ids, n_groups, slots contiguous) of a named case."""
    rng = np.random.default_rng(sum(name.encode()))
    if name == "sorted runs of 43":  # the certificate stream's shape
        g = 1537
        ids = np.repeat(np.arange(g - 1), 43)
        return rng.random(len(ids)) < 0.97, rng.random(len(ids)) < 0.99, ids, g, True
    if name.startswith("runs across warp and block edges"):
        lengths = rng.integers(1, 700, 40)
        lengths[:6] = [250, 780, 6, 1024, 1, 300]  # across a warp's 256 lanes, a block's 1024
        ids = np.repeat(np.arange(len(lengths)), lengths)
        return rng.random(len(ids)) < 0.9, rng.random(len(ids)) < 0.95, ids, len(lengths) + 1, True
    if name == "one slot for every lane":
        n = 66048
        return np.ones(n, bool), np.ones(n, bool), np.zeros(n, np.int64), 1537, True
    if name == "random ids, wrap and drop":
        bitmap, pre_ok, ids, g = _tally_case("seeded, wrap and drop")
        return bitmap, pre_ok, ids, g, False
    if name == "runs of wrapping and dropped ids":
        g = 9
        ids = np.repeat(rng.integers(-2 * g, 2 * g, 60), rng.integers(1, 90, 60))
        return rng.random(len(ids)) < 0.8, rng.random(len(ids)) < 0.9, ids, g, False
    n = int(name.split()[0])  # "<n> lanes": sorted random slots
    ids = np.sort(rng.integers(0, 5, n))
    return rng.random(n) < 0.8, np.ones(n, bool), ids, 5, True


WALK_CASES = ["sorted runs of 43", "runs across warp and block edges", "runs across warp and block edges 2",
              "one slot for every lane", "random ids, wrap and drop", "runs of wrapping and dropped ids",
              "0 lanes", "1 lanes", "31 lanes", "32 lanes", "33 lanes", "257 lanes"]


@pytest.mark.parametrize("name", WALK_CASES)
def test_the_kernel_warp_walk_equals_the_reference_scatter(walk_lib, name):
    """csrc/tally.cuh's warp walk, as the tally kernel runs it but with the
    warp intrinsics emulated: its adds, summed, and the fused commit equal
    the reference's scatter and ``>= threshold``; no slot takes two adds in
    one warp step; where each slot's lanes are contiguous, a warp adds once
    for each slot it holds votes of."""
    bitmap, pre_ok, ids, g, contiguous = _walk_case(name)
    want = _reference_tally(bitmap, pre_ok, ids.astype(np.int32), g)
    lanes_a_warp = walk_lib.t_lanes_a_warp()
    for threshold in (0, 1, 43, 44):
        counts, committed, log = _walk(walk_lib, bitmap, pre_ok, ids, g, threshold)
        assert counts.tolist() == want.tolist()
        assert committed.tolist() == (want >= threshold).tolist()
    assert (log[:, 3] > 0).all() and ((log[:, 2] >= 0) & (log[:, 2] < g)).all()
    assert np.bincount(log[:, 2], weights=log[:, 3], minlength=g).astype(np.int64).tolist() == want.tolist()
    assert len({tuple(e) for e in log[:, :3].tolist()}) == len(log)  # one add a slot a warp step
    if contiguous:
        slots = np.where(ids < 0, ids + g, ids)
        voted = np.logical_and(bitmap, pre_ok)
        pairs = {(i // lanes_a_warp, int(slots[i])) for i in np.flatnonzero(voted)}
        assert len(log) == len(pairs)
    if name == "one slot for every lane":
        assert len(log) == len(ids) // lanes_a_warp  # one atomic a warp, not one a vote


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


def test_quorum_step_on_one_slice_takes_the_fused_tally_and_commit(monkeypatch):
    """A one-slice mesh with no process group: the step calls the fused
    tally-and-commit once and neither the tally nor the commit alone, and
    returns what the two-call path (a two-slice mesh) returns, also when the
    prechecks reject every lane."""
    n, g = 16, 5
    group_ids = np.random.default_rng(3).integers(-g, g + 2, n).astype(np.int32)
    prepared = BV.prepare_packed(_signed_items(n, forge={2, 9}))
    rejected = (*prepared[:6], np.zeros(n, bool))
    two = make_mesh(devices=["cpu", "cpu"])
    want = [make_quorum_step(two, g)(*p, group_ids, 2) for p in (prepared, rejected)]
    calls = []

    def fused(*args):
        calls.append(args[-2:])
        return real_fused(*args)

    def refuse(*args):
        raise AssertionError("a one-slice step called the tally or the commit alone")

    real_fused = S.cuda_tally.quorum_tally_commit
    monkeypatch.setattr(S.cuda_tally, "quorum_tally_commit", fused)
    monkeypatch.setattr(S.cuda_tally, "quorum_tally", refuse)
    monkeypatch.setattr(S.cuda_tally, "quorum_commit", refuse)
    one = make_mesh(devices=["cpu"])
    assert one.size == 1 and one.group is None
    for p, w in zip((prepared, rejected), want):
        got = make_quorum_step(one, g)(*p, group_ids, 2)
        for a, b in zip(got, w):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert calls == [(g, 2), (g, 2)]
    assert want[0][1].sum() > 0 and want[1][1].tolist() == [0] * g and want[1][2].tolist() == [False] * g


def test_fused_tally_commit_plain_version_equals_the_reference():
    bitmap, pre_ok, ids, g = _tally_case("seeded, wrap and drop")
    want = _reference_tally(bitmap, pre_ok, ids, g)
    for threshold in (0, 1, 43, 44, 130):
        counts, committed = S.cuda_tally.quorum_tally_commit(
            torch.from_numpy(bitmap), torch.from_numpy(pre_ok), torch.from_numpy(ids), g, threshold)
        assert counts.dtype == torch.int32 and counts.tolist() == want.tolist()
        assert committed.dtype == torch.bool and committed.tolist() == (want >= threshold).tolist()
    with pytest.raises(ValueError, match="negative"):
        S.cuda_tally.quorum_tally_commit(torch.from_numpy(bitmap), torch.from_numpy(pre_ok),
                                         torch.from_numpy(ids), -1, 1)


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


def _cut_batch(n, rejected=range(0)):
    """``_signed_items(n)`` with lanes 3, 20, 41 and 50 forged, and every
    lane of ``rejected`` replaced by one the host prechecks reject (the two
    of :func:`_host_rejected_items` in turn)."""
    items = _signed_items(n, forge={3, 20, 41, 50})
    bad = _host_rejected_items()
    for i in rejected:
        items[i] = bad[i % 2]
    return items


# (lanes, host-rejected lanes) under MAX_LAUNCH = 16: the slice is cut into
# n // 16 parts as even as they go when that is 2 or more
CUT_CASES = {
    "64 lanes in 4 parts": (64, range(0)),
    "64 lanes, part 2 rejected whole": (64, range(16, 32)),
    "72 lanes in 4 uneven parts, the last rejected whole": (72, range(54, 72)),
    "40 lanes in 2 parts, the first rejected whole": (40, range(0, 20)),
    "48 lanes, every part rejected": (48, range(48)),
    "24 lanes, under 2 x MAX_LAUNCH: one launch": (24, range(0, 12)),
}


@pytest.fixture
def one_thread():
    """The plain versions at a few dozen lanes gain little from threads,
    and the test workers share the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("name", list(CUT_CASES))
def test_quorum_step_cut_into_parts_equals_the_uncut_step_and_the_reference(name, monkeypatch, one_thread):
    """A one-slice step with ``MAX_LAUNCH`` patched to 16: the slice is
    staged and launched in n // 16 parts into one bitmap (a part the
    prechecks reject whole launches nothing); bitmap, counts and commits
    equal the same step uncut (the real ``MAX_LAUNCH``) and the reference's
    verdicts and tally; each launched part is one dispatch of its lanes."""
    n, rejected = CUT_CASES[name]
    g, threshold = 5, 3
    items = _cut_batch(n, rejected)
    prepared = BV.prepare_packed(items)
    assert not prepared[6][list(rejected)].any()
    ids = np.random.default_rng(n).integers(-g, g + 2, n).astype(np.int32)
    step = make_quorum_step(make_mesh(devices=["cpu"]), g)
    assert BV.MAX_LAUNCH >= n
    before = BV.device_dispatch_count()
    uncut = step(*prepared, ids, threshold)
    assert BV.device_dispatch_count() - before == int(prepared[6].any())
    monkeypatch.setattr(BV, "MAX_LAUNCH", 16)
    parts = S._bounds(n, n // 16) if n >= 32 else [(0, n)]
    launched = [(lo, hi) for lo, hi in parts if prepared[6][lo:hi].any()]
    before = (BV.device_dispatch_count(), BV.device_item_count())
    got = step(*prepared, ids, threshold)
    assert (BV.device_dispatch_count(), BV.device_item_count()) == (
        before[0] + len(launched), before[1] + sum(hi - lo for lo, hi in launched))
    for a, b in zip(got, uncut):
        assert a.dtype == b.dtype and torch.equal(a, b)
    want = [jkeys.verify(i.public_key, i.message, i.signature) for i in items]
    assert got[0].tolist() == want
    ref = _reference_tally(np.asarray(want), np.ones(n, bool), ids, g)
    assert got[1].tolist() == ref.tolist() and got[2].tolist() == (ref >= threshold).tolist()
    if n == 24:
        assert len(launched) == 1


def test_sharded_comb_verify_cut_into_parts_equals_the_uncut_verdicts(monkeypatch, one_thread):
    """``make_sharded_verify_comb`` on two CPU slices of 36 lanes with
    ``MAX_LAUNCH`` patched to 16: two comb launches of 18 lanes a slice,
    the verdicts those of the uncut slices."""
    from mochi_tpu_torch.crypto import comb

    kps = [keys.keypair_from_seed(bytes([k + 90] * 32)) for k in range(4)]
    items = []
    for i in range(72):
        kp = kps[i % 4]
        msg = b"cut comb %d" % i
        sig = kp.sign(msg)
        if i in (5, 30, 60):
            sig = bytes([sig[0] ^ 1]) + sig[1:]
        items.append(VerifyItem(kp.public_key, msg, sig))
    reg = comb.SignerRegistry("cpu")
    reg.register_all([kp.public_key for kp in kps])
    kidx = np.asarray([reg.index_of(i.public_key) for i in items], np.int32)
    packed = BV.prepare_packed(items)
    verify = S.make_sharded_verify_comb(make_mesh(devices=["cpu"] * 2))
    before = BV.comb_dispatch_count()
    uncut = verify(reg, kidx, *packed[2:6])
    assert BV.comb_dispatch_count() == before + 2
    monkeypatch.setattr(BV, "MAX_LAUNCH", 16)
    got = verify(reg, kidx, *packed[2:6])
    assert BV.comb_dispatch_count() == before + 2 + 4
    assert torch.equal(got, uncut)
    assert got.tolist() == [i not in (5, 30, 60) for i in range(72)]


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
