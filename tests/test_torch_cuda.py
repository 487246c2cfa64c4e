"""The CUDA kernels (general verify and its mxu form, comb chain and tree
and the mxu form of each, quorum tally) on the card.

A CUDA kernel has no CPU mode, so every test here needs an NVIDIA card and
skips elsewhere.  On the card (this file imports no JAX, so the JAX-bound
``tests/conftest.py`` is left out):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import threading

import numpy as np
import pytest
import torch

import chip_smoke as cs
from mochi_tpu_torch.crypto import batch_verify as BV
from mochi_tpu_torch.crypto import cuda_verify as CV
from mochi_tpu_torch.crypto import curve
from mochi_tpu_torch.verifier.spi import VerifyItem

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def corpus(card):
    signers = cs.make_signers(np.random.default_rng(1), 16)
    return cs.make_corpus(2, 600, signers)


def test_kernel_equals_plain_version_and_expected_verdicts(card, corpus):
    items, want, _ = corpus
    prepared = BV.prepare_packed(items)
    tens = CV.from_reference_prepared(prepared, card)
    before = CV.launches["pad"]
    got = CV.verify_prepared_packed(*tens)
    assert CV.launches["pad"] == before + 1
    plain = curve.verify_prepared_packed(*tens)
    assert torch.equal(got, plain)
    assert (got.cpu().numpy() & prepared[6]).tolist() == want


@pytest.fixture(scope="module")
def tiled(card, corpus):
    """The corpus tiled to 65,536 lanes on the card, its prechecks and the
    expected verdicts."""
    items, want, _ = corpus
    prepared = BV.prepare_packed(items)
    reps = -(-65536 // len(items))
    tens = [torch.cat([t] * reps) for t in CV.from_reference_prepared(prepared, card)]
    return tens, np.tile(prepared[6], reps), list(want) * reps


@pytest.mark.parametrize("n", [1, 2, 31, 32, 33, 127, 128, 129, 344, 512, 8192, 65536])
def test_team_kernel_equals_plain_version_at_team_and_block_edges(card, tiled, n):
    """verify.cu (a team of four lanes a signature, 16 teams a block) at
    lane counts around a team, a warp and a block, the cluster's launch
    sizes, MAX_LAUNCH and 65,536: one launch, the plain version's bitmap
    lane for lane, the expected verdicts."""
    tens, pre_ok, want = tiled
    part = [t[:n] for t in tens]
    before = CV.launches["pad"]
    got = CV.verify_prepared_packed(*part)
    assert CV.launches["pad"] == before + 1
    assert torch.equal(got, curve.verify_prepared_packed(*part))
    assert (got.cpu().numpy() & pre_ok[:n]).tolist() == want[:n]


def test_team_kernel_accepts_the_host_rejected_lanes_raw(card):
    """The two lanes the host rejects while the device accepts them
    (ROADMAP Queue C): the kernel's raw bitmap says True on both, as the
    plain version's, alone and among other lanes."""
    signer = cs.make_signers(np.random.default_rng(3), 1)[0]
    items = cs.host_rejected_items(signer)
    prepared = BV.prepare_packed(items)
    assert prepared[6].tolist() == [False, False]
    tens = CV.from_reference_prepared(prepared, card)
    for n in (1, 2):
        got = CV.verify_prepared_packed(*(t[:n] for t in tens))
        assert got.tolist() == [True] * n
        assert torch.equal(got, curve.verify_prepared_packed(*(t[:n] for t in tens)))
    attrs = CV.kernel_attributes()
    assert attrs["team"] == 4 and attrs["threads"] == 64 and attrs["dynamic_shared_bytes"] == 0
    assert attrs["shared_bytes"] >= 16 * 1988


def test_wrapper_rejects_what_the_kernel_does_not_take(card, corpus):
    tens = list(CV.from_reference_prepared(BV.prepare_packed(corpus[0][:8]), card))
    bad = [t.clone() for t in tens]
    bad[0] = bad[0].to(torch.int64)
    with pytest.raises(TypeError):
        CV.verify_prepared_packed(*bad)
    bad = [t.clone() for t in tens]
    bad[4] = tens[4].t().contiguous().t()
    with pytest.raises(ValueError):
        CV.verify_prepared_packed(*bad)
    bad = [t.clone() for t in tens]
    bad[1] = bad[1][:4]
    with pytest.raises(ValueError):
        CV.verify_prepared_packed(*bad)
    assert CV.verify_prepared_packed(*(t[:0] for t in tens)).shape == (0,)


def test_chunked_and_concurrent_verify_batch(card, corpus, monkeypatch):
    items, want, _ = corpus
    monkeypatch.setattr(BV, "MAX_LAUNCH", 64)
    assert BV.verify_batch(items, card) == want
    results = {}

    def worker(k):
        results[k] = BV.verify_batch(items[k * 100 : (k + 1) * 100], card)

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert [results[k] for k in range(6)] == [want[k * 100 : (k + 1) * 100] for k in range(6)]


@pytest.fixture(scope="module")
def comb_setup(card):
    from mochi_tpu_torch.crypto import comb

    signers = cs.make_signers(np.random.default_rng(3), 16)
    items, want, _ = cs.make_comb_corpus(4, 600, signers)
    reg = comb.SignerRegistry(card)
    reg.register_all([s.pub for s in signers])
    return reg, items, want


def test_comb_kernel_equals_plain_version_and_expected_verdicts(card, comb_setup):
    from mochi_tpu_torch.crypto import comb
    from mochi_tpu_torch.crypto import cuda_comb as CC

    reg, items, want = comb_setup
    prepared = BV.prepare_packed(items)
    kidx = np.asarray([reg.index_of(it.public_key) for it in items], dtype=np.int32)
    kidx[5], kidx[9] = 10 ** 6, -4  # clipped into the table, never read past it
    lanes = CC.from_prepared(kidx, prepared, card)
    before = CC.launches["chain"]
    got = CC.verify_comb_prepared(reg.device_table(card, layout="radix25"), *lanes)
    assert CC.launches["chain"] == before + 1
    plain = comb.verify_comb_prepared(torch.from_numpy(reg.host_table()).to(card), *lanes)
    assert torch.equal(got, plain)
    ok = (got.cpu().numpy() & prepared[6]).tolist()
    assert [w for j, w in enumerate(want) if j not in (5, 9)] == [o for j, o in enumerate(ok) if j not in (5, 9)]


@pytest.fixture(scope="module")
def comb_tiled(card, comb_setup):
    """The comb corpus on the card with key indices past both ends of the
    table on three lanes, tiled to 8,192 lanes: (table, 17 x 15 rows, lane
    tensors, prechecks, expected verdicts, the clipped lanes' positions in
    the corpus, the corpus's length)."""
    from mochi_tpu_torch.crypto import cuda_comb as CC

    reg, items, want = comb_setup
    prepared = BV.prepare_packed(items)
    kidx = np.asarray([reg.index_of(it.public_key) for it in items], dtype=np.int32)
    clipped = {5: 10 ** 6, 9: -4, 40: len(reg)}
    for j, k in clipped.items():
        kidx[j] = k
    reps = -(-8192 // len(items))
    tiled = [torch.cat([t] * reps) for t in CC.from_prepared(kidx, prepared, card)]
    return (reg.device_table(card, layout="radix25"), torch.from_numpy(reg.host_table()).to(card), tiled,
            np.tile(prepared[6], reps), list(want) * reps, set(clipped), len(items))


@pytest.mark.parametrize("n", [1, 3, 5, 31, 32, 33, 63, 65, 2752, 5632, 8192])
def test_comb_team_kernel_equals_plain_chain_at_team_warp_and_block_edges(card, comb_tiled, n):
    """comb.cu (a team of four lanes a signature, one in each of a block's
    four warps, 32 signatures a block) at lane counts around a team, a warp
    and a block, the service's and the cluster's launch sizes and
    MAX_LAUNCH, with clipped key indices: one launch counted as ``chain``,
    the plain chain's bitmap lane for lane, the expected verdicts on every
    lane whose index is the signer's."""
    from mochi_tpu_torch.crypto import comb
    from mochi_tpu_torch.crypto import cuda_comb as CC

    table, table15, tiled, pre_ok, want, clipped, m = comb_tiled
    part = [t[:n] for t in tiled]
    before = dict(CC.launches)
    got = CC.verify_comb_prepared(table, *part)
    assert CC.launches == dict(before, chain=before["chain"] + 1)
    assert torch.equal(got, comb.verify_comb_prepared(table15, *part))
    ok = (got.cpu().numpy() & pre_ok[:n]).tolist()
    kept = [j for j in range(n) if j % m not in clipped]
    assert [ok[j] for j in kept] == [want[j] for j in kept]


def test_comb_team_kernel_accepts_the_host_rejected_lanes_raw(card, comb_setup):
    """The two lanes the host rejects while the device accepts them (the
    host leaves h = 0, so the lane checks only [S]B == R): comb.cu's raw
    bitmap says True on both, as the plain chain's, alone and together; its
    attributes name a team of four lanes, 128 threads a block and static
    scratch only."""
    from mochi_tpu_torch.crypto import comb
    from mochi_tpu_torch.crypto import cuda_comb as CC

    reg, _, _ = comb_setup
    signer = cs.make_signers(np.random.default_rng(3), 1)[0]
    items = cs.host_rejected_items(signer)
    prepared = BV.prepare_packed(items)
    assert prepared[6].tolist() == [False, False]
    kidx = np.asarray([0, reg.index_of(signer.pub)], dtype=np.int32)
    lanes = CC.from_prepared(kidx, prepared, card)
    table = reg.device_table(card, layout="radix25")
    table15 = torch.from_numpy(reg.host_table()).to(card)
    for n in (1, 2):
        part = [t[:n] for t in lanes]
        got = CC.verify_comb_prepared(table, *part)
        assert got.tolist() == [True] * n
        assert torch.equal(got, comb.verify_comb_prepared(table15, *part))
    attrs = CC.kernel_attributes()
    assert attrs["team"] == 4 and attrs["threads"] == 128 and attrs["dynamic_shared_bytes"] == 0
    assert attrs["shared_bytes"] >= 32 * 181 * 4


def test_comb_wrapper_rejects_what_the_kernel_does_not_take(card, comb_setup):
    from mochi_tpu_torch.crypto import cuda_comb as CC

    reg, items, _ = comb_setup
    kidx = np.zeros(8, dtype=np.int32)
    lanes = list(CC.from_prepared(kidx, BV.prepare_packed(items[:8]), card))
    with pytest.raises(ValueError):  # the 17 x 15 table is the plain version's
        CC.verify_comb_prepared(torch.from_numpy(reg.host_table()).to(card), *lanes)
    bad = [t.clone() for t in lanes]
    bad[0] = bad[0].to(torch.int64)
    with pytest.raises(TypeError):
        CC.verify_comb_prepared(reg.device_table(card, layout="radix25"), *bad)
    assert CC.verify_comb_prepared(reg.device_table(card, layout="radix25"), *(t[:0] for t in lanes)).shape == (0,)


def test_routed_mixed_batch_on_the_card(card, comb_setup):
    from mochi_tpu_torch.crypto import keys

    reg, items, want = comb_setup
    stranger = keys.generate_keypair()
    extra = [VerifyItem(stranger.public_key, b"s%d" % i, stranger.sign(b"s%d" % i)) for i in range(5)]
    before = BV.comb_routing_counts()
    assert BV.verify_batch(items + extra, card, registry=reg) == want + [True] * 5
    after = BV.comb_routing_counts()
    assert after["comb_items"] - before["comb_items"] == len(items)
    assert after["ladder_items"] - before["ladder_items"] == 5


# ------------------------------------------------------------- comb tree


def test_comb_tree_kernel_equals_plain_tree_and_chain_kernel(card, comb_setup):
    """The tree kernel against the plain tree and the chain kernel on the
    comb corpus: 600 lanes (a partial last block of 24 signatures), indices
    past the table, and the expected verdicts; one kernel whose block is a
    whole number of warps, ``TREE_LANES`` lanes a signature."""
    from mochi_tpu_torch.crypto import comb
    from mochi_tpu_torch.crypto import cuda_comb as CC

    reg, items, want = comb_setup
    prepared = BV.prepare_packed(items)
    kidx = np.asarray([reg.index_of(it.public_key) for it in items], dtype=np.int32)
    kidx[5], kidx[9] = 10 ** 6, -4  # clipped into the table, never read past it
    table15 = torch.from_numpy(reg.host_table()).to(card)
    for n in (len(items), len(items) - 37, 1):
        lanes = [t[:n] for t in CC.from_prepared(kidx, prepared, card)]
        before = dict(CC.launches)
        got = CC.verify_comb_prepared(reg.device_table(card, layout="radix25"), *lanes, impl="tree")
        assert CC.launches == dict(before, tree=before["tree"] + 1)
        chain = CC.verify_comb_prepared(reg.device_table(card, layout="radix25"), *lanes, impl="chain")
        plain = comb.verify_comb_prepared(table15, *lanes, impl="tree")
        assert torch.equal(got, plain) and torch.equal(got, chain)
    ok = (got.cpu().numpy() & prepared[6][:1]).tolist()
    assert ok == want[:1]
    full = CC.verify_comb_prepared(reg.device_table(card, layout="radix25"), *CC.from_prepared(kidx, prepared, card), impl="tree")
    ok = (full.cpu().numpy() & prepared[6]).tolist()
    assert [w for j, w in enumerate(want) if j not in (5, 9)] == [o for j, o in enumerate(ok) if j not in (5, 9)]
    attrs = CC.kernel_attributes("tree")
    assert attrs["threads"] % 32 == 0 and attrs["team"] == CC.TREE_LANES and attrs["registers"] > 0


@pytest.mark.parametrize("n", [1, 3, 4, 5, 7, 8, 9, 23, 24, 25, 31, 32, 33, 47, 48, 49, 63, 64, 65, 127, 129,
                               2752])
def test_comb_tree_team_kernel_equals_plain_tree_at_team_warp_and_block_edges(card, comb_tiled, n):
    """comb_tree.cu (a decode warp beside ``TREE_LANES`` lanes a signature
    splitting its windows, ``TREE_SIGS`` signatures a block) at lane counts
    around a signature's lanes, a warp of them, a block and the decode
    warp's 32 lanes, and the service's 2,752,
    with clipped key indices: one launch counted as ``tree``, the plain
    tree's bitmap and comb.cu's lane for lane, the expected verdicts on
    every lane whose index is the signer's."""
    from mochi_tpu_torch.crypto import comb
    from mochi_tpu_torch.crypto import cuda_comb as CC

    table, table15, tiled, pre_ok, want, clipped, m = comb_tiled
    part = [t[:n] for t in tiled]
    chain = CC.verify_comb_prepared(table, *part, impl="chain")
    before = dict(CC.launches)
    got = CC.verify_comb_prepared(table, *part, impl="tree")
    assert CC.launches == dict(before, tree=before["tree"] + 1)
    assert torch.equal(got, comb.verify_comb_prepared(table15, *part, impl="tree")) and torch.equal(got, chain)
    ok = (got.cpu().numpy() & pre_ok[:n]).tolist()
    kept = [j for j in range(n) if j % m not in clipped]
    assert [ok[j] for j in kept] == [want[j] for j in kept]


def test_comb_tree_team_kernel_accepts_the_host_rejected_lanes_raw(card, comb_setup):
    """The two lanes the host rejects while the device accepts them (the
    host leaves h = 0, so the lane checks only [S]B == R): comb_tree.cu's
    raw bitmap says True on both, as the plain tree's, alone and together;
    its attributes name ``TREE_LANES`` lanes a signature, a block of one
    decode warp and ``TREE_SIGS`` signatures' summing lanes, and R's rows in
    static shared memory."""
    from mochi_tpu_torch.crypto import comb
    from mochi_tpu_torch.crypto import cuda_comb as CC

    reg, _, _ = comb_setup
    signer = cs.make_signers(np.random.default_rng(3), 1)[0]
    prepared = BV.prepare_packed(cs.host_rejected_items(signer))
    assert prepared[6].tolist() == [False, False]
    kidx = np.asarray([0, reg.index_of(signer.pub)], dtype=np.int32)
    lanes = CC.from_prepared(kidx, prepared, card)
    table = reg.device_table(card, layout="radix25")
    table15 = torch.from_numpy(reg.host_table()).to(card)
    before = CC.launches["tree"]
    for n in (1, 2):
        part = [t[:n] for t in lanes]
        got = CC.verify_comb_prepared(table, *part, impl="tree")
        assert got.tolist() == [True] * n
        assert torch.equal(got, comb.verify_comb_prepared(table15, *part, impl="tree"))
    assert CC.launches["tree"] == before + 2
    attrs = CC.kernel_attributes("tree")
    assert attrs["team"] == CC.TREE_LANES and attrs["threads"] == 32 + CC.TREE_SIGS * CC.TREE_LANES
    assert attrs["shared_bytes"] >= 32 * 21 * 4 and attrs["dynamic_shared_bytes"] == 0


def test_comb_tree_wrapper_rejects_what_the_kernel_does_not_take(card, comb_setup):
    from mochi_tpu_torch.crypto import cuda_comb as CC

    reg, items, _ = comb_setup
    kidx = np.zeros(8, dtype=np.int32)
    lanes = list(CC.from_prepared(kidx, BV.prepare_packed(items[:8]), card))
    table = reg.device_table(card, layout="radix25")
    with pytest.raises(ValueError):  # the 17 x 15 table is the plain version's
        CC.verify_comb_prepared(torch.from_numpy(reg.host_table()).to(card), *lanes, impl="tree")
    bad = [t.clone() for t in lanes]
    bad[0] = bad[0].to(torch.int64)
    with pytest.raises(TypeError):
        CC.verify_comb_prepared(table, *bad, impl="tree")
    bad = [t.clone() for t in lanes]
    bad[1] = bad[1][:4]
    with pytest.raises(ValueError):
        CC.verify_comb_prepared(table, *bad, impl="tree")
    bad = [t.clone() for t in lanes]
    bad[3] = bad[3].cpu()
    with pytest.raises(ValueError):
        CC.verify_comb_prepared(table, *bad, impl="tree")
    # a name other than the two runs the chain, as the reference does
    before = dict(CC.launches)
    assert torch.equal(CC.verify_comb_prepared(table, *lanes, impl="mxu"),
                       CC.verify_comb_prepared(table, *lanes, impl="chain"))
    assert CC.launches == dict(before, chain=before["chain"] + 2)
    assert CC.verify_comb_prepared(table, *(t[:0] for t in lanes), impl="tree").shape == (0,)


def test_verifier_with_signers_under_the_tree_switch(card, comb_setup, monkeypatch):
    """``CudaBatchVerifier(signers=...)`` with ``COMB_IMPL`` at the tree:
    every item takes the tree kernel, none the chain, verdicts as expected."""
    import asyncio

    from mochi_tpu_torch.crypto import comb
    from mochi_tpu_torch.crypto import cuda_comb as CC
    from mochi_tpu_torch.verifier.cuda import CudaBatchVerifier
    from mochi_tpu_torch.verifier.spi import verifier_stats

    reg, items, want = comb_setup
    monkeypatch.setattr(comb, "COMB_IMPL", "tree")

    async def main():
        v = CudaBatchVerifier(device=card, signers=reg.public_keys())
        try:
            before = (CC.launches["chain"], CC.launches["tree"], BV.comb_routing_counts()["comb_items"])
            got = await v.verify_batch(items)
            after = (CC.launches["chain"], CC.launches["tree"], BV.comb_routing_counts()["comb_items"])
            return got, before, after, verifier_stats(v)["comb"]["impl"]
        finally:
            await v.close()

    got, before, after, impl = asyncio.run(asyncio.wait_for(main(), 300))
    assert got == want and impl == "tree"
    assert after[0] == before[0] and after[1] > before[1] and after[2] - before[2] == len(items)


def test_service_cli_serves_a_certificate_on_the_tree(card, tmp_path):
    """``python -m mochi_tpu_torch.verifier.service`` started with
    ``MOCHI_COMB_IMPL=tree``: its log line names the tree, and a 43-grant
    certificate of its known signers comes back over RPC as expected."""
    import asyncio
    import os
    import subprocess
    import sys

    from mochi_tpu_torch.verifier.service import RemoteVerifier

    signers = cs.make_signers(np.random.default_rng(5), 43)
    traffic = cs.make_traffic(6, signers, clients=1, requests=1, grants=43, forge_rate=0.1)
    items, want = traffic[0][0]
    (tmp_path / "signers.txt").write_text("".join(s.pub.hex() + "\n" for s in signers))
    proc = subprocess.Popen(
        [sys.executable, "-m", "mochi_tpu_torch.verifier.service", "--port", "0",
         "--signers-file", str(tmp_path / "signers.txt")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=dict(os.environ, MOCHI_COMB_IMPL="tree"),
    )

    async def ask(port):
        rv = RemoteVerifier("127.0.0.1", port, timeout_s=120)
        try:
            return await rv.verify_batch(items), rv.fallback_batches
        finally:
            await rv.close()

    try:
        line = proc.stdout.readline()
        assert line.startswith("READY verifier-service "), line
        assert asyncio.run(ask(int(line.split()[-1]))) == (want, 0)
    finally:
        proc.terminate()
        _, err = proc.communicate(timeout=60)
    assert "43 known signers on the comb kernel, tree accumulation" in err, err
    assert 0 < sum(want) < 43


# ------------------------------------------------ comb chain under mxu


def test_comb_mxu_kernel_equals_plain_chain_under_mxu_and_comb_cu(card, comb_setup, monkeypatch):
    """The chain under ``mxu`` (``comb_mxu.cu``) on the registry's 17 x 15
    rows against the plain chain under ``mxu`` and ``comb.cu``'s bitmap:
    600 lanes, a partial last block, one lane past a warp and one lane,
    indices past both ends of the table, and the expected verdicts; the
    kernel runs teams of four lanes, 64 threads a block, no dynamic shared
    memory."""
    from mochi_tpu_torch.crypto import comb
    from mochi_tpu_torch.crypto import cuda_comb as CC
    from mochi_tpu_torch.crypto import field as F

    reg, items, want = comb_setup
    prepared = BV.prepare_packed(items)
    kidx = np.asarray([reg.index_of(it.public_key) for it in items], dtype=np.int32)
    kidx[5], kidx[9] = 10 ** 6, -4  # clipped into the table, never read past it
    table17 = reg.device_table(card, layout="fe17")
    assert torch.equal(table17.cpu(), torch.from_numpy(reg.host_table()))
    lanes = CC.from_prepared(kidx, prepared, card)
    pad = CC.verify_comb_prepared(reg.device_table(card, layout="radix25"), *lanes, multiply="pad")
    monkeypatch.setattr(F, "SKEW_IMPL", "mxu")
    before = dict(CC.launches)
    for n in (len(items), len(items) - 37, 33, 1):
        part = [t[:n] for t in lanes]
        got = CC.verify_comb_prepared(table17, *part)
        plain = comb.verify_comb_prepared(table17, *part)
        assert torch.equal(got, plain) and torch.equal(got, pad[:n])
    assert CC.launches == dict(before, chain_mxu=before["chain_mxu"] + 4)
    full = CC.verify_comb_prepared(table17, *lanes, impl="chain", multiply="mxu")
    ok = (full.cpu().numpy() & prepared[6]).tolist()
    assert [w for j, w in enumerate(want) if j not in (5, 9)] == [o for j, o in enumerate(ok) if j not in (5, 9)]
    attrs = CC.kernel_attributes("chain_mxu")
    assert attrs["threads"] == 64 and attrs["registers"] > 0
    assert attrs["team"] == 4 and attrs["dynamic_shared_bytes"] == 0 and attrs["local_bytes"] >= 0


@pytest.mark.parametrize("n", [1, 7, 8, 9, 15, 16, 17, 63, 64, 65, 2752])
def test_comb_mxu_team_kernel_equals_plain_chain_at_team_warp_and_block_edges(card, comb_tiled, monkeypatch, n):
    """comb_mxu.cu (a team of four lanes a signature, 8 signatures a warp,
    16 a block of 64 threads) at lane counts around a warp and a block and
    the service's 2,752, with clipped key indices: one launch counted as
    ``chain_mxu``, the plain chain's bitmap under ``mxu`` and comb.cu's lane
    for lane, the expected verdicts on every lane whose index is the
    signer's."""
    from mochi_tpu_torch.crypto import comb
    from mochi_tpu_torch.crypto import cuda_comb as CC
    from mochi_tpu_torch.crypto import field as F

    table, table15, tiled, pre_ok, want, clipped, m = comb_tiled
    part = [t[:n] for t in tiled]
    pad = CC.verify_comb_prepared(table, *part, multiply="pad")
    monkeypatch.setattr(F, "SKEW_IMPL", "mxu")
    before = dict(CC.launches)
    got = CC.verify_comb_prepared(table15, *part)
    assert CC.launches == dict(before, chain_mxu=before["chain_mxu"] + 1)
    assert torch.equal(got, comb.verify_comb_prepared(table15, *part)) and torch.equal(got, pad)
    ok = (got.cpu().numpy() & pre_ok[:n]).tolist()
    kept = [j for j in range(n) if j % m not in clipped]
    assert [ok[j] for j in kept] == [want[j] for j in kept]


def test_comb_mxu_team_kernel_accepts_the_host_rejected_lanes_raw(card, comb_setup, monkeypatch):
    """The two lanes the host rejects while the device accepts them
    (ROADMAP Queue C): comb_mxu.cu's raw bitmap says True on both, as the
    plain chain's under ``mxu``, alone and together."""
    from mochi_tpu_torch.crypto import comb
    from mochi_tpu_torch.crypto import cuda_comb as CC
    from mochi_tpu_torch.crypto import field as F

    reg, _, _ = comb_setup
    signer = cs.make_signers(np.random.default_rng(3), 1)[0]
    prepared = BV.prepare_packed(cs.host_rejected_items(signer))
    assert prepared[6].tolist() == [False, False]
    kidx = np.asarray([0, reg.index_of(signer.pub)], dtype=np.int32)
    lanes = CC.from_prepared(kidx, prepared, card)
    table17 = reg.device_table(card, layout="fe17")
    monkeypatch.setattr(F, "SKEW_IMPL", "mxu")
    before = CC.launches["chain_mxu"]
    for n in (1, 2):
        part = [t[:n] for t in lanes]
        got = CC.verify_comb_prepared(table17, *part)
        assert got.tolist() == [True] * n
        assert torch.equal(got, comb.verify_comb_prepared(table17, *part))
    assert CC.launches["chain_mxu"] == before + 2


def test_comb_wrappers_refuse_the_other_layout(card, comb_setup):
    """``comb_mxu.cu``'s and ``comb_tree_mxu.cu``'s wrappers refuse a
    kernel-radix table and ``comb.cu``'s and ``comb_tree.cu``'s refuse the
    17 x 15 rows; lanes of the wrong type or device are refused too."""
    from mochi_tpu_torch.crypto import cuda_comb as CC

    reg, items, _ = comb_setup
    lanes = list(CC.from_prepared(np.zeros(8, dtype=np.int32), BV.prepare_packed(items[:8]), card))
    t25, t17 = reg.device_table(card, layout="radix25"), reg.device_table(card, layout="fe17")
    with pytest.raises(ValueError, match="fe17 layout"):
        CC.verify_comb_prepared(t25, *lanes, multiply="mxu")
    for impl in ("chain", "tree"):
        with pytest.raises(ValueError, match="radix25 layout"):
            CC.verify_comb_prepared(t17, *lanes, impl=impl, multiply="pad")
    with pytest.raises(ValueError, match="fe17 layout"):  # the tree under mxu reads the 17 x 15 rows
        CC.verify_comb_prepared(t25, *lanes, impl="tree", multiply="mxu")
    bad = [t.clone() for t in lanes]
    bad[0] = bad[0].to(torch.int64)
    with pytest.raises(TypeError):
        CC.verify_comb_prepared(t17, *bad, multiply="mxu")
    bad = [t.clone() for t in lanes]
    bad[2] = bad[2].cpu()
    with pytest.raises(ValueError):
        CC.verify_comb_prepared(t17, *bad, multiply="mxu")
    assert CC.verify_comb_prepared(t17, *(t[:0] for t in lanes), multiply="mxu").shape == (0,)


def test_verifier_with_signers_under_the_mxu_switch(card, comb_setup, monkeypatch):
    """``CudaBatchVerifier(signers=...)`` under ``MOCHI_SKEW_IMPL=mxu``: every
    item takes the chain under mxu against the 17 x 15 table, none
    ``comb.cu`` or a general kernel, verdicts as expected, and the stats
    name the mxu multiply."""
    import asyncio

    from mochi_tpu_torch.crypto import cuda_comb as CC
    from mochi_tpu_torch.crypto import field as F
    from mochi_tpu_torch.verifier.cuda import CudaBatchVerifier
    from mochi_tpu_torch.verifier.spi import verifier_stats

    reg, items, want = comb_setup
    monkeypatch.setattr(F, "SKEW_IMPL", "mxu")

    async def main():
        v = CudaBatchVerifier(device=card, signers=reg.public_keys())
        try:
            before = (dict(CC.launches), dict(CV.launches), BV.comb_routing_counts()["comb_items"])
            got = await v.verify_batch(items)
            after = (dict(CC.launches), dict(CV.launches), BV.comb_routing_counts()["comb_items"])
            return got, before, after, verifier_stats(v)["comb"]["multiply"]
        finally:
            await v.close()

    got, before, after, multiply = asyncio.run(asyncio.wait_for(main(), 300))
    assert got == want and multiply == "mxu"
    assert after[0]["chain_mxu"] > before[0]["chain_mxu"]
    assert dict(after[0], chain_mxu=0) == dict(before[0], chain_mxu=0) and after[1] == before[1]
    assert after[2] - before[2] == len(items)


def test_sharded_backend_on_two_slices_under_the_mxu_switch(card, comb_setup, monkeypatch):
    """The sharded backend on two slices of the card under ``mxu``: both
    slices launch the chain under mxu against the 17 x 15 table the warm-up
    uploaded, verdicts as expected; a batch with one unregistered key runs
    the mxu general kernel whole."""
    from mochi_tpu_torch.crypto import cuda_comb as CC
    from mochi_tpu_torch.crypto import field as F
    from mochi_tpu_torch.crypto import keys
    from mochi_tpu_torch.parallel import make_mesh
    from mochi_tpu_torch.verifier.cuda import ShardedCudaBatchBackend

    reg, items, want = comb_setup
    monkeypatch.setattr(F, "SKEW_IMPL", "mxu")
    backend = ShardedCudaBatchBackend(make_mesh(devices=[card, card]), min_device_items=0)
    backend.register_signers(reg.public_keys())
    backend.warmup()
    table17 = backend.registry.device_table(card, layout="fe17")
    before = (dict(CC.launches), dict(CV.launches))
    assert backend(items) == want
    assert backend.registry.device_table(card, layout="fe17") is table17
    stranger = keys.generate_keypair()
    extra = [VerifyItem(stranger.public_key, b"x", stranger.sign(b"x"))]
    assert backend(items[:7] + extra) == want[:7] + [True]
    after = (dict(CC.launches), dict(CV.launches))
    assert after[0] == dict(before[0], chain_mxu=before[0]["chain_mxu"] + 2)
    assert after[1] == dict(before[1], mxu=before[1]["mxu"] + 2)


# ------------------------------------------------- comb tree under mxu


def test_comb_tree_mxu_kernel_equals_plain_tree_under_mxu_and_comb_mxu_cu(card, comb_setup, monkeypatch):
    """``comb_tree_mxu.cu`` against the plain tree under ``mxu`` and the chain
    under ``mxu`` (``comb_mxu.cu``) on the comb corpus: 600 lanes, a partial
    last block of both passes (16 signatures a block of the prepare pass, 2
    or 4 of the accumulate pass), one lane, indices past the table, and the
    expected verdicts; both passes run 64-thread blocks on the team
    multiply, with no shared memory: a team of four lanes a signature in the
    prepare pass, ``TREE_MXU_TEAMS`` teams in the accumulate pass."""
    from mochi_tpu_torch.crypto import comb
    from mochi_tpu_torch.crypto import cuda_comb as CC
    from mochi_tpu_torch.crypto import field as F

    reg, items, want = comb_setup
    prepared = BV.prepare_packed(items)
    kidx = np.asarray([reg.index_of(it.public_key) for it in items], dtype=np.int32)
    kidx[5], kidx[9] = 10 ** 6, -4  # clipped into the table, never read past it
    table17 = reg.device_table(card, layout="fe17")
    lanes = CC.from_prepared(kidx, prepared, card)
    monkeypatch.setattr(F, "SKEW_IMPL", "mxu")
    before = dict(CC.launches)
    for n in (len(items), len(items) - 37, 33, 1):
        part = [t[:n] for t in lanes]
        got = CC.verify_comb_prepared(table17, *part, impl="tree")
        plain = comb.verify_comb_prepared(table17, *part, impl="tree", multiply="mxu")
        chain = CC.verify_comb_prepared(table17, *part, impl="chain")
        assert torch.equal(got, plain) and torch.equal(got, chain)
    assert CC.launches == dict(before, tree_mxu=before["tree_mxu"] + 4, chain_mxu=before["chain_mxu"] + 4)
    full = CC.verify_comb_prepared(table17, *lanes, impl="tree", multiply="mxu")
    ok = (full.cpu().numpy() & prepared[6]).tolist()
    assert [w for j, w in enumerate(want) if j not in (5, 9)] == [o for j, o in enumerate(ok) if j not in (5, 9)]
    attrs = CC.kernel_attributes("tree_mxu")
    assert attrs["prepare"]["threads"] == attrs["accumulate"]["threads"] == 64
    assert attrs["prepare"]["team"] == 4 and attrs["accumulate"]["team"] == 4 * CC.TREE_MXU_TEAMS
    assert attrs["accumulate"]["registers"] > 0
    for pas in attrs.values():
        assert pas["shared_bytes"] == 0 and pas["dynamic_shared_bytes"] == 0


@pytest.mark.parametrize("n", [1, 7, 8, 9, 31, 32, 33, 63, 64, 65, 127, 129, 2752])
def test_comb_tree_mxu_team_kernel_equals_plain_tree_at_team_warp_and_block_edges(card, comb_tiled, monkeypatch, n):
    """comb_tree_mxu.cu (the prepare pass a team of four lanes a signature,
    16 a block of 64 threads; the accumulate pass ``TREE_MXU_TEAMS`` teams
    splitting one signature's windows, 4 signatures a block) at lane counts
    around a team, a warp and a block of either pass and the service's 2,752, with
    clipped key indices: one launch counted as ``tree_mxu``, the plain
    tree's bitmap under ``mxu`` and comb_mxu.cu's lane for lane, the
    expected verdicts on every lane whose index is the signer's."""
    from mochi_tpu_torch.crypto import comb
    from mochi_tpu_torch.crypto import cuda_comb as CC
    from mochi_tpu_torch.crypto import field as F

    _, table15, tiled, pre_ok, want, clipped, m = comb_tiled
    part = [t[:n] for t in tiled]
    monkeypatch.setattr(F, "SKEW_IMPL", "mxu")
    chain = CC.verify_comb_prepared(table15, *part, impl="chain")
    before = dict(CC.launches)
    got = CC.verify_comb_prepared(table15, *part, impl="tree")
    assert CC.launches == dict(before, tree_mxu=before["tree_mxu"] + 1)
    assert torch.equal(got, comb.verify_comb_prepared(table15, *part, impl="tree")) and torch.equal(got, chain)
    ok = (got.cpu().numpy() & pre_ok[:n]).tolist()
    kept = [j for j in range(n) if j % m not in clipped]
    assert [ok[j] for j in kept] == [want[j] for j in kept]


def test_comb_tree_mxu_team_kernel_accepts_the_host_rejected_lanes_raw(card, comb_setup, monkeypatch):
    """The two lanes the host rejects while the device accepts them
    (ROADMAP Queue C): comb_tree_mxu.cu's raw bitmap says True on both, as
    the plain tree's under ``mxu``, alone and together."""
    from mochi_tpu_torch.crypto import comb
    from mochi_tpu_torch.crypto import cuda_comb as CC
    from mochi_tpu_torch.crypto import field as F

    reg, _, _ = comb_setup
    signer = cs.make_signers(np.random.default_rng(3), 1)[0]
    prepared = BV.prepare_packed(cs.host_rejected_items(signer))
    assert prepared[6].tolist() == [False, False]
    kidx = np.asarray([0, reg.index_of(signer.pub)], dtype=np.int32)
    lanes = CC.from_prepared(kidx, prepared, card)
    table17 = reg.device_table(card, layout="fe17")
    monkeypatch.setattr(F, "SKEW_IMPL", "mxu")
    before = CC.launches["tree_mxu"]
    for n in (1, 2):
        part = [t[:n] for t in lanes]
        got = CC.verify_comb_prepared(table17, *part, impl="tree")
        assert got.tolist() == [True] * n
        assert torch.equal(got, comb.verify_comb_prepared(table17, *part, impl="tree"))
    assert CC.launches["tree_mxu"] == before + 2


def test_verifier_with_signers_under_both_switches(card, comb_setup, monkeypatch):
    """``CudaBatchVerifier(signers=...)`` under ``MOCHI_COMB_IMPL=tree`` and
    ``MOCHI_SKEW_IMPL=mxu``: every item takes the tree under mxu against the
    17 x 15 table, no other comb kernel and no general kernel, verdicts as
    expected, and the stats name the tree and the mxu multiply."""
    import asyncio

    from mochi_tpu_torch.crypto import comb
    from mochi_tpu_torch.crypto import cuda_comb as CC
    from mochi_tpu_torch.crypto import field as F
    from mochi_tpu_torch.verifier.cuda import CudaBatchVerifier
    from mochi_tpu_torch.verifier.spi import verifier_stats

    reg, items, want = comb_setup
    monkeypatch.setattr(comb, "COMB_IMPL", "tree")
    monkeypatch.setattr(F, "SKEW_IMPL", "mxu")

    async def main():
        v = CudaBatchVerifier(device=card, signers=reg.public_keys())
        try:
            before = (dict(CC.launches), dict(CV.launches), BV.comb_routing_counts()["comb_items"])
            got = await v.verify_batch(items)
            after = (dict(CC.launches), dict(CV.launches), BV.comb_routing_counts()["comb_items"])
            st = verifier_stats(v)["comb"]
            return got, before, after, (st["impl"], st["multiply"])
        finally:
            await v.close()

    got, before, after, stats = asyncio.run(asyncio.wait_for(main(), 300))
    assert got == want and stats == ("tree", "mxu")
    assert after[0]["tree_mxu"] > before[0]["tree_mxu"]
    assert dict(after[0], tree_mxu=0) == dict(before[0], tree_mxu=0) and after[1] == before[1]
    assert after[2] - before[2] == len(items)


# --------------------------------------------- the mxu general kernel


def test_fe_mul_mxu_equals_the_plain_multiply_at_the_limb_maximum(card):
    from mochi_tpu_torch.crypto import field as F

    rng = np.random.default_rng(11)
    n = 4099  # a partial last block and a partial warp
    a = rng.integers(0, F.LOOSE + 1, (F.NLIMBS, n)).astype(np.int32)
    b = rng.integers(0, F.LOOSE + 1, (F.NLIMBS, n)).astype(np.int32)
    a[:, :40] = F.LOOSE
    b[:, 20:60] = F.LOOSE
    a[:, 60] = 0
    at, bt = torch.from_numpy(a).to(card), torch.from_numpy(b).to(card)
    before = CV.mul_launches
    got = CV.fe_mul_mxu(at, bt)
    assert CV.mul_launches == before + 1 and got.dtype == torch.int32
    plain = F._mul_mxu(at.to(F.DTYPE), bt.to(F.DTYPE))
    assert torch.equal(got.to(F.DTYPE), plain)
    assert torch.equal(plain.cpu(), F.mul(torch.from_numpy(a).to(F.DTYPE), torch.from_numpy(b).to(F.DTYPE)))


def test_mxu_kernel_equals_its_plain_version_verify_cu_and_the_verdicts(card, corpus, monkeypatch):
    from mochi_tpu_torch.crypto import field as F

    items, want, _ = corpus
    prepared = BV.prepare_packed(items)
    tens = CV.from_reference_prepared(prepared, card)
    pad = CV.verify_prepared_packed(*tens)
    monkeypatch.setattr(F, "SKEW_IMPL", "mxu")
    before = dict(CV.launches)
    for n in (len(items), len(items) - 37, 33):  # full blocks, a partial block, one lane past a warp
        got = CV.verify_prepared_packed(*(t[:n] for t in tens))
        plain = curve.verify_prepared_packed(*(t[:n] for t in tens))
        assert torch.equal(got, plain) and torch.equal(got, pad[:n])
        assert (got.cpu().numpy() & prepared[6][:n]).tolist() == want[:n]
    assert CV.launches == {"pad": before["pad"], "mxu": before["mxu"] + 3}
    attrs = CV.kernel_attributes("mxu")
    assert attrs["verify"]["threads"] % 32 == 0 and attrs["mul"]["registers"] > 0


@pytest.mark.parametrize("n", [1, 7, 8, 9, 15, 16, 17, 63, 64, 65, 2752])
def test_mxu_team_kernel_equals_plain_version_at_team_warp_and_block_edges(card, tiled, monkeypatch, n):
    """verify_mxu.cu (a team of four lanes a signature, 8 signatures a warp,
    16 a block of 64 threads) at lane counts around a warp and a block and
    the service's 2,752: one launch, the plain version's bitmap under
    ``mxu`` and verify.cu's lane for lane, the expected verdicts."""
    from mochi_tpu_torch.crypto import field as F

    tens, pre_ok, want = tiled
    part = [t[:n] for t in tens]
    pad = CV.verify_prepared_packed(*part)
    monkeypatch.setattr(F, "SKEW_IMPL", "mxu")
    before = dict(CV.launches)
    got = CV.verify_prepared_packed(*part)
    assert CV.launches == dict(before, mxu=before["mxu"] + 1)
    assert torch.equal(got, curve.verify_prepared_packed(*part)) and torch.equal(got, pad)
    assert (got.cpu().numpy() & pre_ok[:n]).tolist() == want[:n]


def test_mxu_team_kernel_accepts_the_host_rejected_lanes_raw(card, monkeypatch):
    """The two lanes the host rejects while the device accepts them
    (ROADMAP Queue C): the mxu kernel's raw bitmap says True on both, as
    the plain version's under ``mxu``, alone and together; the kernel runs
    teams of four lanes, 64 threads a block, a 2,448-byte table a team in
    dynamic shared memory."""
    from mochi_tpu_torch.crypto import field as F

    signer = cs.make_signers(np.random.default_rng(3), 1)[0]
    prepared = BV.prepare_packed(cs.host_rejected_items(signer))
    assert prepared[6].tolist() == [False, False]
    tens = CV.from_reference_prepared(prepared, card)
    monkeypatch.setattr(F, "SKEW_IMPL", "mxu")
    for n in (1, 2):
        got = CV.verify_prepared_packed(*(t[:n] for t in tens))
        assert got.tolist() == [True] * n
        assert torch.equal(got, curve.verify_prepared_packed(*(t[:n] for t in tens)))
    attrs = CV.kernel_attributes("mxu")
    assert attrs["verify"]["team"] == 4 and attrs["verify"]["threads"] == 64
    assert attrs["verify"]["dynamic_shared_bytes"] == 16 * 9 * 4 * 17 * 4


def test_mxu_wrappers_reject_what_the_kernels_do_not_take(card, corpus, monkeypatch):
    from mochi_tpu_torch.crypto import field as F

    monkeypatch.setattr(F, "SKEW_IMPL", "mxu")
    tens = list(CV.from_reference_prepared(BV.prepare_packed(corpus[0][:8]), card))
    bad = [t.clone() for t in tens]
    bad[2] = bad[2].to(torch.int64)
    with pytest.raises(TypeError):
        CV.verify_prepared_packed(*bad)
    bad = [t.clone() for t in tens]
    bad[5] = tens[5].t().contiguous().t()
    with pytest.raises(ValueError):
        CV.verify_prepared_packed(*bad)
    bad = [t.clone() for t in tens]
    bad[3] = bad[3].cpu()
    with pytest.raises(ValueError):
        CV.verify_prepared_packed(*bad)
    assert CV.verify_prepared_packed(*(t[:0] for t in tens)).shape == (0,)
    x = torch.zeros((F.NLIMBS, 8), dtype=torch.int32, device=card)
    with pytest.raises(TypeError):
        CV.fe_mul_mxu(x, x.to(torch.int64))
    with pytest.raises(ValueError):
        CV.fe_mul_mxu(x, x[:, :4])
    with pytest.raises(ValueError):
        CV.fe_mul_mxu(x, x.t().contiguous().t())
    with pytest.raises(ValueError):
        CV.fe_mul_mxu(x, x.cpu())
    assert CV.fe_mul_mxu(x[:, :0].contiguous(), x[:, :0].contiguous()).shape == (F.NLIMBS, 0)


def test_service_cli_serves_a_certificate_on_the_mxu_kernel(card, tmp_path):
    """``python -m mochi_tpu_torch.verifier.service`` started with
    ``MOCHI_SKEW_IMPL=mxu`` and no signers: its log line names the mxu
    multiply, and a 43-grant certificate comes back over RPC as expected."""
    import asyncio
    import os
    import subprocess
    import sys

    from mochi_tpu_torch.verifier.service import RemoteVerifier

    signers = cs.make_signers(np.random.default_rng(7), 43)
    traffic = cs.make_traffic(8, signers, clients=1, requests=1, grants=43, forge_rate=0.1)
    items, want = traffic[0][0]
    proc = subprocess.Popen(
        [sys.executable, "-m", "mochi_tpu_torch.verifier.service", "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=dict(os.environ, MOCHI_SKEW_IMPL="mxu"),
    )

    async def ask(port):
        rv = RemoteVerifier("127.0.0.1", port, timeout_s=120)
        try:
            return await rv.verify_batch(items), rv.fallback_batches
        finally:
            await rv.close()

    try:
        line = proc.stdout.readline()
        assert line.startswith("READY verifier-service "), line
        assert asyncio.run(ask(int(line.split()[-1]))) == (want, 0)
    finally:
        proc.terminate()
        _, err = proc.communicate(timeout=60)
    assert "general kernel: mxu multiply; 0 known signers" in err, err
    assert 0 < sum(want) < 43


# ------------------------------------------------ quorum tally and sharding


def _tally_lanes(card, n, g, kind):
    """bitmap, pre_ok and group_ids on the card for one tally case: "wild"
    ids that wrap and drop, "runs of 43" (the certificate stream's sorted
    grants), "one slot" (every lane votes for slot 0), or "offset k" (wild
    ids in views that start k elements into their storage)."""
    rng = np.random.default_rng(n + g)
    bitmap = rng.random(n) < 0.8
    ok = rng.random(n) < 0.9
    if kind == "runs of 43":
        ids = np.minimum(np.arange(n) // 43, g - 1)
    elif kind == "one slot":
        bitmap, ok, ids = np.ones(n, bool), np.ones(n, bool), np.zeros(n)
    else:
        ids = rng.integers(-2 * g - 1, 2 * g + 2, n)
    arrays = (bitmap, ok, ids.astype(np.int32))
    if not kind.startswith("offset"):
        return tuple(torch.from_numpy(a).to(card) for a in arrays)
    k = int(kind.split()[1])
    views = tuple(torch.from_numpy(np.concatenate([a[:1].repeat(k), a])).to(card)[k:] for a in arrays)
    assert all(v.storage_offset() == k and v.is_contiguous() for v in views)
    return views


# lane counts around the warp's 256 lanes and the block's 1,024, the
# certificate stream's shape, every lane in one slot, views at offsets 1-3
TALLY_CASES = [(0, 4, "wild"), (1, 1, "wild"), (1000, 37, "wild"), (5000, 0, "wild"), (66048, 1537, "wild"),
               (31, 3, "wild"), (32, 3, "wild"), (33, 3, "wild"), (255, 7, "wild"), (256, 7, "wild"),
               (257, 7, "wild"), (1023, 9, "wild"), (1024, 9, "wild"), (1025, 9, "wild"), (2049, 17, "wild"),
               (66048, 1537, "runs of 43"), (66047, 1537, "runs of 43"), (66048, 1537, "one slot"),
               (5000, 37, "offset 1"), (5000, 37, "offset 2"), (5001, 37, "offset 3")]


@pytest.mark.parametrize("n,g,kind", TALLY_CASES)
def test_tally_kernel_equals_plain_version_on_wrapping_and_dropped_ids(card, n, g, kind):
    from mochi_tpu_torch.parallel import cuda_tally as CT
    from mochi_tpu_torch.parallel import sharded as S

    bitmap, ok, ids = _tally_lanes(card, n, g, kind)
    before = (CT.launches, CT.fused_launches, CT.commit_launches)
    got = CT.quorum_tally(bitmap, ok, ids, g)
    committed = CT.quorum_commit(got, 3)
    assert (CT.launches, CT.fused_launches, CT.commit_launches) == (before[0] + 1, before[1], before[2] + 1)
    assert got.dtype == torch.int32 and got.device == card
    assert torch.equal(got, S.segment_tally(bitmap, ok, ids, g))
    assert torch.equal(committed, S.commit(got, 3))


@pytest.mark.parametrize("n,g,kind", [(0, 5, "wild"), (0, 0, "wild"), (1, 1, "wild"), (257, 7, "wild"),
                                      (1025, 9, "wild"), (66048, 1537, "runs of 43"),
                                      (66048, 1537, "one slot"), (5000, 37, "offset 1")])
def test_fused_tally_commit_kernel_equals_plain_version(card, n, g, kind):
    """The fused tally-and-commit at thresholds 0, 1, 43 and 44: one launch
    (counted as a tally and as a fused launch, not as a commit), counts and
    commits equal to the plain versions, also when a CUDA graph replays it
    (the ticket is zeroed with the slots on every call)."""
    from mochi_tpu_torch.parallel import cuda_tally as CT
    from mochi_tpu_torch.parallel import sharded as S

    bitmap, ok, ids = _tally_lanes(card, n, g, kind)
    plain = S.segment_tally(bitmap, ok, ids, g)
    for threshold in (0, 1, 43, 44):
        before = (CT.launches, CT.fused_launches, CT.commit_launches)
        counts, committed = CT.quorum_tally_commit(bitmap, ok, ids, g, threshold)
        assert (CT.launches, CT.fused_launches, CT.commit_launches) == (before[0] + 1, before[1] + 1, before[2])
        assert counts.dtype == torch.int32 and committed.dtype == torch.bool and counts.shape == (g,)
        assert torch.equal(counts, plain) and torch.equal(committed, S.commit(plain, threshold))
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        counts, committed = CT.quorum_tally_commit(bitmap, ok, ids, g, 43)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(counts, plain) and torch.equal(committed, S.commit(plain, 43))


def test_tally_wrapper_rejects_what_the_kernel_does_not_take(card):
    from mochi_tpu_torch.parallel import cuda_tally as CT

    b = torch.ones(8, dtype=torch.bool, device=card)
    ids = torch.zeros(8, dtype=torch.int32, device=card)
    with pytest.raises(TypeError):
        CT.quorum_tally(b, b, ids.to(torch.int64), 2)
    with pytest.raises(ValueError):
        CT.quorum_tally(b, b[:4], ids, 2)
    with pytest.raises(ValueError):
        CT.quorum_tally(b, b, ids, -1)
    with pytest.raises(TypeError):
        CT.quorum_commit(torch.zeros(3, dtype=torch.int64, device=card), 1)


def test_quorum_step_on_the_card_equals_the_plain_step(card, corpus):
    from mochi_tpu_torch.crypto import cuda_comb as CC
    from mochi_tpu_torch.parallel import cuda_tally as CT
    from mochi_tpu_torch.parallel import make_mesh, make_quorum_step

    items, want, _ = corpus
    n, g = 600, 23
    prepared = BV.prepare_packed(items[:n])
    ids = np.random.default_rng(9).integers(-g, g + 3, n).astype(np.int32)
    plain = make_quorum_step(make_mesh(devices=["cpu"] * 2), g)(*prepared, ids, 4)
    assert plain[0].tolist() == want[:n]
    for devices in ([card, card], None):
        mesh = make_mesh(devices=devices)
        # a one-slice mesh (the default mesh of a one-card machine) takes
        # the fused tally-and-commit: one launch, no commit launch
        fused = mesh.size == 1 and mesh.group is None
        before = (CV.launches["pad"], CT.launches, CT.fused_launches, CT.commit_launches, dict(CC.launches))
        got = make_quorum_step(mesh, g)(*prepared, ids, 4)
        after = (CV.launches["pad"], CT.launches, CT.fused_launches, CT.commit_launches, dict(CC.launches))
        assert after == (before[0] + mesh.size, before[1] + mesh.size, before[2] + fused,
                         before[3] + (not fused), before[4])
        for a, b in zip(got, plain):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_cut_quorum_step_on_the_card_equals_the_plain_step(card, corpus, monkeypatch):
    """A one-slice step of 2 x MAX_LAUNCH + 64 lanes is launched in two
    parts into one bitmap: at the real MAX_LAUNCH (the corpus tiled, its
    forged and non-canonical lanes included) against the same step uncut,
    the expected verdicts and the plain tally; with MAX_LAUNCH patched to
    256 (576 lanes) against the plain CPU step."""
    from mochi_tpu_torch.parallel import make_mesh, make_quorum_step
    from mochi_tpu_torch.parallel import sharded as S

    items, want, _ = corpus
    g, threshold = 23, 4
    step = make_quorum_step(make_mesh([card]), g)
    for launch in (BV.MAX_LAUNCH, 256):
        monkeypatch.setattr(BV, "MAX_LAUNCH", launch)
        n = 2 * launch + 64
        reps = -(-n // len(items))
        prepared = BV.prepare_packed((items * reps)[:n])
        ids = np.random.default_rng(n).integers(-g, g + 3, n).astype(np.int32)
        before = (BV.device_dispatch_count(), CV.launches["pad"])
        got = step(*prepared, ids, threshold)
        assert (BV.device_dispatch_count(), CV.launches["pad"]) == (before[0] + 2, before[1] + 2)
        if launch == 256:
            plain = make_quorum_step(make_mesh(devices=["cpu"] * 2), g)(*prepared, ids, threshold)
        else:
            verdicts = torch.tensor((want * reps)[:n])
            counts = S.segment_tally(verdicts, torch.ones(n, dtype=torch.bool), torch.from_numpy(ids), g)
            plain = (verdicts, counts, S.commit(counts, threshold))
            monkeypatch.setattr(BV, "MAX_LAUNCH", n)
            uncut = step(*prepared, ids, threshold)
            assert BV.device_dispatch_count() == before[0] + 3
            for a, b in zip(got, uncut):
                assert a.dtype == b.dtype and torch.equal(a, b)
        assert plain[0].tolist() == (want * reps)[:n]
        for a, b in zip(got, plain):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_kernel_wrappers_fill_exactly_their_out_view(card, corpus, comb_setup):
    """``out=`` of the general and the comb wrapper: the kernel writes the
    view's lanes, returns the view, and leaves the bytes around it as they
    were."""
    from mochi_tpu_torch.crypto import cuda_comb as CC

    items, want, _ = corpus
    n, lo = 333, 40
    prepared = BV.prepare_packed(items[:n])
    buf = torch.full((n + 2 * lo,), 0xA5, dtype=torch.uint8, device=card)
    view = buf.view(torch.bool)[lo:lo + n]
    tens = CV.from_reference_prepared(prepared, card)
    got = CV.verify_prepared_packed(*tens, out=view)
    assert got.data_ptr() == view.data_ptr()
    host = buf.cpu()
    assert host[:lo].eq(0xA5).all() and host[lo + n:].eq(0xA5).all()
    assert torch.equal(host[lo:lo + n], CV.verify_prepared_packed(*tens).to(torch.uint8).cpu())
    assert (host[lo:lo + n].numpy().astype(bool) & prepared[6]).tolist() == want[:n]

    reg, citems, cwant = comb_setup
    cprep = BV.prepare_packed(citems[:n])
    kidx = np.asarray([reg.index_of(it.public_key) for it in citems[:n]], dtype=np.int32)
    lanes = CC.from_prepared(kidx, cprep, card)
    table = reg.device_table(card, layout=CC.table_layout(card, *CC.switches()))
    buf.fill_(0xA5)
    got = CC.verify_comb_prepared(table, *lanes, out=view)
    assert got.data_ptr() == view.data_ptr()
    host = buf.cpu()
    assert host[:lo].eq(0xA5).all() and host[lo + n:].eq(0xA5).all()
    assert torch.equal(host[lo:lo + n], CC.verify_comb_prepared(table, *lanes).to(torch.uint8).cpu())
    assert (host[lo:lo + n].numpy().astype(bool) & cprep[6]).tolist() == cwant[:n]
    with pytest.raises(ValueError):
        CV.verify_prepared_packed(*tens, out=view[:-1])


def test_sharded_backend_on_two_slices_of_the_card(card, comb_setup):
    from mochi_tpu_torch.crypto import keys
    from mochi_tpu_torch.parallel import make_mesh
    from mochi_tpu_torch.verifier.cuda import ShardedCudaBatchBackend

    reg, items, want = comb_setup
    backend = ShardedCudaBatchBackend(make_mesh(devices=[card, card]), min_device_items=0)
    backend.register_signers(reg.public_keys())
    backend.warmup()
    before = BV.comb_routing_counts()
    assert backend(items) == want
    stranger = keys.generate_keypair()
    extra = [VerifyItem(stranger.public_key, b"x", stranger.sign(b"x"))]
    assert backend(items[:7] + extra) == want[:7] + [True]
    after = BV.comb_routing_counts()
    assert after["comb_items"] - before["comb_items"] == len(items)
    assert after["ladder_items"] - before["ladder_items"] == 8


def test_service_cli_cuda_sharded_serves_on_the_card(card, corpus, tmp_path):
    """``python -m mochi_tpu_torch.verifier.service --backend cuda-sharded``:
    the sharded verifier's log line, READY, and bitmaps equal to the
    expected verdicts with no fallback (the known signers on the comb
    kernel, every other key on the general one)."""
    import asyncio
    import re
    import subprocess
    import sys

    from mochi_tpu_torch.verifier.service import RemoteVerifier

    items, want, kinds = corpus
    pubs = sorted({it.public_key for it, k in zip(items, kinds) if k == "valid"})
    (tmp_path / "signers.txt").write_text("".join(p.hex() + "\n" for p in pubs))
    proc = subprocess.Popen(
        [sys.executable, "-m", "mochi_tpu_torch.verifier.service", "--port", "0", "--backend", "cuda-sharded",
         "--signers-file", str(tmp_path / "signers.txt")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )

    async def ask(port):
        rv = RemoteVerifier("127.0.0.1", port, timeout_s=120)
        try:
            return await rv.verify_batch(items), rv.fallback_batches
        finally:
            await rv.close()

    try:
        line = proc.stdout.readline()
        assert line.startswith("READY verifier-service "), line
        assert asyncio.run(ask(int(line.split()[-1]))) == (want, 0)
    finally:
        proc.terminate()
        _, err = proc.communicate(timeout=60)
    n = torch.cuda.device_count()
    assert re.search(rf"sharded verifier over {n} devices \(warmup [0-9.]+s, {len(pubs)} known signers\)", err), err
