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
    comb corpus: 600 lanes (a partial last block of the accumulate pass's 4
    signatures and of the prepare pass's 128), indices past the table, and
    the expected verdicts."""
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
    assert attrs["accumulate"]["threads"] % 32 == 0 and attrs["prepare"]["registers"] > 0


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
    indices past both ends of the table, and the expected verdicts."""
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
    last block of both passes (2 signatures a block of the accumulate pass,
    64 of the prepare pass), one lane, indices past the table, and the
    expected verdicts."""
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
    assert attrs["accumulate"]["registers"] > 0 and attrs["accumulate"]["shared_bytes"] > 0


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


@pytest.mark.parametrize("n,g", [(0, 4), (1, 1), (1000, 37), (5000, 0), (66048, 1537)])
def test_tally_kernel_equals_plain_version_on_wrapping_and_dropped_ids(card, n, g):
    from mochi_tpu_torch.parallel import cuda_tally as CT
    from mochi_tpu_torch.parallel import sharded as S

    rng = np.random.default_rng(n + g)
    bitmap = torch.from_numpy(rng.random(n) < 0.8).to(card)
    ok = torch.from_numpy(rng.random(n) < 0.9).to(card)
    ids = torch.from_numpy(rng.integers(-2 * g - 1, 2 * g + 2, n).astype(np.int32)).to(card)
    before, before_c = CT.launches, CT.commit_launches
    got = CT.quorum_tally(bitmap, ok, ids, g)
    committed = CT.quorum_commit(got, 3)
    assert (CT.launches, CT.commit_launches) == (before + 1, before_c + 1)
    assert got.dtype == torch.int32 and got.device == card
    assert torch.equal(got, S.segment_tally(bitmap, ok, ids, g))
    assert torch.equal(committed, S.commit(got, 3))


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
        before = (CV.launches["pad"], CT.launches, CT.commit_launches, dict(CC.launches))
        got = make_quorum_step(mesh, g)(*prepared, ids, 4)
        after = (CV.launches["pad"], CT.launches, CT.commit_launches, dict(CC.launches))
        assert after == (before[0] + mesh.size, before[1] + mesh.size, before[2] + 1, before[3])
        for a, b in zip(got, plain):
            assert a.dtype == b.dtype and torch.equal(a, b)


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
