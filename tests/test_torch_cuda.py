"""The CUDA kernels (general verify and comb) on the card.

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
    before = CV.launches
    got = CV.verify_prepared_packed(*tens)
    assert CV.launches == before + 1
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
    before = CC.launches
    got = CC.verify_comb_prepared(reg.device_table(card), *lanes)
    assert CC.launches == before + 1
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
        CC.verify_comb_prepared(reg.device_table(card), *bad)
    assert CC.verify_comb_prepared(reg.device_table(card), *(t[:0] for t in lanes)).shape == (0,)


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
