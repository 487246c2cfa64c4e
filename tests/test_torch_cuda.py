"""The CUDA verify kernel on the card.

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

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA verify kernel has no CPU mode")
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
