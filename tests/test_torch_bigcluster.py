"""Large-cluster protocol correctness: the BASELINE north-star shapes.

For a long time no cluster larger than 6 replicas had booted, while
BASELINE.json's headline metric is defined at n=64,
f=21.  These tests run the REAL protocol — full Write1 fan-out, quorum
certificate assembly + quorum-cover trimming, Write2 cert verification on
every replica — at the CI-sized n=16 f=5 shape (grounding config 3's
cluster scale) and an n=64 f=21 smoke, plus the comb registry at its
design size of 64 identities (crypto/comb.py:34 "n=64 clusters stay
~7.5 MB").

The reference supports RF up to n (``ClusterConfiguration.java:167-186``)
but its tests stop at rf=4; the quorum arithmetic exercised here
(f=(rf-1)//3, quorum=2f+1) only shows its corner cases at larger f — e.g.
losing exactly f replicas leaves exactly quorum members, so liveness holds
with zero slack.
"""

from __future__ import annotations

import asyncio

import pytest

from mochi_tpu_torch.client.errors import MochiClientError
from mochi_tpu_torch.client.txn import TransactionBuilder
from mochi_tpu_torch.testing.virtual_cluster import VirtualCluster


def test_n16_f5_full_protocol():
    """n=16, rf=16 -> f=5, quorum=11: writes commit with 11-grant certs;
    killing f replicas keeps liveness with ZERO quorum slack; killing one
    more loses it (correct BFT refusal, not a bug)."""

    async def drive():
        async with VirtualCluster(16, rf=16) as vc:
            cfg = vc.config
            assert cfg.f == 5 and cfg.quorum == 11
            client = vc.client(timeout_s=30.0)

            await client.execute_write_transaction(
                TransactionBuilder().write("big16", b"v1").build()
            )
            res = await client.execute_read_transaction(
                TransactionBuilder().read("big16").build()
            )
            assert res.operations[0].value == b"v1"
            cert = res.operations[0].current_certificate
            # quorum-cover trimming must shave the rf-quorum surplus down
            # to exactly 2f+1 grants (client._trim_to_quorum_cover)
            assert cert is not None and len(cert.grants) == cfg.quorum

            # overwrite + multi-key through the same quorum machinery
            await client.execute_write_transaction(
                TransactionBuilder().write("big16", b"v2").write("big16b", b"w").build()
            )
            res = await client.execute_read_transaction(
                TransactionBuilder().read("big16").build()
            )
            assert res.operations[0].value == b"v2"

            # Lose exactly f replicas: quorum survives with zero slack.
            victims = [r for r in vc.replicas[: cfg.f]]
            for r in victims:
                await r.close()
            await client.execute_write_transaction(
                TransactionBuilder().write("big16", b"v3").build()
            )
            res = await client.execute_read_transaction(
                TransactionBuilder().read("big16").build()
            )
            assert res.operations[0].value == b"v3"

            # Lose one more (f+1 down): writes must fail — fewer than 2f+1
            # healthy members remain, so no certificate can form.
            await vc.replicas[cfg.f].close()
            fast = vc.client(timeout_s=2.0, write_attempts=1)
            with pytest.raises(MochiClientError):
                await fast.execute_write_transaction(
                    TransactionBuilder().write("big16", b"v4").build()
                )

    asyncio.run(drive())


def test_n64_f21_smoke():
    """The north-star shape itself: 64 replicas, f=21, one signed PUT
    committing a 43-grant certificate through the full 2-phase protocol."""

    async def drive():
        async with VirtualCluster(64, rf=64) as vc:
            cfg = vc.config
            assert cfg.f == 21 and cfg.quorum == 43
            client = vc.client(timeout_s=60.0)
            await client.execute_write_transaction(
                TransactionBuilder().write("north-star", b"n64").build()
            )
            res = await client.execute_read_transaction(
                TransactionBuilder().read("north-star").build()
            )
            assert res.operations[0].value == b"n64"
            cert = res.operations[0].current_certificate
            assert cert is not None and len(cert.grants) == 43

    asyncio.run(drive())


def test_comb_registry_at_design_size():
    """64 registered identities — the comb registry's design point: table
    device footprint ~7.5 MB, gathers spanning the full (64*576, 51) flat
    table.  Verdicts must stay differentially exact vs OpenSSL across all
    64 signers, including a forged item mid-batch."""
    import numpy as np

    from mochi_tpu_torch.crypto import comb as comb_mod
    from mochi_tpu_torch.crypto import keys
    from mochi_tpu_torch.crypto.batch_verify import prepare_packed
    from mochi_tpu_torch.verifier.spi import VerifyItem

    from mochi_tpu.crypto import comb as ref_comb
    from mochi_tpu_torch.crypto import cuda_comb

    reg = comb_mod.SignerRegistry("cpu")
    ref_reg = ref_comb.SignerRegistry()
    kps = [keys.keypair_from_seed(bytes([i + 1] * 32)) for i in range(64)]
    for kp in kps:
        assert reg.register(kp.public_key) is not None
        assert ref_reg.register(kp.public_key) == reg.index_of(kp.public_key)
    assert len(reg) == 64

    items = []
    for i, kp in enumerate(kps):
        msg = b"design-size %d" % i
        items.append(VerifyItem(kp.public_key, msg, kp.sign(msg)))
    # one forgery mid-batch: signer 31's signature over a different message
    bad = 31
    items[bad] = VerifyItem(
        kps[bad].public_key, b"not what was signed", items[bad].signature
    )

    prepared = prepare_packed(items)
    pre_ok = prepared[6]
    assert pre_ok.all()
    key_idx = np.asarray(
        [reg.index_of(it.public_key) for it in items], dtype=np.int32
    )
    table = reg.device_table(layout="fe17")
    assert table.shape == (64 * comb_mod.N_WINDOWS * comb_mod.N_ENTRIES, comb_mod.ROW_WIDTH)
    # the table the plain version reads is the reference's, row for row
    assert np.array_equal(table.numpy(), np.asarray(ref_reg.device_table()))
    out = comb_mod.verify_comb_prepared(table, *cuda_comb.from_prepared(key_idx, prepared, "cpu")).numpy()
    expect = np.ones(64, bool)
    expect[bad] = False
    assert (out == expect).all(), np.nonzero(out != expect)


async def _run_shape(n: int, writers: int, writes_per_writer: int) -> dict:
    """The port's cluster at ``n`` replicas (rf = n, admission off as the
    reference's config-6 shape runs it), ``writers`` SDK clients x
    ``writes_per_writer`` signed PUTs: the committed writes per second."""
    import time

    async with VirtualCluster(n, rf=n, shed_lag_ms=0.0) as vc:

        async def worker(wi: int) -> None:
            client = vc.client(timeout_s=60.0)
            for k in range(writes_per_writer):
                await client.execute_write_transaction(
                    TransactionBuilder().write(f"big-{wi}-{k}", b"v%d" % k).build()
                )

        t0 = time.perf_counter()
        await asyncio.gather(*[worker(i) for i in range(writers)])
        return {"txn_per_s": writers * writes_per_writer / (time.perf_counter() - t0)}


@pytest.mark.slow
def test_config6_shape_order_independence():
    """Run-order-independence regression for the config-6 GC-debt artifact
    an n=16 record taken AFTER an n=64 run must land
    within 10% of an n16-first record.

    Root cause (BASELINE.md "GC debt, root-caused"): the torn-down
    64-replica object graph is cyclic, so under the relaxed server GC
    thresholds it lingers uncollected while the next shape's allocations
    repeatedly trigger collections that trace the dead giant graph.
    ``reset_gc_debt()`` (collect + refreeze between shapes, as the
    reference's config-6 benchmark does) is the fix under test, here on the
    port's cluster (``_run_shape`` above).
    Marked slow: it is a timing comparison and runs real cluster
    workloads; the tier-1 gate stays fast without it.
    """
    from mochi_tpu_torch.utils.runtime import reset_gc_debt, tune_gc_for_server

    tune_gc_for_server()

    def n16_rate(reps: int = 3) -> float:
        # best-of-N, one-sided: tenancy noise only ever SLOWS a run, so
        # the max approaches the true rate (the repo's measurement rule —
        # never single runs on this ±30% host)
        rates = []
        for _ in range(reps):
            rec = asyncio.run(_run_shape(16, 4, 3))
            rates.append(rec["txn_per_s"])
            reset_gc_debt()
        return max(rates)

    # Up to two full attempts: a background-load window spanning one whole
    # best-of-3 leg (but not the other) is indistinguishable from a real
    # ordering effect within a single pair, so a failed comparison gets
    # one fresh pair before it is believed.
    last = None
    for _attempt in range(2):
        first = n16_rate()
        # generate the debt: a full n=64 boot + workload + teardown
        asyncio.run(_run_shape(64, 4, 2))
        reset_gc_debt()  # the config-6 fix under test
        after = n16_rate()
        if after >= 0.9 * first:
            return
        last = (after, first)
    after, first = last
    raise AssertionError(
        f"n16-after-n64 regressed past 10% in two independent pairs: "
        f"{after:.1f} vs {first:.1f} txn/s — GC debt is back "
        "(see BASELINE.md root cause)"
    )
