"""Regressions for the resync/persistence review findings.

1. A stored certificate carrying extra validly-signed non-OK or minority
   grants must not poison ``certificate_timestamp`` (would brick the key for
   every later Write2 and crash resync).
2. State transfer pages through stores larger than one page.
3. Snapshots from another server id are refused.
"""

import asyncio

from mochi_tpu_torch.client import TransactionBuilder
from mochi_tpu_torch.protocol import Grant, MultiGrant, Status, WriteCertificate
from mochi_tpu_torch.server.store import StoreValue
from mochi_tpu_torch.testing import VirtualCluster


def run(coro):
    asyncio.run(asyncio.wait_for(coro, timeout=120))


def test_certificate_timestamp_survives_byzantine_extras():
    ok = lambda sid, ts: MultiGrant(
        {"k": Grant("k", ts, 1, b"h", Status.OK)}, "c", sid
    )
    refused = MultiGrant({"k": Grant("k", 777, 1, b"h", Status.REFUSED)}, "c", "s4")
    minority = MultiGrant({"k": Grant("k", 999, 1, b"h", Status.OK)}, "c", "s5")
    sv = StoreValue("k")
    sv.current_certificate = WriteCertificate(
        {"s1": ok("s1", 500), "s2": ok("s2", 500), "s3": ok("s3", 500),
         "s4": refused, "s5": minority}
    )
    # majority OK timestamp wins; no exception despite disagreeing grants
    assert sv.certificate_timestamp() == 500

    # all-non-OK degenerates to None, not a crash
    sv2 = StoreValue("k")
    sv2.current_certificate = WriteCertificate({"s4": refused})
    assert sv2.certificate_timestamp() is None


def test_certificate_timestamp_ignores_out_of_set_signers():
    """Out-of-set signers must not out-vote the in-set quorum.

    With replica_set given, only in-set servers vote — one vote each — so a
    Byzantine client embedding many validly-signed out-of-set grants at a
    bogus timestamp cannot flip the stored timestamp and poison the
    staleness check in ``process_write2``.
    """
    ok = lambda sid, ts: MultiGrant(
        {"k": Grant("k", ts, 1, b"h", Status.OK)}, "c", sid
    )
    in_set = {"s1", "s2", "s3", "s4"}
    grants = {f"s{i}": ok(f"s{i}", 500) for i in range(1, 5)}
    # five out-of-set colluders all vote timestamp 9000 (more raw votes)
    grants.update({f"x{i}": ok(f"x{i}", 9000) for i in range(5)})
    # plus a duplicated in-set server id under a different dict key
    grants["dup"] = ok("s1", 9000)
    sv = StoreValue("k")
    sv.current_certificate = WriteCertificate(grants)
    assert sv.certificate_timestamp(in_set) == 500
    # unrestricted view would have been poisoned — documents why the
    # server path always passes the replica set
    assert sv.certificate_timestamp() == 9000


def test_resync_pages_through_large_store():
    async def main():
        async with VirtualCluster(4, rf=4) as vc:
            client = vc.client()
            # more keys than one sync page (use a small page to keep it fast)
            for batch_start in range(0, 30, 10):
                tb = TransactionBuilder()
                for i in range(batch_start, batch_start + 10):
                    tb.write(f"pg-{i:03d}", b"v%d" % i)
                await client.execute_write_transaction(tb.build())

            donor = vc.replica("server-1")
            page = donor.store.export_sync_entries(max_entries=7)
            assert len(page) == 7
            collected = {e.key for e in page}
            while True:
                nxt = donor.store.export_sync_entries(
                    max_entries=7, after_key=page[-1].key
                )
                if not nxt:
                    break
                collected |= {e.key for e in nxt}
                if len(nxt) < 7:
                    break
                page = nxt
            assert {f"pg-{i:03d}" for i in range(30)} <= collected

            # end-to-end: restarted replica recovers everything via resync
            fresh = await vc.restart_replica("server-0", resync=True)
            have = {
                k for k, sv in fresh.store.data.items() if sv.current_certificate
            }
            assert {f"pg-{i:03d}" for i in range(30)} <= have

    run(main())


def test_snapshot_wrong_server_refused(tmp_path):
    from mochi_tpu_torch.cluster.config import ClusterConfig
    from mochi_tpu_torch.server import persistence
    from mochi_tpu_torch.server.store import DataStore

    cfg = ClusterConfig.build(
        {f"server-{i}": f"127.0.0.1:{9100+i}" for i in range(4)}, rf=4
    )
    donor = DataStore("server-1", cfg)
    path = str(tmp_path / "s1.snapshot")
    persistence.write_snapshot(donor, path)
    other = DataStore("server-0", cfg)
    try:
        persistence.load_snapshot(other, path)
        raise AssertionError("expected ValueError")
    except ValueError as exc:
        assert "server-1" in str(exc)


def test_batcher_close_while_flusher_awaits_inflight_slot():
    """close() while the flusher is blocked on the in-flight semaphore must
    cancel the still-queued items (a review finding: the chunk used to be
    popped BEFORE the acquire, so cancelling the flusher there stranded the
    popped chunk's futures forever)."""
    import asyncio
    import time

    from mochi_tpu_torch.crypto import keys
    from mochi_tpu_torch.verifier.spi import BatchingVerifier, VerifyItem

    kp = keys.generate_keypair()

    async def main():
        def slow_backend(chunk):
            time.sleep(0.2)
            return [True] * len(chunk)

        bv = BatchingVerifier(
            slow_backend, max_batch=4, max_delay_s=0.0, max_inflight=2
        )
        items = [
            VerifyItem(kp.public_key, b"m%d" % i, kp.sign(b"m%d" % i))
            for i in range(40)
        ]
        tasks = [
            asyncio.create_task(bv.verify_batch(items[i * 4 : (i + 1) * 4]))
            for i in range(10)
        ]
        await asyncio.sleep(0.05)  # saturate in-flight, flusher parks on acquire
        await asyncio.wait_for(bv.close(), timeout=5)
        hung = 0
        for t in tasks:
            try:
                res = await asyncio.wait_for(t, timeout=5)
                assert all(res)
            except (asyncio.CancelledError, RuntimeError):
                pass
            except asyncio.TimeoutError:
                hung += 1
        assert hung == 0, f"{hung} verify_batch callers hung after close()"

    asyncio.run(main())


def test_caching_verifier_waiter_survives_dispatcher_failure():
    """Single-flight: if the caller that dispatched a key fails (error or
    cancellation), a concurrent waiter on that key must re-verify
    independently, not inherit the dispatcher's failure (a review finding)."""
    import asyncio

    from mochi_tpu_torch.crypto import keys
    from mochi_tpu_torch.verifier.spi import CachingVerifier, SignatureVerifier, VerifyItem

    class FlakyVerifier(SignatureVerifier):
        def __init__(self):
            self.calls = 0

        async def verify_batch(self, items):
            self.calls += 1
            await asyncio.sleep(0.05)
            if self.calls == 1:
                raise RuntimeError("first dispatch dies")
            return [
                keys.verify(it.public_key, it.message, it.signature)
                for it in items
            ]

    async def main():
        cv = CachingVerifier(FlakyVerifier())
        kp = keys.generate_keypair()
        it = VerifyItem(kp.public_key, b"g", kp.sign(b"g"))
        t1 = asyncio.create_task(cv.verify_batch([it]))
        await asyncio.sleep(0.01)
        t2 = asyncio.create_task(cv.verify_batch([it]))
        (r1,) = await asyncio.gather(t1, return_exceptions=True)
        assert isinstance(r1, RuntimeError)
        assert await t2 == [True]

    asyncio.run(main())


def test_batcher_runs_chunks_concurrently_up_to_max_inflight():
    """The max_inflight semaphore must deliver real overlap: a backlog of
    4 chunks against a slow backend with max_inflight=2 must reach 2
    concurrent backend calls — and never exceed the cap."""
    import asyncio
    import threading
    import time

    from mochi_tpu_torch.crypto import keys
    from mochi_tpu_torch.verifier.spi import BatchingVerifier, VerifyItem

    kp = keys.generate_keypair()
    lock = threading.Lock()
    state = {"now": 0, "peak": 0}

    def slow_backend(chunk):
        with lock:
            state["now"] += 1
            state["peak"] = max(state["peak"], state["now"])
        time.sleep(0.15)
        with lock:
            state["now"] -= 1
        return [True] * len(chunk)

    async def main():
        bv = BatchingVerifier(
            slow_backend, max_batch=4, max_delay_s=0.0, max_inflight=2
        )
        items = [
            VerifyItem(kp.public_key, b"p%d" % i, kp.sign(b"p%d" % i))
            for i in range(16)
        ]
        tasks = [
            asyncio.create_task(bv.verify_batch(items[i * 4 : (i + 1) * 4]))
            for i in range(4)
        ]
        results = await asyncio.gather(*tasks)
        assert all(all(r) for r in results)
        await bv.close()
        assert state["peak"] == 2, f"peak concurrency {state['peak']}, want 2"

    asyncio.run(main())


def test_caching_verifier_rejects_short_bitmap():
    """A misbehaving inner verifier that returns fewer verdicts than items
    must fail loudly AND resolve the in-flight futures with the retry
    sentinel — a truncated zip would otherwise leave concurrent waiters on
    the tail keys hanging forever (a review finding)."""
    import asyncio

    from mochi_tpu_torch.crypto import keys
    from mochi_tpu_torch.verifier.spi import CachingVerifier, SignatureVerifier, VerifyItem

    class ShortVerifier(SignatureVerifier):
        def __init__(self):
            self.calls = 0

        async def verify_batch(self, items):
            self.calls += 1
            await asyncio.sleep(0.05)
            if self.calls == 1:
                return [True] * (len(items) - 1)  # short!
            return [
                keys.verify(it.public_key, it.message, it.signature)
                for it in items
            ]

    async def main():
        cv = CachingVerifier(ShortVerifier())
        kp = keys.generate_keypair()
        items = [
            VerifyItem(kp.public_key, m, kp.sign(m)) for m in (b"a", b"b")
        ]
        t1 = asyncio.create_task(cv.verify_batch(items))
        await asyncio.sleep(0.01)
        # waiter joins the in-flight futures for the same keys
        t2 = asyncio.create_task(cv.verify_batch(items))
        (r1,) = await asyncio.gather(t1, return_exceptions=True)
        assert isinstance(r1, RuntimeError)
        # the waiter must complete (not hang) with correct verdicts
        assert await asyncio.wait_for(t2, timeout=5) == [True, True]
        assert not cv._inflight

    asyncio.run(main())


def test_certificate_timestamps_equal_the_reference():
    """Seeded certificates of in-set, out-of-set, refusing and duplicated
    signers at a few timestamps, as carried over the wire: the port's
    stored certificate timestamp (restricted to the replica set and not)
    equals the reference's."""
    import random

    from mochi_tpu.server.store import StoreValue as RefValue
    from mochi_tpu_torch.protocol import Transaction, Write2ToServer
    from tests.torch_crosswire import to_port, to_reference

    rng = random.Random(99)
    in_set = {"s1", "s2", "s3", "s4"}
    for _ in range(60):
        grants = {}
        for j in range(rng.randint(1, 9)):
            sid = rng.choice(sorted(in_set) + ["x1", "x2", "x3"])
            status = Status.OK if rng.random() < 0.8 else Status.REFUSED
            grants[f"{sid}#{j}"] = MultiGrant({"k": Grant("k", rng.choice([500, 700, 9000]), 1, b"h", status)}, "c",
                                               sid)
        # both sides hold the certificate as the wire orders it (a tie of
        # votes goes to the first timestamp met)
        ref_msg = to_reference(Write2ToServer(WriteCertificate(grants), Transaction(())))
        cert, ref_cert = to_port(ref_msg).write_certificate, ref_msg.write_certificate
        mine, theirs = StoreValue("k"), RefValue("k")
        mine.current_certificate, theirs.current_certificate = cert, ref_cert
        assert mine.certificate_timestamp(in_set) == theirs.certificate_timestamp(in_set)
        assert mine.certificate_timestamp() == theirs.certificate_timestamp()
