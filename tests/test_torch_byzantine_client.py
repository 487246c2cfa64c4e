"""The port's Byzantine-client harness (``testing/byzantine_client.py``) and
the store defenses it forces, on the CPU.

Ported from the JAX package's ``tests/test_byzantine_client.py``: the
withhold wedge reclaimed within the grant TTL (and wedged forever without
it), the per-client quota against grant-hoard, wide transactions and
idempotent retries, abandoned grants decaying at quota pressure,
partial-write2 divergence healing, seed-bias contention, and the
reclaimed-slot invariant's non-vacuity.  Every cluster runs the CPU
verifier.  Added: ``seed-bias``'s and ``grant-hoard``'s seed and key
sequences for a seed equal the reference's, and the client strategy
refusals match.
"""

from __future__ import annotations

import asyncio
import time

import pytest

from mochi_tpu_torch.client.errors import RequestRefused
from mochi_tpu_torch.client.txn import TransactionBuilder
from mochi_tpu_torch.server import store as store_mod
from mochi_tpu_torch.testing import InvariantChecker, VirtualCluster
from mochi_tpu_torch.testing.byzantine_client import defense_knobs as _knobs


def run(coro):
    asyncio.run(asyncio.wait_for(coro, timeout=120))


async def _commit_with_retry(client, key, val, deadline_s):
    """App-level retry loop (the benchmark's time-to-conflicting-commit
    probe): retry RequestRefused until the deadline; return elapsed s."""
    t0 = time.monotonic()
    while True:
        try:
            await client.execute_write_transaction(
                TransactionBuilder().write(key, val).build()
            )
            return time.monotonic() - t0
        except RequestRefused:
            if time.monotonic() - t0 > deadline_s:
                raise
            await asyncio.sleep(0.02)


def test_withhold_wedge_reclaimed_within_ttl():
    """The defense arc: a withholding client sweeps EVERY subEpoch seed
    of a key's epoch (full wedge — every conflicting Write1 refused at
    any seed), and grant-TTL reclamation un-wedges the honest writer in
    bounded time: conflicting commit lands within ~TTL, reclaim counters
    accrue, the wedge liveness metric records the window, and every
    safety invariant (incl. the new reclaimed-slot rule) holds."""

    async def main():
        # TTL effectively infinite while the wedge is demonstrated (the
        # sweep itself takes longer than a realistic TTL, so a small value
        # would expire the grants before the honest writer ever collides),
        # then dropped so the already-aged grants reclaim on the next
        # conflict — each phase is deterministic.
        with _knobs(ttl_ms=3600e3, quota=0):
            async with VirtualCluster(4, rf=4) as vc:
                checker = InvariantChecker(vc.replicas)
                checker.start(0.02)
                byz = vc.byzantine_client("withhold")
                honest = vc.client(timeout_s=2.0, write_attempts=6)
                held = await byz.wedge("wk")
                # the sweep owns the whole seed space at every replica
                assert held >= 4 * 1000, held
                # phase 1: wedged — every conflicting Write1 refused at
                # whatever seed the honest client draws
                with pytest.raises(RequestRefused):
                    await honest.execute_write_transaction(
                        TransactionBuilder().write("wk", b"good").build()
                    )
                # phase 2: reclamation on — the held grants are now past
                # the TTL, so the next conflict supersedes them and the
                # honest commit lands in bounded time
                store_mod.GRANT_TTL_MS = 250.0
                elapsed = await _commit_with_retry(honest, "wk", b"good", 5.0)
                checker.record_ack("wk", b"good")
                assert elapsed < 2.0, elapsed
                reclaims = sum(r.store.reclaims for r in vc.replicas)
                assert reclaims > 0, "no grant was ever reclaimed"
                # the liveness metric saw the wedge open and close
                assert any(
                    r.store.max_wedge_ms > 0 for r in vc.replicas
                ), [r.store.max_wedge_ms for r in vc.replicas]
                # the withholder is attributed in the per-client ledger
                assert any(
                    r.store.client_stats()["per_client"]
                    .get(byz.client_id, {})
                    .get("reclaimed_from", 0)
                    > 0
                    for r in vc.replicas
                )
                res = await honest.execute_read_transaction(
                    TransactionBuilder().read("wk").build()
                )
                assert res.operations[0].value == b"good"
                await checker.final_check(honest)
                await checker.stop()
                report = checker.report()
                assert report["ok"], report["violations"]
                assert report["grant_reclaims"] == reclaims
                assert report["max_wedge_ms"] > 0

    run(main())


def test_withhold_wedges_forever_without_ttl():
    """The hole the defense closes, demonstrated: with reclamation AND
    quota off (the posture without the defenses), the full-seed wedge refuses a
    conflicting honest writer indefinitely — the typed RequestRefused is
    all it ever gets, and the wedge stays open on the admin surface."""

    async def main():
        with _knobs(ttl_ms=0.0, quota=0):
            async with VirtualCluster(4, rf=4) as vc:
                byz = vc.byzantine_client("withhold")
                honest = vc.client(timeout_s=2.0, write_attempts=6)
                assert await byz.wedge("fk") >= 4 * 1000
                with pytest.raises(RequestRefused):
                    await honest.execute_write_transaction(
                        TransactionBuilder().write("fk", b"v").build()
                    )
                st = vc.replicas[0].store.client_stats()
                assert st["open_wedges"] >= 1, st
                assert st["max_open_wedge_ms"] > 0, st
                assert sum(r.store.reclaims for r in vc.replicas) == 0

    run(main())


def test_quota_caps_grant_hoard():
    """grant-hoard vs the per-client quota: a sweep across 64 keys is
    capped at quota outstanding grants per replica, the overflow gets the
    typed QUOTA_EXCEEDED refusal (counted on both sides), and honest
    writers on hoarded keys commit unimpeded."""

    async def main():
        with _knobs(ttl_ms=0.0, quota=16):
            async with VirtualCluster(4, rf=4) as vc:
                byz = vc.byzantine_client("grant-hoard")
                await byz.hoard([f"h-{i}" for i in range(64)])
                assert byz.stats["quota_refused"] > 0, byz.stats
                for r in vc.replicas:
                    st = r.store.client_stats()
                    held = st["per_client"].get(byz.client_id, {})
                    assert held.get("outstanding", 0) <= 16, (r.server_id, held)
                    assert st["quota_refused"] > 0
                    # the replica-side surface counted the typed refusals
                    assert r.client_grant_stats()["quota_refusals_served"] > 0
                honest = vc.client(timeout_s=2.0)
                for i in range(4):
                    await honest.execute_write_transaction(
                        TransactionBuilder().write(f"h-{i}", b"ok").build()
                    )
                    res = await honest.execute_read_transaction(
                        TransactionBuilder().read(f"h-{i}").build()
                    )
                    assert res.operations[0].value == b"ok"

    run(main())


def test_quota_refusal_is_flow_control_for_honest_sdk():
    """An identity at its quota driving the HONEST SDK write path gets
    flow control, not a hang: typed QUOTA_EXCEEDED refusals feed the
    shed-backoff arc and surface as a bounded typed RequestRefused, with
    the client-side quota counters accrued for the admin shell."""

    async def main():
        with _knobs(ttl_ms=0.0, quota=2):
            async with VirtualCluster(4, rf=4) as vc:
                byz = vc.byzantine_client("withhold")
                # exhaust the wrapped identity's quota with held grants
                await byz.acquire("q-a", 7)
                await byz.acquire("q-b", 8)
                with pytest.raises(RequestRefused):
                    # the SAME identity through the production write path
                    await byz.client.execute_write_transaction(
                        TransactionBuilder().write("q-c", b"v").build()
                    )
                assert byz.client.metrics.counters.get("client.write1-quota", 0) > 0
                assert any(
                    name.startswith("client.quota-refused.")
                    for name in byz.client.metrics.counters
                )

    run(main())


def test_quota_counts_wide_transactions():
    """One wide Write1 must not hoard past the quota in a single message:
    the quota counts the request's distinct owned keys too, so a 64-key
    transaction against quota=16 is refused typed with NOTHING issued."""
    from mochi_tpu_torch.protocol import (
        Action,
        FailType,
        Operation,
        RequestFailedFromServer,
        Transaction,
        transaction_hash,
    )

    async def main():
        with _knobs(ttl_ms=0.0, quota=16):
            async with VirtualCluster(4, rf=4) as vc:
                byz = vc.byzantine_client("grant-hoard")
                txn = Transaction(
                    tuple(
                        Operation(Action.WRITE, f"wide-{i}", b"x")
                        for i in range(64)
                    )
                )
                blind = byz.client._write1_transaction(txn)
                info = vc.config.servers["server-0"]
                payload = await byz._write1_one(
                    info, blind, 7, transaction_hash(txn)
                )
                assert isinstance(payload, RequestFailedFromServer), payload
                assert payload.fail_type == FailType.QUOTA_EXCEEDED
                st = vc.replicas[0].store.client_stats()
                held = st["per_client"].get(byz.client_id, {})
                assert held.get("outstanding", 0) == 0, held

    run(main())


def test_quota_exempts_idempotent_retry():
    """A client AT its quota retrying a Write1 whose grants it already
    holds (lost Write1Ok) issues nothing new — the retry must return the
    existing grants, not a QUOTA_EXCEEDED that strands its own in-flight
    write."""

    async def main():
        with _knobs(ttl_ms=0.0, quota=4):
            async with VirtualCluster(4, rf=4) as vc:
                byz = vc.byzantine_client("withhold")
                for i in range(4):
                    grants = await byz.acquire(f"iq-{i}", 7)
                    assert grants, i  # at quota after the 4th
                refused_before = byz.stats["quota_refused"]
                # retry of iq-0 at the same (txn, seed): idempotent, exempt
                again = await byz.acquire("iq-0", 7)
                assert again, "idempotent retry was refused at quota"
                assert byz.stats["quota_refused"] == refused_before
                # ...while a NEW key is still quota-refused
                assert not await byz.acquire("iq-new", 7)
                assert byz.stats["quota_refused"] > refused_before

    run(main())


def test_abandoned_grants_decay_at_quota_pressure():
    """An honest client's ABANDONED grants (no conflicting writer ever
    touches those slots, so the lazy conflict-reclaim never fires) must
    not pin its quota forever: at quota pressure the expiry sweep
    reclaims its TTL-aged grants and the next transaction proceeds."""

    async def main():
        with _knobs(ttl_ms=200.0, quota=4):
            async with VirtualCluster(4, rf=4) as vc:
                byz = vc.byzantine_client("withhold")
                for i in range(4):
                    await byz.acquire(f"dk-{i}", 7)
                # age the residue past the TTL; nothing conflicts with it
                await asyncio.sleep(0.3)
                # the same identity's next write succeeds: the quota path
                # swept the aged grants instead of refusing
                await byz.client.execute_write_transaction(
                    TransactionBuilder().write("dk-new", b"v").build()
                )
                assert sum(r.store.reclaims for r in vc.replicas) > 0
                res = await byz.client.execute_read_transaction(
                    TransactionBuilder().read("dk-new").build()
                )
                assert res.operations[0].value == b"v"

    run(main())


def test_partial_write2_minority_divergence_heals():
    """partial-write2: a fully valid certificate committed at ONE replica
    only.  The minority replica holds a commit the majority never saw —
    replicas diverge on outstanding state — but safety invariants hold
    and an honest writer's quorum still decides reads."""

    async def main():
        async with VirtualCluster(4, rf=4) as vc:
            checker = InvariantChecker(vc.replicas)
            checker.start(0.02)
            byz = vc.byzantine_client("partial-write2")
            assert await byz.partial_write2("pk", b"evil", n_targets=1)
            assert byz.stats["partial_commits"] == 1
            # the minority applied it; the majority holds nothing yet
            holders = sum(
                1
                for r in vc.replicas
                if (sv := r.store._get("pk")) is not None and sv.exists
            )
            assert holders >= 1
            assert holders < len(vc.replicas), "partial commit reached everyone?"
            honest = vc.client(timeout_s=2.0)
            elapsed = await _commit_with_retry(honest, "pk", b"good", 10.0)
            checker.record_ack("pk", b"good")
            assert elapsed < 10.0
            res = await honest.execute_read_transaction(
                TransactionBuilder().read("pk").build()
            )
            assert res.operations[0].value == b"good"
            await checker.final_check(honest)
            await checker.stop()
            assert checker.ok, checker.report()["violations"]

    run(main())


def test_seed_bias_contention_and_wedge_metric():
    """seed-bias: the attacker deterministically occupies the seed the
    honest client will draw next (both RNGs pinned), forcing a refusal on
    the first attempt; the honest retry's fresh seed escapes, the commit
    lands, and the store's wedge metric records the contention window."""

    async def main():
        import random

        with _knobs(ttl_ms=0.0, quota=128):
            async with VirtualCluster(4, rf=4) as vc:
                honest = vc.client(timeout_s=2.0)
                honest._rand = random.Random(42)
                first_seed = random.Random(42).randrange(1000)
                byz = vc.byzantine_client("seed-bias")
                await byz.acquire("sb", first_seed, value_hint=b"bias")
                await honest.execute_write_transaction(
                    TransactionBuilder().write("sb", b"good").build()
                )
                res = await honest.execute_read_transaction(
                    TransactionBuilder().read("sb").build()
                )
                assert res.operations[0].value == b"good"
                # the forced first-attempt collision opened (and the retry
                # closed) the wedge window on the key's replicas
                assert any(r.store.max_wedge_ms > 0 for r in vc.replicas)

    run(main())


def test_reclaim_invariant_rule_non_vacuous():
    """Invariant 4 must actually convict: fabricate a reclaimed-slot
    ledger entry — on a replica whose OWN grant sits inside the
    committed certificate (the rule's scope: only the reclaimer's grant
    reappearing under a different hash proves a double-grant) — and
    demand the checker fires."""

    async def main():
        async with VirtualCluster(4, rf=4) as vc:
            client = vc.client()
            await client.execute_write_transaction(
                TransactionBuilder().write("rv", b"v0").build()
            )
            checker = InvariantChecker(vc.replicas)
            checker.check_now()
            assert checker.ok
            holder = next(
                r
                for r in vc.replicas
                if (sv := r.store._get("rv")) is not None
                and sv.current_certificate is not None
            )
            cert = holder.store._get("rv").current_certificate
            # a replica that SIGNED the certificate fabricates the ledger
            replica = vc.replica(next(iter(cert.grants)))
            ts = holder.store._cert_ts(holder.store._get("rv"))
            assert ts is not None
            replica.store.reclaimed[("rv", ts)] = b"\x13" * 64
            checker.check_now()
            report = checker.report()
            assert not report["ok"]
            assert any("reclaimed slot" in v for v in report["violations"])
            # ...and the sound scope: a ledger entry on a replica whose
            # grant is NOT in the certificate convicts nobody (honest
            # cross-replica slot coexistence is legal)
            outsiders = [
                r for r in vc.replicas if r.server_id not in cert.grants
            ]
            if outsiders:
                checker2 = InvariantChecker(vc.replicas)
                outsiders[0].store.reclaimed[("rv", ts)] = b"\x17" * 64
                checker2.check_now()
                ok_violations = [
                    v
                    for v in checker2.report()["violations"]
                    if "reclaimed slot" in v and outsiders[0].server_id in v
                ]
                assert not ok_violations, ok_violations

    run(main())


# ------------------------------------------------ against the JAX package


def _attack_calls(pkg: str, strategy: str, seed: int, n: int = 48):
    """The first ``n`` attack primitives ``ByzantineClient.run`` issues for
    ``strategy`` and ``seed`` — (key, subEpoch seed, value hint) for
    ``acquire``, the seed range for ``wedge``, and the drawn seed for
    ``partial_write2`` — recorded in place of the network."""
    import importlib
    from types import SimpleNamespace

    B = importlib.import_module(f"{pkg}.testing.byzantine_client")
    byz = B.ByzantineClient(
        SimpleNamespace(timeout_s=1.0, client_id="byzclient-0123"), strategy, seed=seed
    )
    calls = []

    def note(call):
        calls.append(call)
        if len(calls) >= n:
            raise asyncio.CancelledError

    async def acquire(key, s, value_hint=b"withheld"):
        note(("acquire", key, s, value_hint))
        return {}

    async def wedge(key, seeds=None):
        note(("wedge", key, list(seeds)))
        return 0

    async def partial_write2(key, value, n_targets=1, seed=None):
        note(("partial-write2", key, value, n_targets, byz.rng.randrange(B.SEED_RANGE)))
        return False

    byz.acquire, byz.wedge, byz.partial_write2 = acquire, wedge, partial_write2

    async def drive():
        try:
            await byz.run(
                [f"hot-{i}" for i in range(5)], duration_s=60.0, interval_s=0.0,
                bias_range=16, wedge_seeds=8, hoard_extra=12,
            )
        except asyncio.CancelledError:
            pass

    asyncio.run(drive())
    return calls


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("strategy", ["seed-bias", "grant-hoard", "withhold", "partial-write2"])
def test_attack_sequences_equal_the_reference(strategy, seed):
    """seed-bias's colliding seeds and grant-hoard's per-key (crc32) seeds
    and key sweep, the wedge ranges and the partial-write2 seed stream:
    the same for a seed in both packages."""
    ours = _attack_calls("mochi_tpu_torch", strategy, seed)
    theirs = _attack_calls("mochi_tpu", strategy, seed)
    assert ours == theirs and len(ours) == 48
    if strategy == "seed-bias":
        assert {c[2] for c in ours} == set(range(10)), ours  # 48 calls: passes 0-9
    if strategy == "grant-hoard":
        assert any(c[1].startswith("hoard-byzclien") for c in ours)
