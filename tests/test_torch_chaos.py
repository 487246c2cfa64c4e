"""Chaos scenarios on the port (``mochi_tpu_torch``), on the CPU.

Ported from the JAX package's ``tests/test_chaos.py``: concurrent traffic
through a replica restart and a live reconfiguration, early-quorum commits
bounded by the quorum rather than a +200 ms straggler, acked writes
surviving a lossy WAN with a partition and heal, a slow honest client
surviving a grant-reclaim race, and a Byzantine adversary under loss.
Every cluster runs the CPU verifier.
"""

from __future__ import annotations

import asyncio

from mochi_tpu_torch.client.txn import TransactionBuilder
from mochi_tpu_torch.netsim import LinkEvent, LinkSpec, NetSim
from mochi_tpu_torch.testing.virtual_cluster import VirtualCluster


def run(coro):
    asyncio.run(coro)


def test_traffic_survives_restart_plus_reconfig():
    async def main():
        async with VirtualCluster(6, rf=4) as vc:
            committed: dict = {}
            stop = asyncio.Event()
            errors: list = []

            async def writer(ci: int):
                client = vc.client()
                i = 0
                while not stop.is_set():
                    key = f"chaos-{ci}-{i}"
                    val = b"v%d" % i
                    try:
                        await client.execute_write_transaction(
                            TransactionBuilder().write(key, val).build()
                        )
                        committed[key] = val
                    except Exception as exc:
                        # During the chaos window an individual txn may be
                        # refused (retryable); losing an ACKED write is the
                        # only real failure, checked below.
                        errors.append((key, repr(exc)))
                    i += 1
                    await asyncio.sleep(0)
                await client.close()

            writers = [asyncio.create_task(writer(i)) for i in range(5)]
            await asyncio.sleep(0.3)

            # restart one replica empty, with resync-on-boot
            await vc.restart_replica("server-2", resync=True)

            await asyncio.sleep(0.2)

            # live reconfiguration: drop the LAST server (ring shrinks,
            # keys migrate) while traffic continues
            admin = vc.client()
            servers = {
                sid: f"{info.host}:{info.port}"
                for sid, info in vc.config.servers.items()
                if sid != "server-5"
            }
            new_cfg = vc.config.evolve(servers)
            await admin.reconfigure_cluster(new_cfg)

            await asyncio.sleep(0.3)
            stop.set()
            await asyncio.gather(*writers)

            assert committed, "no write ever committed"
            # every acknowledged write must be readable under the new config
            reader = vc.client()
            for key, val in committed.items():
                res = await reader.execute_read_transaction(
                    TransactionBuilder().read(key).build()
                )
                assert res.operations[0].value == val, key
            await reader.close()
            await admin.close()
            # the run must have made real progress through the chaos window
            assert len(committed) >= 20, (len(committed), errors[:5])

    run(main())


def test_early_quorum_commit_bounded_by_quorum_not_straggler():
    """The early-quorum pin: one replica of the write set pinned at +200 ms
    must not gate commits — the early-quorum write path waits for the
    2f+1st consistent verified answer, not the slowest replica.  The
    straggler still APPLIES every acked write (Write2 went to the full
    set; only the client's wait is quorum-bound), so after its links heal
    the acked values are present locally and readable cluster-wide, and
    the left-behind responses show up in the straggler metrics instead of
    vanishing."""

    async def main():
        sim = NetSim.mesh(seed=21, rtt_ms=13.0, jitter_ms=1.0)
        async with VirtualCluster(5, rf=4, netsim=sim) as vc:
            client = vc.client()
            # establish sessions before degrading anything
            await client.execute_write_transaction(
                TransactionBuilder().write("straggle-warm", b"w").build()
            )
            # pick a key whose replica set includes the straggler
            key = next(
                f"straggle-{i}"
                for i in range(64)
                if "server-3" in vc.config.replica_set_for_key(f"straggle-{i}")
            )
            # degrade server-3 both ways: ~+200 ms RTT on top of the mesh
            for src, dst in (("*", "server-3"), ("server-3", "*")):
                sim.apply_event(
                    LinkEvent(0.0, "set", src, dst,
                              LinkSpec(delay_ms=106.5, jitter_ms=0.5))
                )
            lat_ms = []
            for i in range(8):
                t0 = asyncio.get_running_loop().time()
                await client.execute_write_transaction(
                    TransactionBuilder().write(key, b"v%d" % i).build()
                )
                lat_ms.append((asyncio.get_running_loop().time() - t0) * 1e3)
            lat_ms.sort()
            # quorum-bound: median far below the straggler's ~213 ms RTT
            # (generous margin for this host's scheduler noise)
            assert lat_ms[len(lat_ms) // 2] < 150.0, lat_ms
            # stragglers were drained, not dropped: their late answers fed
            # the per-replica metrics
            counters = client.metrics.counters
            assert counters.get("fanout.early-return", 0) > 0, counters
            late = sum(
                n for name, n in counters.items()
                if name.startswith("fanout.late-response.")
            )
            timed_out = sum(
                n for name, n in counters.items()
                if name.startswith("fanout.straggler-timeout.")
            )
            assert late + timed_out > 0, counters
            assert any(
                name.startswith("fanout-straggler-ms.")
                for name in client.metrics.histograms
            ) or late == 0
            # heal, let the in-flight Write2 + responses land
            sim.apply_event(
                LinkEvent(0.0, "set", "*", "*",
                          LinkSpec(delay_ms=6.5, jitter_ms=0.5))
            )
            await asyncio.sleep(0.6)
            # the acked write reached the straggler's own store
            sv = vc.replica("server-3").store._get(key)
            assert sv is not None and sv.exists and bytes(sv.value) == b"v7"
            # ...and is readable cluster-wide after heal
            res = await client.execute_read_transaction(
                TransactionBuilder().read(key).build()
            )
            assert res.operations[0].value == b"v7"

    run(asyncio.wait_for(main(), timeout=120))


def test_acked_writes_survive_lossy_wan_partition_heal():
    """The restart+reconfig scenario above runs on a perfect loopback; real
    deployments lose the acked-write guarantee (or don't) under loss and
    partitions.  Same invariant, WAN-shaped: a 13 ms ± 1 ms lossy mesh
    (2% frame drop), one replica partitioned mid-traffic and healed — every
    write acked through that window must be readable after the heal (the
    client's nudge+resync recovery carries the healed replica back)."""

    async def main():
        sim = NetSim.mesh(
            seed=13,
            rtt_ms=13.0,
            jitter_ms=1.0,
            drop=0.02,
            schedule=NetSim.partition("server-1", at_s=0.6, heal_at_s=1.4),
        )
        async with VirtualCluster(5, rf=4, netsim=sim) as vc:
            committed: dict = {}
            errors: list = []
            stop = asyncio.Event()

            async def writer(ci: int):
                # Tight timeout: a dropped frame must cost 0.4 s, not the
                # 10 s default — the retry loop is the loss recovery.
                client = vc.client(timeout_s=0.4, write_attempts=12)
                i = 0
                while not stop.is_set():
                    key = f"wan-{ci}-{i}"
                    val = b"v%d" % i
                    try:
                        await client.execute_write_transaction(
                            TransactionBuilder().write(key, val).build()
                        )
                        committed[key] = val
                    except Exception as exc:
                        errors.append((key, repr(exc)))
                    i += 1
                    await asyncio.sleep(0)
                await client.close()

            writers = [asyncio.create_task(writer(i)) for i in range(4)]
            await asyncio.sleep(2.0)  # spans partition (0.6 s) + heal (1.4 s)
            stop.set()
            await asyncio.gather(*writers)

            assert committed, "no write ever committed through the WAN chaos"
            assert len(committed) >= 8, (len(committed), errors[:5])
            totals = sim.totals()
            assert totals["dropped"] > 0, "lossy mesh never dropped a frame"
            assert totals["delayed"] > 0

            # The durability invariant is about the DATA, not about any
            # single RPC surviving ongoing 2% loss: stop the loss
            # injection for the readback (links stay at WAN delay), and
            # allow one app-level retry — a lossy WAN legitimately fails
            # individual calls even after the client's internal ladder.
            sim.apply_event(
                LinkEvent(0.0, "set", "*", "*",
                          LinkSpec(delay_ms=6.5, jitter_ms=0.5))
            )
            reader = vc.client(timeout_s=2.0)
            for key, val in committed.items():
                try:
                    res = await reader.execute_read_transaction(
                        TransactionBuilder().read(key).build()
                    )
                except Exception:
                    await asyncio.sleep(0.3)  # resync still settling
                    res = await reader.execute_read_transaction(
                        TransactionBuilder().read(key).build()
                    )
                assert res.operations[0].value == val, key
            await reader.close()

    run(asyncio.wait_for(main(), timeout=240))


def test_slow_honest_client_survives_grant_reclaim_race():
    """Regression: grant-TTL reclamation must never cost a
    merely-SLOW honest client its write.  The client acquires its full
    grant set, then stalls past the TTL mid-Write2 (a WAN-delayed or
    GC-paused coordinator); a contender's conflicting Write1 reclaims the
    now-aged slots.  When the slow client's Write2 finally lands, it must
    still apply — the certificate is self-certifying; reclamation only
    touches the grant book — and the reclaimed-slot invariant must hold
    (the committed certificate IS the original grantee's)."""
    from mochi_tpu_torch.protocol import (
        Write1OkFromServer,
        Write1ToServer,
        WriteCertificate,
        transaction_hash,
    )
    from mochi_tpu_torch.server import store as store_mod
    from mochi_tpu_torch.testing.invariants import InvariantChecker

    async def main():
        saved = store_mod.GRANT_TTL_MS
        store_mod.GRANT_TTL_MS = 200.0
        try:
            sim = NetSim.mesh(seed=5, rtt_ms=4.0, jitter_ms=0.5)
            async with VirtualCluster(4, rf=4, netsim=sim) as vc:
                slow = vc.client(timeout_s=2.0)
                key = "slowk"
                txn = TransactionBuilder().write(key, b"slow-v").build()
                txn_hash = transaction_hash(txn)
                write1_txn = slow._write1_transaction(txn)
                seed = 123
                w1 = Write1ToServer(slow.client_id, write1_txn, seed, txn_hash)
                responses = await slow._fan_out(write1_txn, lambda: w1)
                oks = [
                    p.multi_grant
                    for p in responses.values()
                    if isinstance(p, Write1OkFromServer)
                    and slow._grant_ok(p.multi_grant, txn_hash)
                ]
                chosen = slow._quorum_grant_subset(txn, oks)
                assert chosen is not None
                certificate = WriteCertificate(
                    {mg.server_id: mg for mg in chosen}
                )
                # ...the coordinator stalls past the TTL mid-write...
                await asyncio.sleep(0.35)
                # ...while a contender's conflicting Write1 (same slot)
                # triggers reclamation of the aged grants
                contender = vc.byzantine_client("withhold")
                await contender.acquire(key, seed)
                assert sum(r.store.reclaims for r in vc.replicas) > 0, (
                    "the race never happened — nothing was reclaimed"
                )
                # the slow client's Write2 lands AFTER its grants were
                # reclaimed: reclaim races resolve toward the certificate
                result = await slow._write2(txn, certificate)
                assert result.operations[0].status.name == "OK"
                res = await slow.execute_read_transaction(
                    TransactionBuilder().read(key).build()
                )
                assert res.operations[0].value == b"slow-v"
                checker = InvariantChecker(vc.replicas)
                checker.record_ack(key, b"slow-v")
                checker.check_now()
                await checker.final_check(slow)
                assert checker.ok, checker.report()["violations"]
        finally:
            store_mod.GRANT_TTL_MS = saved

    run(asyncio.wait_for(main(), timeout=120))


def test_byzantine_adversary_under_loss_invariants_and_acked_writes_hold():
    """A live adversary AND 2% frame loss together — the storm strategy's refusal
    floods now compound with genuine retransmission retries.  Safety must
    not depend on a clean network: the invariant checker samples the
    honest stores throughout and every acked write reads back after the
    storm."""
    from mochi_tpu_torch.testing.invariants import InvariantChecker

    async def main():
        sim = NetSim.mesh(seed=21, rtt_ms=13.0, jitter_ms=1.0, drop=0.02)
        async with VirtualCluster(
            5, rf=4, netsim=sim, byzantine={"server-1": "storm"}
        ) as vc:
            checker = InvariantChecker(vc.honest_replicas(), ["server-1"])
            checker.start(0.05)
            committed: dict = {}
            errors: list = []
            clients = [
                vc.client(timeout_s=0.4, write_attempts=12) for _ in range(3)
            ]

            async def writer(ci: int):
                client = clients[ci]
                for i in range(6):
                    key = f"byzloss-{ci}-{i}"
                    val = b"v%d" % i
                    try:
                        await client.execute_write_transaction(
                            TransactionBuilder().write(key, val).build()
                        )
                        committed[key] = val
                        checker.record_ack(key, val)
                    except Exception as exc:
                        # liveness may degrade under adversary+loss;
                        # counted, and safety is checked below
                        errors.append((key, repr(exc)))

            await asyncio.gather(*(writer(i) for i in range(3)))
            assert committed, f"nothing committed: {errors[:5]}"
            totals = sim.totals()
            assert totals["dropped"] > 0, "lossy mesh never dropped a frame"

            # loss off (WAN delay stays) for the durability readback: the
            # invariant is about the data surviving, not one RPC beating
            # ongoing 2% loss on its first try
            sim.apply_event(
                LinkEvent(0.0, "set", "*", "*",
                          LinkSpec(delay_ms=6.5, jitter_ms=0.5))
            )
            await checker.stop()
            await checker.final_check(clients[0])
            report = checker.report()
            assert report["ok"], report["violations"]
            assert report["acked_writes"] >= len(committed)

    run(asyncio.wait_for(main(), timeout=240))
