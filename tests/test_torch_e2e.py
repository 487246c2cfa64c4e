"""End-to-end tests: full cluster over loopback TCP, production client SDK.

Ports the reference's integration progression
(``MochiClientServerCommunicationTest.java``): hello plumbing, write→read
round trips (``:173-255``), delete lifecycle (``:257-348``), sequential
overwrites (``:350-416``), concurrent clients on shared keys (``:418-634``),
and the multi-client disjoint-key stress sweep (``:636-758``) — all in signed
mode (every envelope and MultiGrant Ed25519-signed and verified), which the
reference never had.
"""

import asyncio
import random

import pytest

from mochi_tpu_torch.client import InconsistentRead, TransactionBuilder
from mochi_tpu_torch.protocol import HelloToServer, HelloFromServer, Envelope
from mochi_tpu_torch.testing import VirtualCluster


def run(coro):
    asyncio.run(asyncio.wait_for(coro, timeout=60))


def test_hello_roundtrip():
    async def main():
        async with VirtualCluster(4, rf=4) as vc:
            client = vc.client()
            info = vc.config.servers["server-0"]
            env = client._envelope(HelloToServer("ping"), "m-1")
            resp = await client.pool.send_and_receive(info, env)
            assert isinstance(resp.payload, HelloFromServer)
            assert resp.payload.message == "ping back"

    run(main())


def test_write_then_read():
    async def main():
        async with VirtualCluster(5, rf=4) as vc:
            client = vc.client()
            txn = TransactionBuilder().write("greeting", b"hello world").build()
            result = await client.execute_write_transaction(txn)
            assert result.operations[0].value == b"hello world"

            read = await client.execute_read_transaction(
                TransactionBuilder().read("greeting").build()
            )
            assert read.operations[0].value == b"hello world"
            assert read.operations[0].existed
            # The read returns the write certificate established at commit
            # (ref: testReadOperation certificate assertions, :173-220).
            assert read.operations[0].current_certificate is not None
            assert len(read.operations[0].current_certificate.grants) >= vc.config.quorum

    run(main())


def test_read_missing_key():
    async def main():
        async with VirtualCluster(5, rf=4) as vc:
            client = vc.client()
            read = await client.execute_read_transaction(
                TransactionBuilder().read("never-written").build()
            )
            assert read.operations[0].value is None
            assert not read.operations[0].existed

    run(main())


def test_delete_lifecycle():
    async def main():
        async with VirtualCluster(5, rf=4) as vc:
            client = vc.client()
            await client.execute_write_transaction(
                TransactionBuilder().write("doomed", b"x").build()
            )
            read = await client.execute_read_transaction(
                TransactionBuilder().read("doomed").build()
            )
            assert read.operations[0].existed
            await client.execute_write_transaction(
                TransactionBuilder().delete("doomed").build()
            )
            read = await client.execute_read_transaction(
                TransactionBuilder().read("doomed").build()
            )
            assert not read.operations[0].existed and read.operations[0].value is None

    run(main())


def test_sequential_overwrites():
    async def main():
        async with VirtualCluster(5, rf=4) as vc:
            client = vc.client()
            for value in (b"v1", b"v2", b"v3"):
                await client.execute_write_transaction(
                    TransactionBuilder().write("counter", value).build()
                )
            read = await client.execute_read_transaction(
                TransactionBuilder().read("counter").build()
            )
            assert read.operations[0].value == b"v3"

    run(main())


def test_multikey_transaction():
    async def main():
        async with VirtualCluster(5, rf=4) as vc:
            client = vc.client()
            txn = (
                TransactionBuilder().write("mk-a", b"1").write("mk-b", b"2").build()
            )
            result = await client.execute_write_transaction(txn)
            assert [o.value for o in result.operations] == [b"1", b"2"]
            read = await client.execute_read_transaction(
                TransactionBuilder().read("mk-a").read("mk-b").build()
            )
            assert [o.value for o in read.operations] == [b"1", b"2"]

    run(main())


def test_concurrent_clients_shared_keys():
    # ref: testWriteOperationConcurrent (:418-634) — interleavings are legal;
    # the invariant is that the final value is one of the written ones and all
    # replicas agree at read quorum.
    async def main():
        async with VirtualCluster(5, rf=4) as vc:
            clients = [vc.client() for _ in range(5)]

            async def worker(client, idx):
                for round_no in range(3):
                    await client.execute_write_transaction(
                        TransactionBuilder()
                        .write("shared", f"client{idx}round{round_no}".encode())
                        .build()
                    )

            await asyncio.gather(*(worker(c, i) for i, c in enumerate(clients)))
            read = await clients[0].execute_read_transaction(
                TransactionBuilder().read("shared").build()
            )
            assert read.operations[0].value is not None
            value = read.operations[0].value.decode()
            assert value.startswith("client") and "round" in value

    run(main())


def test_stress_disjoint_keys():
    # ref: testWriteOperationConcurrentStressTest (:636-758) — N clients ×
    # disjoint keys, shuffled write → read-verify → delete sweep.  Scaled-down
    # key count to keep CI fast; the bench harness runs the full shape.
    async def main():
        async with VirtualCluster(5, rf=4) as vc:
            clients = [vc.client() for _ in range(3)]

            async def worker(client, idx):
                keys = [f"stress-{idx}-{k}" for k in range(8)]
                random.Random(idx).shuffle(keys)
                for key in keys:
                    await client.execute_write_transaction(
                        TransactionBuilder().write(key, f"val-{key}".encode()).build()
                    )
                for key in keys:
                    read = await client.execute_read_transaction(
                        TransactionBuilder().read(key).build()
                    )
                    assert read.operations[0].value == f"val-{key}".encode()
                for key in keys:
                    await client.execute_write_transaction(
                        TransactionBuilder().delete(key).build()
                    )
                for key in keys:
                    read = await client.execute_read_transaction(
                        TransactionBuilder().read(key).build()
                    )
                    assert not read.operations[0].existed

            await asyncio.gather(*(worker(c, i) for i, c in enumerate(clients)))

    run(main())


def test_metrics_recorded():
    async def main():
        async with VirtualCluster(5, rf=4) as vc:
            client = vc.client()
            await client.execute_write_transaction(
                TransactionBuilder().write("m", b"1").build()
            )
            await client.execute_read_transaction(TransactionBuilder().read("m").build())
            snap = client.metrics.snapshot()
            assert snap["timers"]["write-transactions"]["count"] == 1
            assert snap["timers"]["read-transactions"]["count"] == 1
            server_snap = vc.replicas[0].metrics.snapshot()
            assert server_snap["timers"]["replica.write1"]["count"] >= 1

    run(main())


def test_quorum_targets_cover_every_key():
    """The trimmed read fan-out must give every key >= quorum members of its
    own replica set, never exceed the union, and rotate across calls."""
    from mochi_tpu_torch.client import MochiDBClient
    from mochi_tpu_torch.client.txn import TransactionBuilder
    from mochi_tpu_torch.cluster.config import ClusterConfig

    cfg = ClusterConfig.build(
        {f"server-{i}": f"127.0.0.1:{9300 + i}" for i in range(7)}, rf=4
    )
    client = MochiDBClient(cfg)
    tb = TransactionBuilder()
    for i in range(6):
        tb.read(f"qt-key-{i}")
    txn = tb.build()
    full = dict(client._targets(txn))
    picks = set()
    for _ in range(8):
        chosen = dict(client._quorum_targets(txn))
        assert set(chosen) <= set(full)
        for op in txn.operations:
            rset = {s.server_id for s in cfg.servers_for_key(op.key)}
            assert len(rset & set(chosen)) >= cfg.quorum, op.key
        picks.add(tuple(sorted(chosen)))
    # single-key: exactly quorum-many targets, and the rotor varies them
    single = TransactionBuilder().read("qt-single").build()
    sizes = set()
    singles = set()
    for _ in range(8):
        chosen = client._quorum_targets(single)
        sizes.add(len(chosen))
        singles.add(tuple(sorted(sid for sid, _ in chosen)))
    assert sizes == {cfg.quorum}
    assert len(singles) > 1, "rotor never varied the chosen quorum"


def test_large_values_round_trip():
    """Values up to the MB range ride the normal 2-phase path (frames cap
    at 64 MiB); the acknowledged bytes must come back identical."""
    import os as _os

    async def main():
        async with VirtualCluster(5, rf=4) as vc:
            client = vc.client()
            for size in (64 * 1024, 1024 * 1024):
                blob = _os.urandom(size)
                key = f"big-{size}"
                await client.execute_write_transaction(
                    TransactionBuilder().write(key, blob).build()
                )
                res = await client.execute_read_transaction(
                    TransactionBuilder().read(key).build()
                )
                assert res.operations[0].value == blob, size
            await client.close()

    run(main())


def test_trimmed_read_falls_back_when_chosen_replica_is_stale():
    """Force the quorum-sized read fan-out to include a replica that
    silently lost the key: the trimmed tally (2 of 3) must fail closed and
    the full-union fallback must still return the committed value."""

    async def main():
        async with VirtualCluster(4, rf=4) as vc:
            client = vc.client()
            await client.execute_write_transaction(
                TransactionBuilder().write("tr-key", b"val").build()
            )
            # wipe the key from one in-set replica (simulated silent loss)
            stale = vc.replicas[0]
            stale.store.data.pop("tr-key", None)

            # steer the rotor so the trimmed subset includes the stale
            # replica (rotor increments before use inside _quorum_targets)
            from mochi_tpu_torch.client.txn import TransactionBuilder as TB

            txn = TB().read("tr-key").build()
            for rotor in range(4):
                client._read_rotor = rotor - 1
                chosen = {sid for sid, _ in client._quorum_targets(txn)}
                if stale.server_id in chosen:
                    client._read_rotor = rotor - 1
                    break
            else:
                raise AssertionError("rotor never selected the stale replica")

            before = client.metrics.timers["read-transactions"].count
            res = await client.execute_read_transaction(txn)
            assert res.operations[0].value == b"val"
            # the trimmed attempt and the full-union fallback each count
            assert client.metrics.timers["read-transactions"].count - before == 2
            await client.close()

    run(main())


def test_committed_values_and_certificate_signers_equal_the_reference():
    """The same seeded writes against the port's cluster and the
    reference's, each of 4 replicas with server-3 closed (so the quorum of
    3 is the 3 that answer): every key reads back the same committed value
    in both, under a certificate with the same signer set."""
    from mochi_tpu.client import TransactionBuilder as RefBuilder
    from mochi_tpu.testing import VirtualCluster as RefCluster

    rng = random.Random(2026)
    writes = [(f"d-{rng.randrange(6)}", b"v%d-" % i + rng.randbytes(8)) for i in range(10)]

    async def drive(cluster_cls, builder):
        async with cluster_cls(4, rf=4) as vc:
            await vc.replicas[3].close()
            client = vc.client(timeout_s=30.0)
            for key, value in writes:
                await client.execute_write_transaction(builder().write(key, value).build())
            out = {}
            for key in sorted({k for k, _ in writes}):
                res = await client.execute_read_transaction(builder().read(key).build())
                op = res.operations[0]
                out[key] = (op.value, sorted(op.current_certificate.grants))
            await client.close()
            return out

    async def main():
        mine = await drive(VirtualCluster, TransactionBuilder)
        theirs = await drive(RefCluster, RefBuilder)
        assert mine == theirs
        assert all(signers == ["server-0", "server-1", "server-2"] for _, signers in mine.values())
        assert {k: v for k, (v, _) in mine.items()} == dict(writes)

    run(main())
