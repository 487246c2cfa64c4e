"""State-transfer / UptoSpeed resync tests.

The failure these guard: replica state is in-memory (as in the reference), so
a restarted replica rejoins with epoch 0 for every key; its Write1 grants can
then never match the surviving quorum's timestamps and writes to warm keys
refuse forever.  The reference paper declares a client-initiated "UptoSpeed"
recovery (``mochiDB.tex:168-169``) but never implemented it; here it exists
in both flavors: explicit pull (``MochiReplica.resync``) and client-nudged
background sync on timestamp-split retries.
"""

import asyncio
from dataclasses import replace

from mochi_tpu_torch.client import TransactionBuilder
from mochi_tpu_torch.protocol import Grant, MultiGrant, SyncEntry, WriteCertificate
from mochi_tpu_torch.testing import VirtualCluster


def run(coro):
    asyncio.run(asyncio.wait_for(coro, timeout=120))


def test_restart_then_explicit_resync_recovers_writes():
    async def main():
        async with VirtualCluster(4, rf=4) as vc:
            client = vc.client()
            await client.execute_write_transaction(
                TransactionBuilder().write("warm", b"v1").build()
            )
            # two restarts: beyond f=1, writes to the warm key cannot reach a
            # timestamp-consistent quorum until the replicas resync
            r1 = await vc.restart_replica("server-0")
            r2 = await vc.restart_replica("server-1")
            assert r1.store.stats()["keys"] == 0

            advanced = await r1.resync()
            assert advanced >= 1
            advanced = await r2.resync()
            assert advanced >= 1

            # epochs and certificates are back: a fresh write converges
            await client.execute_write_transaction(
                TransactionBuilder().write("warm", b"v2").build()
            )
            res = await client.execute_read_transaction(
                TransactionBuilder().read("warm").build()
            )
            assert res.operations[0].value == b"v2"
            # recovered replica serves the certified value locally too
            sv = r1.store.data.get("warm")
            assert sv is not None and sv.current_certificate is not None

    run(main())


def test_client_nudge_triggers_background_resync():
    async def main():
        async with VirtualCluster(4, rf=4) as vc:
            client = vc.client(refusal_retries=12, write_attempts=24)
            await client.execute_write_transaction(
                TransactionBuilder().write("hotkey", b"a").build()
            )
            # advance the epoch so laggards are >= one epoch behind
            await client.execute_write_transaction(
                TransactionBuilder().write("hotkey", b"b").build()
            )
            await vc.restart_replica("server-2")
            # no explicit resync: the write retry loop must detect the
            # timestamp split, nudge, and eventually converge
            await client.execute_write_transaction(
                TransactionBuilder().write("hotkey", b"c").build()
            )
            res = await client.execute_read_transaction(
                TransactionBuilder().read("hotkey").build()
            )
            assert res.operations[0].value == b"c"

    run(main())


def test_resync_rejects_forged_entries():
    async def main():
        async with VirtualCluster(4, rf=4) as vc:
            client = vc.client()
            await client.execute_write_transaction(
                TransactionBuilder().write("truth", b"honest").build()
            )
            victim = await vc.restart_replica("server-0")

            # Byzantine peer hands the recovering replica a forged entry:
            # right shape, no valid quorum signatures
            honest = vc.replica("server-1")
            [entry] = honest.store.export_sync_entries(["truth"])
            forged_grants = {}
            for sid, mg in entry.certificate.grants.items():
                forged_grants[sid] = replace(mg, signature=b"\x00" * 64)
            forged = SyncEntry(
                "truth", entry.transaction, WriteCertificate(forged_grants)
            )
            checked = await victim._check_certificate(forged.certificate)
            assert checked is None  # all grants dropped -> nothing to apply

            # the real entry, by contrast, applies cleanly
            checked = await victim._check_certificate(entry.certificate)
            assert checked is not None
            assert victim.store.apply_sync_entry(
                replace(entry, certificate=checked)
            )
            assert victim.store.data["truth"].value == b"honest"

    run(main())


def test_sync_request_served_only_for_owned_committed_keys():
    async def main():
        async with VirtualCluster(4, rf=4) as vc:
            client = vc.client()
            await client.execute_write_transaction(
                TransactionBuilder().write("k1", b"x").write("k2", b"y").build()
            )
            replica = vc.replica("server-3")
            entries = replica.store.export_sync_entries()
            keys = {e.key for e in entries}
            assert {"k1", "k2"} <= keys
            for e in entries:
                assert e.certificate.grants  # every entry carries its proof
                assert any(op.key == e.key for op in e.transaction.operations)
            # unknown keys produce nothing
            assert replica.store.export_sync_entries(["nope"]) == []

    run(main())


def test_read_quorum_failure_recovers_via_client_nudge():
    """Two replicas of a key's set restart EMPTY (no --resync-on-boot):
    the remaining holders can no longer outvote them, so the first read
    attempt quorum-fails — the client must nudge the set to resync and
    retry, returning the committed value instead of InconsistentRead
    (found live in verification; reads once never nudged)."""

    async def main():
        async with VirtualCluster(4, rf=4) as vc:
            client = vc.client()
            await client.execute_write_transaction(
                TransactionBuilder().write("warm", b"v1").build()
            )
            r1 = await vc.restart_replica("server-0")
            r2 = await vc.restart_replica("server-1")
            assert r1.store.stats()["keys"] == 0
            assert r2.store.stats()["keys"] == 0
            # no explicit resync, no write-side nudge: the READ must recover
            res = await client.execute_read_transaction(
                TransactionBuilder().read("warm").build()
            )
            assert res.operations[0].value == b"v1"

    run(main())


def test_sync_entries_and_their_application_equal_the_reference():
    """Entries exported by a replica of the port's cluster, a forged copy
    beside each, applied to the port's stores and the reference's (carried
    over the wire): the same entries advance state, the forged ones are
    refused, and the stores then export the same entries."""
    from mochi_tpu import protocol as ref_protocol
    from mochi_tpu_torch.protocol import SyncEntriesFromServer
    from tests.torch_crosswire import PairedStores, to_reference

    async def main():
        async with VirtualCluster(4, rf=4) as vc:
            client = vc.client()
            for i in range(4):
                await client.execute_write_transaction(
                    TransactionBuilder().write(f"rs-{i}", b"v%d" % i).write("rs-shared", b"s%d" % i).build()
                )
            return vc.replica("server-1").store.export_sync_entries()

    entries = asyncio.run(asyncio.wait_for(main(), 120))
    forged = []
    for e in entries:
        grants = dict(e.certificate.grants)
        sid, mg = next(iter(grants.items()))
        g = mg.grants[e.key]
        grants[sid] = replace(mg, grants={**mg.grants, e.key: replace(g, transaction_hash=b"\x00" * 64)})
        forged.append(replace(e, certificate=WriteCertificate(grants)))
    st = PairedStores()
    for entry in entries[:1] + forged + entries:
        ref_entry = to_reference(SyncEntriesFromServer((entry,))).entries[0]
        assert isinstance(ref_entry, ref_protocol.SyncEntry)
        outs = [(a.apply_sync_entry(entry), b.apply_sync_entry(ref_entry)) for a, b in zip(st.mine, st.theirs)]
        assert all(x == y for x, y in outs), outs
    assert len(st.sync_entries()[0].entries) == len(entries) == 5
