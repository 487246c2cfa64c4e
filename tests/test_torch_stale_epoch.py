"""Stale-epoch replay regression tests at the store seam: a replica restarted WITHOUT resync (``restart_replica(
resync=False)`` — epochs reset to 0, state empty) must never let a
replayed old certificate overwrite a newer commit CLUSTER-WIDE, and its
reset-epoch grants must never help a stale-timestamp quorum form.

These tests PIN current behavior precisely, including its honest limit:
the restarted replica itself — state empty, epochs 0 — will locally accept
a replayed stale-but-valid certificate (it has nothing newer to compare
against; storage is in-memory as in the reference).  That blast radius is
<= f by the fault model, the quorum outvotes it on every read, and resync
repairs it; what would be a BUG is any of the three cluster-level
assertions below failing.
"""

import asyncio

from mochi_tpu_torch.client import TransactionBuilder
from mochi_tpu_torch.protocol import (
    Write2AnsFromServer,
    Write2ToServer,
)
from mochi_tpu_torch.testing import VirtualCluster


def run(coro):
    asyncio.run(asyncio.wait_for(coro, timeout=120))


async def _commit_and_capture(client, key: str, value: bytes):
    """Commit one write and return (transaction, committed certificate) —
    the certificate rides the quorum read's OperationResult."""
    txn = TransactionBuilder().write(key, value).build()
    await client.execute_write_transaction(txn)
    res = await client.execute_read_transaction(
        TransactionBuilder().read(key).build()
    )
    cert = res.operations[0].current_certificate
    assert cert is not None
    return txn, cert


def test_stale_cert_replay_rejected_by_staleness_check():
    """Store seam, no restart: a replica holding the NEWER commit answers
    a replayed older certificate with current state — nothing regresses."""

    async def main():
        async with VirtualCluster(4, rf=4) as vc:
            client = vc.client()
            txn1, cert1 = await _commit_and_capture(client, "se", b"old")
            txn2, cert2 = await _commit_and_capture(client, "se", b"new")

            replica = vc.replicas[0]
            sv = replica.store._get("se")
            epoch_before = sv.current_epoch
            response = replica.store.process_write2(Write2ToServer(cert1, txn1))
            # stale write2: answered with CURRENT state, not applied
            # (ref: InMemoryDataStore.java:594-598)
            assert isinstance(response, Write2AnsFromServer)
            assert response.result.operations[0].value == b"new"
            sv = replica.store._get("se")
            assert sv.value == b"new"
            assert sv.current_epoch == epoch_before

    run(main())


def test_replay_after_reset_restart_cannot_overwrite_cluster():
    """restart_replica(resync=False) resets epochs to 0; replaying the old
    certificate at the restarted replica rewinds only ITSELF (pinned — the
    <= f blast radius), the quorum read still returns the newer value, and
    resync repairs the replica to the newer commit, after which the replay
    bounces off the staleness check like anywhere else."""

    async def main():
        async with VirtualCluster(5, rf=4) as vc:
            client = vc.client()
            txn1, cert1 = await _commit_and_capture(client, "rs", b"old")
            txn2, cert2 = await _commit_and_capture(client, "rs", b"new")

            victims = [sid for sid in sorted(vc.config.servers)
                       if vc.replica(sid).store.owns("rs")]
            victim = victims[0]
            fresh = await vc.restart_replica(victim, resync=False)
            assert fresh.store._get("rs") is None  # empty, epochs reset

            # Replay the OLD (validly signed) certificate straight at the
            # restarted replica: with no local state it applies — the
            # pinned current behavior this test documents.
            resp = await fresh.handle_envelope(
                client._envelope(Write2ToServer(cert1, txn1), "replay-1")
            )
            assert isinstance(resp.payload, Write2AnsFromServer)
            assert fresh.store._get("rs").value == b"old"

            # Cluster-level safety: the quorum outvotes the rewound member.
            res = await client.execute_read_transaction(
                TransactionBuilder().read("rs").build()
            )
            assert res.operations[0].value == b"new"

            # Repair: resync pulls the newer commit from peers...
            await fresh.resync()
            assert fresh.store._get("rs").value == b"new"
            # ...and the replayed certificate now bounces off staleness.
            resp = await fresh.handle_envelope(
                client._envelope(Write2ToServer(cert1, txn1), "replay-2")
            )
            assert isinstance(resp.payload, Write2AnsFromServer)
            assert resp.payload.result.operations[0].value == b"new"
            assert fresh.store._get("rs").value == b"new"

    run(main())


def test_reset_epoch_grants_cannot_anchor_a_stale_quorum():
    """After a reset restart the replica issues grants at epoch-0
    timestamps while the honest majority grants at advanced epochs: the
    client's timestamp-consistent subset can never include the stale
    grant in a 2f+1 quorum, so writes keep committing at FRESH timestamps
    and the committed value stays readable everywhere."""

    async def main():
        async with VirtualCluster(5, rf=4) as vc:
            client = vc.client()
            # advance epochs on the key's replica set
            for i in range(3):
                await client.execute_write_transaction(
                    TransactionBuilder().write("eg", b"w%d" % i).build()
                )
            victims = [sid for sid in sorted(vc.config.servers)
                       if vc.replica(sid).store.owns("eg")]
            await vc.restart_replica(victims[0], resync=False)

            # the next write must still commit — the reset-epoch grant is
            # a timestamp outlier the subset drops (up to f outliers are
            # budgeted by 3f+1)
            await client.execute_write_transaction(
                TransactionBuilder().write("eg", b"final").build()
            )
            res = await client.execute_read_transaction(
                TransactionBuilder().read("eg").build()
            )
            assert res.operations[0].value == b"final"
            # every honest (non-restarted) in-set replica holds the commit
            # at a non-reset epoch
            for sid in victims[1:]:
                sv = vc.replica(sid).store._get("eg")
                assert sv is not None and sv.value == b"final"
                assert sv.current_epoch >= 2000

    run(main())


def test_stale_replay_answers_equal_the_reference():
    """Two commits captured from the port's cluster, then applied to the
    port's stores and the reference's in order, and the older certificate
    replayed: every answer (the replay's with the current state, not
    applied) encodes to the same bytes in both packages."""
    from tests.torch_crosswire import PairedStores

    async def main():
        async with VirtualCluster(4, rf=4) as vc:
            client = vc.client()
            old = await _commit_and_capture(client, "se", b"old")
            new = await _commit_and_capture(client, "se", b"new")
        st = PairedStores()
        for txn, cert in (old, new):
            st.both("process_write2", Write2ToServer(cert, txn))
        replay = st.both("process_write2", Write2ToServer(old[1], old[0]))
        assert all(isinstance(r, Write2AnsFromServer) and r.result.operations[0].value == b"new" for r in replay)

    run(main())
