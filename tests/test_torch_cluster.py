"""The port's signed-write path: replica, store, admission, client and
``VirtualCluster`` against the JAX package's.

The same scripted run (write, read, multi-key write, overwrite, delete)
goes through the port's cluster and the reference's, and both must commit
the same values with certificates of the same size.  A 16-replica cluster
over ``CudaBatchVerifier(device="cpu")`` (the kernels' plain versions) must
carry its grant signatures on the comb path, and a port client must commit
against reference replicas.
"""

import asyncio

import pytest

from mochi_tpu.client import TransactionBuilder as JTxn
from mochi_tpu.testing import VirtualCluster as JCluster
from mochi_tpu_torch.client import MochiDBClient, TransactionBuilder
from mochi_tpu_torch.cluster.config import ClusterConfig
from mochi_tpu_torch.crypto import batch_verify as BV
from mochi_tpu_torch.testing import ProcessCluster, VirtualCluster
from mochi_tpu_torch.verifier.cuda import CudaBatchVerifier
from mochi_tpu_torch.verifier.spi import verifier_stats


# The SDK request timeout for a cluster whose replicas verify on the plain
# PyTorch versions (see the 16-replica test).
PLAIN_PATH_TIMEOUT_S = 240.0


def run(coro, timeout=300):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _script(tb):
    """The scripted transactions: (kind, transaction)."""
    return [
        ("w", tb().write("alpha", b"one").build()),
        ("r", tb().read("alpha").build()),
        ("w", tb().write("beta", b"two").write("gamma", b"three").build()),
        ("w", tb().write("alpha", b"uno").build()),
        ("w", tb().delete("beta").build()),
        ("r", tb().read("alpha").read("beta").read("gamma").build()),
    ]


def _outcome(res):
    return [
        (op.value, op.existed, len(op.current_certificate.grants) if op.current_certificate else 0)
        for op in res.operations
    ]


async def _drive(cluster, tb):
    async with cluster as vc:
        client = vc.client()
        out = []
        for kind, txn in _script(tb):
            if kind == "w":
                res = await client.execute_write_transaction(txn)
            else:
                res = await client.execute_read_transaction(txn)
            out.append((kind, _outcome(res)))
        return out, vc.config.quorum


def test_scripted_run_commits_what_the_reference_commits():
    mine, q_mine = run(_drive(VirtualCluster(5, rf=4), TransactionBuilder))
    ref, q_ref = run(_drive(JCluster(5, rf=4), JTxn))
    assert mine == ref and q_mine == q_ref == 3
    reads = [o for kind, o in mine if kind == "r"]
    assert reads[0] == [(b"one", True, 3)]
    assert [v for v, _, _ in reads[1]] == [b"uno", None, b"three"]
    assert all(n == 3 for _, _, n in reads[1])


def test_sixteen_replicas_verify_their_certificates_on_the_comb_path():
    """n = 16, rf = 16 (f = 5, 11-grant certificates); all replicas share one
    CudaBatchVerifier on the CPU, which registers the cluster's identities
    at boot and is closed once.

    The client's request timeout is sized to the plain versions: every
    replica checks the Write2 certificate through the plain PyTorch comb,
    16 x 11 lanes, which takes about a second on an idle host and tens of
    seconds on a loaded one.  With the SDK's 10 s default no replica
    answered the Write2 in time under a parallel test run."""
    verifier = CudaBatchVerifier(device="cpu")
    closes = []
    real_close = verifier.close

    async def counting_close():
        closes.append(1)
        await real_close()

    verifier.close = counting_close

    async def main():
        before = BV.comb_routing_counts()["comb_items"]
        async with VirtualCluster(16, rf=16, verifier_factory=lambda: verifier) as vc:
            assert vc.config.quorum == 11
            client = vc.client(timeout_s=PLAIN_PATH_TIMEOUT_S)
            await client.execute_write_transaction(TransactionBuilder().write("k16", b"v16").build())
            res = await client.execute_read_transaction(TransactionBuilder().read("k16").build())
            assert _outcome(res) == [(b"v16", True, 11)]
            st = verifier_stats(verifier)
            assert st["comb"]["registered_signers"] == 16
            assert st["fallback_batches"] == 0
            assert BV.comb_routing_counts()["comb_items"] - before >= 11
            assert st["comb"]["device_dispatches_process_total"] > 0
        return len(closes)

    assert run(main(), 600) == 1


def test_port_client_commits_against_reference_replicas():
    async def main():
        async with JCluster(4, rf=4) as vc:
            cfg = ClusterConfig.from_json(vc.config.to_json())
            client = MochiDBClient(config=cfg)
            try:
                await client.execute_write_transaction(TransactionBuilder().write("x", b"from port").build())
                res = await client.execute_read_transaction(TransactionBuilder().read("x").build())
                assert _outcome(res) == [(b"from port", True, 3)]
            finally:
                await client.close()
            ref = await vc.client().execute_read_transaction(JTxn().read("x").build())
            assert _outcome(ref) == [(b"from port", True, 3)]

    run(main())


@pytest.mark.parametrize("cluster", [VirtualCluster, ProcessCluster], ids=["byzantine", "process-byzantine"])
def test_unported_cluster_options_raise(cluster):
    """Both clusters take ``byzantine=`` now (``tests/test_torch_byzantine_live.py``,
    ``netsim=`` in ``tests/test_torch_netsim.py``); what they still refuse,
    at ``start()`` and before any replica binds or process spawns, is a map
    naming a server outside the cluster or an unknown strategy."""
    kwargs = {"verifier": "cpu"} if cluster is ProcessCluster else {}
    for byz, match in (({"server-9": "silent"}, "unknown servers"),
                       ({"server-1": "nope"}, "unknown byzantine strategy")):
        c = cluster(4, rf=4, byzantine=byz, **kwargs)
        with pytest.raises(ValueError, match=match):
            asyncio.run(c.start())
        assert not getattr(c, "replicas", None) and not getattr(c, "processes", None)
