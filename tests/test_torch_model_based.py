"""Model-based testing: the cluster vs a plain dict.

A single client issuing sequential transactions must observe exactly
dict semantics — the quorum protocol, grants, epochs, certificates and
sharding are all implementation detail below that contract (the
reference asserts this only for hand-picked sequences,
``MochiClientServerCommunicationTest.java``; here the sequences are
generated).  Multi-key transactions apply atomically; duplicate keys in
one transaction are last-write-wins (a semantics decision,
matching the reference's sequential apply).
"""

from __future__ import annotations

import asyncio

import numpy as np

from mochi_tpu_torch.client.txn import TransactionBuilder
from mochi_tpu_torch.testing.virtual_cluster import VirtualCluster


def run(coro):
    asyncio.run(coro)


KEYS = [f"mb-{i}" for i in range(8)]


def test_random_op_sequences_match_dict_semantics():
    rng = np.random.default_rng(0xC0FFEE)

    async def main():
        async with VirtualCluster(5, rf=4) as vc:
            client = vc.client()
            model: dict = {}
            for step in range(120):
                kind = rng.integers(0, 4)
                if kind == 0:  # single write
                    k = KEYS[rng.integers(len(KEYS))]
                    v = b"s%d" % step
                    await client.execute_write_transaction(
                        TransactionBuilder().write(k, v).build()
                    )
                    model[k] = v
                elif kind == 1:  # single delete
                    k = KEYS[rng.integers(len(KEYS))]
                    await client.execute_write_transaction(
                        TransactionBuilder().delete(k).build()
                    )
                    model.pop(k, None)
                elif kind == 2:  # multi-key txn, possibly duplicate keys
                    tb = TransactionBuilder()
                    picks = [
                        KEYS[rng.integers(len(KEYS))]
                        for _ in range(int(rng.integers(2, 5)))
                    ]
                    staged: dict = {}
                    for j, k in enumerate(picks):
                        if rng.integers(2):
                            v = b"m%d-%d" % (step, j)
                            tb.write(k, v)
                            staged[k] = v
                        else:
                            tb.delete(k)
                            staged[k] = None
                    await client.execute_write_transaction(tb.build())
                    for k, v in staged.items():
                        if v is None:
                            model.pop(k, None)
                        else:
                            model[k] = v
                else:  # read a random subset, check against the model
                    tb = TransactionBuilder()
                    picks = [
                        KEYS[rng.integers(len(KEYS))]
                        for _ in range(int(rng.integers(1, 4)))
                    ]
                    for k in picks:
                        tb.read(k)
                    res = await client.execute_read_transaction(tb.build())
                    for k, op in zip(picks, res.operations):
                        if k in model:
                            assert op.existed and op.value == model[k], (
                                step, k, op.value, model[k],
                            )
                        else:
                            assert not op.existed, (step, k)
            # final audit: every key
            tb = TransactionBuilder()
            for k in KEYS:
                tb.read(k)
            res = await client.execute_read_transaction(tb.build())
            for k, op in zip(KEYS, res.operations):
                if k in model:
                    assert op.existed and op.value == model[k], k
                else:
                    assert not op.existed, k
            await client.close()

    run(main())


def test_op_outcomes_equal_the_reference():
    """One seeded sequence of writes, deletes, multi-key transactions (keys
    repeating) and reads through the port's cluster and the reference's:
    the sequence of outcomes (each read's existed flags and values, the
    final audit) is the same."""
    from mochi_tpu.client.txn import TransactionBuilder as RefBuilder
    from mochi_tpu.testing.virtual_cluster import VirtualCluster as RefCluster

    async def drive(cluster_cls, builder):
        rng = np.random.default_rng(0xD1FF)
        outcomes = []
        async with cluster_cls(5, rf=4) as vc:
            client = vc.client()
            for step in range(50):
                kind = rng.integers(0, 4)
                tb = builder()
                picks = [KEYS[rng.integers(len(KEYS))] for _ in range(int(rng.integers(1, 4)))]
                if kind == 3:
                    for k in picks:
                        tb.read(k)
                    res = await client.execute_read_transaction(tb.build())
                    outcomes.append([(op.existed, op.value) for op in res.operations])
                    continue
                for j, k in enumerate(picks if kind == 2 else picks[:1]):
                    if kind == 1 or (kind == 2 and rng.integers(2)):
                        tb.delete(k)
                    else:
                        tb.write(k, b"m%d-%d" % (step, j))
                res = await client.execute_write_transaction(tb.build())
                outcomes.append(("committed", len(res.operations)))
            tb = builder()
            for k in KEYS:
                tb.read(k)
            res = await client.execute_read_transaction(tb.build())
            outcomes.append([(op.existed, op.value) for op in res.operations])
            await client.close()
        return outcomes

    async def main():
        mine = await drive(VirtualCluster, TransactionBuilder)
        assert mine == await drive(RefCluster, RefBuilder)
        assert any(isinstance(o, list) and any(e for e, _ in o) for o in mine)

    run(main())
