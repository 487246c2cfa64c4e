"""Datastore state-machine unit tests: grants, certificates, apply, epochs.

Drives 4 DataStore instances as a simulated RF=4 replica set (no networking),
checking the protocol semantics SURVEY.md §2.5 catalogues: grant issuance,
idempotent retry, refusal on contention, quorum/hash enforcement at Write2,
stale read-back, epoch advancement, and the grant GC the reference never
wired up.
"""

import pytest

from mochi_tpu_torch.cluster import ClusterConfig
from mochi_tpu_torch.protocol import (
    Action,
    FailType,
    MultiGrant,
    Operation,
    RequestFailedFromServer,
    Status,
    Transaction,
    Write1OkFromServer,
    Write1RefusedFromServer,
    Write1ToServer,
    Write2AnsFromServer,
    Write2ToServer,
    WriteCertificate,
    transaction_hash,
)
from mochi_tpu_torch.server.store import EPOCH_UNIT, GRANT_GC_EPOCHS, DataStore


def make_cluster(n=4, rf=4):
    cfg = ClusterConfig.build(
        {f"server-{i}": f"127.0.0.1:{8001 + i}" for i in range(n)}, rf=rf
    )
    return cfg, [DataStore(f"server-{i}", cfg) for i in range(n)]


def wtxn(key: str, value: bytes) -> Transaction:
    return Transaction((Operation(Action.WRITE, key, value),))


def write1_everywhere(stores, txn, seed=42, client="client-1"):
    """Run Write1 on each store for txn's keys; return responses."""
    blind = Transaction(tuple(Operation(Action.WRITE, op.key, None) for op in txn.operations))
    req = Write1ToServer(client, blind, seed, transaction_hash(txn))
    return [s.process_write1(req) for s in stores]


def certificate_from(responses) -> WriteCertificate:
    return WriteCertificate(
        {r.multi_grant.server_id: r.multi_grant for r in responses if isinstance(r, Write1OkFromServer)}
    )


def commit_everywhere(stores, txn, wc):
    return [s.process_write2(Write2ToServer(wc, txn)) for s in stores]


def test_write1_grants_and_write2_apply():
    _, stores = make_cluster()
    txn = wtxn("alpha", b"v1")
    responses = write1_everywhere(stores, txn, seed=123)
    assert all(isinstance(r, Write1OkFromServer) for r in responses)
    for r in responses:
        grant = r.multi_grant.grants["alpha"]
        assert grant.status == Status.OK
        assert grant.timestamp == 123  # epoch 0 + seed

    wc = certificate_from(responses)
    answers = commit_everywhere(stores, txn, wc)
    for ans in answers:
        assert isinstance(ans, Write2AnsFromServer)
        (op_res,) = ans.result.operations
        assert op_res.value == b"v1"
        assert op_res.status == Status.OK
        assert op_res.existed is False  # fresh key

    for s in stores:
        sv = s.data["alpha"]
        assert sv.value == b"v1" and sv.exists
        assert sv.current_epoch == EPOCH_UNIT  # advanced past applied ts
        assert sv.grant_at(123) is None  # consumed


def test_write1_idempotent_retry_same_hash():
    _, stores = make_cluster()
    txn = wtxn("k", b"v")
    r1 = write1_everywhere(stores, txn, seed=7)
    r2 = write1_everywhere(stores, txn, seed=7)  # retry, same hash
    for a, b in zip(r1, r2):
        assert isinstance(b, Write1OkFromServer)
        assert a.multi_grant.grants["k"] == b.multi_grant.grants["k"]


def test_write1_refused_on_contention():
    _, stores = make_cluster()
    t1, t2 = wtxn("k", b"v1"), wtxn("k", b"v2")
    write1_everywhere(stores, t1, seed=7, client="client-1")
    responses = write1_everywhere(stores, t2, seed=7, client="client-2")
    for r in responses:
        assert isinstance(r, Write1RefusedFromServer)
        assert r.multi_grant.grants["k"].status == Status.REFUSED


def test_different_seed_avoids_contention():
    _, stores = make_cluster()
    write1_everywhere(stores, wtxn("k", b"v1"), seed=7, client="client-1")
    responses = write1_everywhere(stores, wtxn("k", b"v2"), seed=8, client="client-2")
    assert all(isinstance(r, Write1OkFromServer) for r in responses)


def test_write2_rejects_thin_certificate():
    cfg, stores = make_cluster()
    txn = wtxn("k", b"v")
    responses = write1_everywhere(stores, txn)
    wc = certificate_from(responses[:2])  # 2 < quorum (3)
    ans = stores[0].process_write2(Write2ToServer(wc, txn))
    assert isinstance(ans, RequestFailedFromServer)
    assert ans.fail_type == FailType.BAD_CERTIFICATE


def test_write2_rejects_hash_mismatch():
    _, stores = make_cluster()
    txn = wtxn("k", b"v")
    responses = write1_everywhere(stores, txn)
    wc = certificate_from(responses)
    other_txn = wtxn("k", b"DIFFERENT")  # hash differs from granted hash
    ans = stores[0].process_write2(Write2ToServer(wc, other_txn))
    assert isinstance(ans, RequestFailedFromServer)
    assert ans.fail_type == FailType.BAD_CERTIFICATE


def test_write2_rejects_timestamp_disagreement():
    _, stores = make_cluster()
    txn = wtxn("k", b"v")
    responses = write1_everywhere(stores, txn, seed=5)
    wc = certificate_from(responses)
    # Forge one server's grant to a different timestamp.
    sid = "server-1"
    mg = wc.grants[sid]
    bad_grant = mg.grants["k"]
    from dataclasses import replace

    forged = MultiGrant(
        grants={"k": replace(bad_grant, timestamp=bad_grant.timestamp + 1)},
        client_id=mg.client_id,
        server_id=sid,
    )
    wc = WriteCertificate({**wc.grants, sid: forged})
    ans = stores[0].process_write2(Write2ToServer(wc, txn))
    assert isinstance(ans, RequestFailedFromServer)
    assert ans.fail_type == FailType.BAD_CERTIFICATE


def test_stale_write2_reads_back():
    _, stores = make_cluster()
    t_new = wtxn("k", b"new")
    t_old = wtxn("k", b"old")
    r_old = write1_everywhere(stores, t_old, seed=10, client="c1")
    r_new = write1_everywhere(stores, t_new, seed=900, client="c2")
    # Commit the higher-timestamp txn first...
    commit_everywhere(stores, t_new, certificate_from(r_new))
    # ...then the stale one: replicas must answer with current state, not clobber.
    answers = commit_everywhere(stores, t_old, certificate_from(r_old))
    for ans in answers:
        assert isinstance(ans, Write2AnsFromServer)
        (op_res,) = ans.result.operations
        assert op_res.value == b"new"
    assert all(s.data["k"].value == b"new" for s in stores)


def test_read_roundtrip_and_missing_key():
    _, stores = make_cluster()
    txn = wtxn("k", b"v")
    commit_everywhere(stores, txn, certificate_from(write1_everywhere(stores, txn)))
    read = stores[0].process_read(Transaction((Operation(Action.READ, "k"), Operation(Action.READ, "nope"))))
    assert read.operations[0].value == b"v" and read.operations[0].existed
    assert read.operations[1].value is None and not read.operations[1].existed


def test_delete_clears_value():
    _, stores = make_cluster()
    txn = wtxn("k", b"v")
    commit_everywhere(stores, txn, certificate_from(write1_everywhere(stores, txn)))
    dtxn = Transaction((Operation(Action.DELETE, "k"),))
    responses = write1_everywhere(stores, dtxn, seed=99)
    answers = commit_everywhere(stores, dtxn, certificate_from(responses))
    for ans in answers:
        (op_res,) = ans.result.operations
        assert op_res.existed is True  # existed before delete
    read = stores[0].process_read(Transaction((Operation(Action.READ, "k"),)))
    assert read.operations[0].existed is False


def test_multikey_transaction_atomic_grants():
    _, stores = make_cluster()
    txn = Transaction(
        (Operation(Action.WRITE, "a", b"1"), Operation(Action.WRITE, "b", b"2"))
    )
    responses = write1_everywhere(stores, txn)
    for r in responses:
        assert set(r.multi_grant.grants) == {"a", "b"}
    answers = commit_everywhere(stores, txn, certificate_from(responses))
    for ans in answers:
        assert [o.value for o in ans.result.operations] == [b"1", b"2"]


def test_grant_gc_on_epoch_advance():
    _, stores = make_cluster()
    store = stores[0]
    # Issue a grant, then advance the epoch far past the GC horizon.
    txn = wtxn("k", b"v")
    write1_everywhere([store], txn, seed=1)
    sv = store.data["k"]
    assert sv.grants
    sv.advance_epoch(sv.current_epoch + GRANT_GC_EPOCHS + 5 * EPOCH_UNIT)
    assert not sv.grants  # stale epochs collected (ref never called its GC)


def test_wrong_shard_status_for_unowned_keys():
    cfg, stores = make_cluster(n=6, rf=4)
    # find a key and a server outside its replica set
    key, outsider = None, None
    for i in range(1000):
        candidate = f"key-{i}"
        rs = set(cfg.replica_set_for_key(candidate))
        others = set(cfg.servers) - rs
        if others:
            key, outsider = candidate, sorted(others)[0]
            break
    assert key is not None
    store = next(s for s in stores if s.server_id == outsider)
    read = store.process_read(Transaction((Operation(Action.READ, key),)))
    assert read.operations[0].status == Status.WRONG_SHARD
    w1 = store.process_write1(
        Write1ToServer("c", Transaction((Operation(Action.WRITE, key, None),)), 5, b"h")
    )
    assert w1.multi_grant.grants[key].status == Status.WRONG_SHARD


def test_duplicate_key_transaction_last_write_wins():
    """Ops on the same key apply SEQUENTIALLY — the reference's per-op
    applyOperation loop (InMemoryDataStore.java:521-554) makes the last
    write win; a first-op-wins short-circuit once diverged."""
    _, stores = make_cluster()
    txn = Transaction(
        (
            Operation(Action.WRITE, "dup", b"first"),
            Operation(Action.WRITE, "dup", b"second"),
        )
    )
    responses = write1_everywhere(stores, txn)
    wc = certificate_from(responses)
    answers = commit_everywhere(stores, txn, wc)
    for ans in answers:
        assert isinstance(ans, Write2AnsFromServer)
        assert len(ans.result.operations) == 2
    for store in stores:
        assert store.data["dup"].value == b"second"

    # write-then-delete in one txn: the delete lands last
    txn2 = Transaction(
        (
            Operation(Action.WRITE, "dup2", b"x"),
            Operation(Action.DELETE, "dup2"),
        )
    )
    wc2 = certificate_from(write1_everywhere(stores, txn2, seed=7))
    for ans in commit_everywhere(stores, txn2, wc2):
        assert isinstance(ans, Write2AnsFromServer)
    for store in stores:
        sv = store.data["dup2"]
        assert not sv.exists and sv.value is None


def test_store_outcomes_equal_the_reference():
    """One sequence of Write1s (a grant, an idempotent retry, a contention
    refusal), Write2s (a thin and a full certificate), reads and a sync
    export through the port's DataStores and the reference's, requests
    carried over the wire: every response encodes to the same bytes."""
    from tests.torch_crosswire import PairedStores

    st = PairedStores()
    for k, (key, value) in enumerate([("d-a", b"1"), ("d-b", b"2"), ("d-a", b"3")]):
        txn = wtxn(key, value)
        blind = Transaction(tuple(Operation(Action.WRITE, op.key, None) for op in txn.operations))
        grants = st.both("process_write1", Write1ToServer("client-1", blind, 40 + k, transaction_hash(txn)))
        st.both("process_write1", Write1ToServer("client-1", blind, 40 + k, transaction_hash(txn)))
        other = wtxn(key, b"other")
        st.both("process_write1", Write1ToServer("client-2", blind, 40 + k, transaction_hash(other)))
        wc = certificate_from(grants)
        st.both("process_write2", Write2ToServer(WriteCertificate(dict(list(wc.grants.items())[:2])), txn))
        st.both("process_write2", Write2ToServer(wc, txn))
        st.both("process_read", Transaction((Operation(Action.READ, key),)))
    st.both("process_read", Transaction((Operation(Action.READ, "d-missing"),)))
    assert len(st.sync_entries()[0].entries) == 2
