"""Regression tests for review findings: out-of-set grants, signature
stripping, seed-range attacks, codec int domain, config token bounds."""

import asyncio

import pytest

from mochi_tpu_torch.client import TransactionBuilder
from mochi_tpu_torch.cluster import ClusterConfig
from mochi_tpu_torch.protocol import (
    Envelope,
    FailType,
    HelloToServer,
    RequestFailedFromServer,
    Transaction,
    Operation,
    Action,
    Write1OkFromServer,
    Write1ToServer,
    Write2ToServer,
    WriteCertificate,
    transaction_hash,
)
from mochi_tpu_torch.protocol.codec import decode, encode
from mochi_tpu_torch.server.store import BadRequest, DataStore
from mochi_tpu_torch.testing import VirtualCluster


def run(coro):
    asyncio.run(asyncio.wait_for(coro, timeout=60))


def test_out_of_set_grants_do_not_count_toward_quorum():
    # n=7, rf=4: servers outside a key's replica set may be compromised beyond
    # the in-set f assumption; their (validly signed) grants must not form a
    # committing certificate.
    cfg = ClusterConfig.build(
        {f"server-{i}": f"127.0.0.1:{8001 + i}" for i in range(7)}, rf=4
    )
    stores = {f"server-{i}": DataStore(f"server-{i}", cfg) for i in range(7)}
    key = next(
        k for k in (f"key-{i}" for i in range(1000))
        if len(set(cfg.replica_set_for_key(k))) == 4
        and len(set(cfg.servers) - set(cfg.replica_set_for_key(k))) >= 3
    )
    in_set = cfg.replica_set_for_key(key)
    out_set = sorted(set(cfg.servers) - set(in_set))[:3]
    txn = Transaction((Operation(Action.WRITE, key, b"evil"),))
    blind = Transaction((Operation(Action.WRITE, key, None),))
    req = Write1ToServer("attacker", blind, 5, transaction_hash(txn))
    # Collect grants ONLY from out-of-set servers (they will issue them since
    # owns() is False → WRONG_SHARD... so craft via one in-set grant plus
    # out-of-set forgeries at the same timestamp).
    from mochi_tpu_torch.protocol import Grant, MultiGrant, Status

    grants = {}
    for sid in out_set:
        grants[sid] = MultiGrant(
            grants={key: Grant(key, 5, 1, transaction_hash(txn), Status.OK)},
            client_id="attacker",
            server_id=sid,
        )
    wc = WriteCertificate(grants)
    victim = stores[in_set[0]]
    result = victim.process_write2(Write2ToServer(wc, txn))
    assert isinstance(result, RequestFailedFromServer)
    assert result.fail_type == FailType.BAD_CERTIFICATE
    assert victim.data.get(key) is None or victim.data[key].value != b"evil"


def test_signature_stripping_rejected_even_in_open_mode():
    async def main():
        async with VirtualCluster(4, rf=4) as vc:  # open mode (no client auth)
            client = vc.client()
            env = Envelope(HelloToServer("spoof"), "m1", "server-1")  # known id, no sig
            resp = await client.pool.send_and_receive(vc.config.servers["server-0"], env)
            assert isinstance(resp.payload, RequestFailedFromServer)
            assert resp.payload.fail_type == FailType.BAD_SIGNATURE

    run(main())


def test_out_of_range_seed_rejected():
    cfg = ClusterConfig.build(
        {f"server-{i}": f"127.0.0.1:{8001 + i}" for i in range(4)}, rf=4
    )
    store = DataStore("server-0", cfg)
    blind = Transaction((Operation(Action.WRITE, "k", None),))
    for bad_seed in (-1, 10**15, 1000):
        with pytest.raises(BadRequest):
            store.process_write1(Write1ToServer("c", blind, bad_seed, b"h"))


def test_out_of_range_seed_rejected_over_wire():
    async def main():
        async with VirtualCluster(4, rf=4) as vc:
            client = vc.client()
            blind = Transaction((Operation(Action.WRITE, "k", None),))
            env = client._envelope(
                Write1ToServer(client.client_id, blind, 10**12, b"h" * 64), "m-seed"
            )
            resp = await client.pool.send_and_receive(vc.config.servers["server-0"], env)
            assert isinstance(resp.payload, RequestFailedFromServer)
            assert resp.payload.fail_type == FailType.BAD_REQUEST

    run(main())


def test_codec_int_domain_symmetric():
    assert decode(encode((1 << 64) - 1)) == (1 << 64) - 1
    assert decode(encode(-(1 << 64))) == -(1 << 64)
    with pytest.raises(TypeError):
        encode(1 << 64)
    with pytest.raises(TypeError):
        encode(-(1 << 64) - 1)


def test_properties_token_bounds_checked():
    cfg = ClusterConfig.build(
        {f"server-{i}": f"127.0.0.1:{8001 + i}" for i in range(4)}, rf=4
    )
    text = cfg.to_properties().replace("_TOKENS=0,", "_TOKENS=-1,", 1)
    with pytest.raises(ValueError, match="outside"):
        ClusterConfig.from_properties(text)


def test_timer_memory_bounded():
    from mochi_tpu_torch.utils.metrics import Timer

    t = Timer(window=16)
    for i in range(1000):
        t.record(0.001)
    assert len(t.samples) == 16
    assert t.count == 1000
    assert t.snapshot()["count"] == 1000


def test_duplicate_key_transaction_cannot_inflate_quorum():
    # rf=4 (quorum 3): a txn repeating the same key must not let 2 servers'
    # grants count as 4 — one vote per (key, server) in Write2 coalescing.
    from mochi_tpu_torch.protocol import Grant, MultiGrant, Status

    cfg = ClusterConfig.build(
        {f"server-{i}": f"127.0.0.1:{8001 + i}" for i in range(4)}, rf=4
    )
    key = "dup-key"
    in_set = cfg.replica_set_for_key(key)
    txn = Transaction(
        (Operation(Action.WRITE, key, b"evil"), Operation(Action.WRITE, key, b"evil"))
    )
    h = transaction_hash(txn)
    grants = {
        sid: MultiGrant(
            grants={key: Grant(key, 5, 1, h, Status.OK)},
            client_id="attacker",
            server_id=sid,
        )
        for sid in in_set[:2]  # only 2 distinct servers < quorum 3
    }
    victim = DataStore(in_set[0], cfg)
    result = victim.process_write2(Write2ToServer(WriteCertificate(grants), txn))
    assert isinstance(result, RequestFailedFromServer)
    assert result.fail_type == FailType.BAD_CERTIFICATE
    assert victim.data.get(key) is None or victim.data[key].value != b"evil"


def test_read_tally_ignores_out_of_set_servers():
    # 10 servers, rf=4: 4 colluding servers OUTSIDE the key's replica set
    # answer OK with a forged value while only 3 in-set servers respond
    # honestly.  The client must take the honest 3 (== quorum), not the
    # forged 4.
    from mochi_tpu_torch.client.client import MochiDBClient
    from mochi_tpu_torch.protocol import OperationResult, ReadFromServer, Status, TransactionResult

    cfg = ClusterConfig.build(
        {f"server-{i}": f"127.0.0.1:{8001 + i}" for i in range(10)}, rf=4
    )
    key = "oos-read-key"
    in_set = cfg.replica_set_for_key(key)
    out_set = sorted(set(cfg.servers) - set(in_set))[:4]
    client = MochiDBClient(cfg)
    txn = TransactionBuilder().read(key).build()

    async def fake_fan_out(transaction, make_payload, targets=None, **kw):
        payload = make_payload()
        nonce = payload.nonce
        honest = TransactionResult((OperationResult(b"good", None, True, Status.OK),))
        forged = TransactionResult((OperationResult(b"evil", None, True, Status.OK),))
        resp = {}
        for sid in in_set[:3]:
            resp[sid] = ReadFromServer(honest, nonce, "r")
        for sid in out_set:
            resp[sid] = ReadFromServer(forged, nonce, "r")
        return resp

    client._fan_out = fake_fan_out
    result = run_return(client.execute_read_transaction(txn))
    assert result.operations[0].value == b"good"


def run_return(coro):
    return asyncio.run(asyncio.wait_for(coro, timeout=60))


def test_write_succeeds_despite_one_refusing_replica():
    # BFT liveness: one always-refusing replica (f=1, rf=4) must not block
    # writes when the other 3 (== quorum) grant consistently.
    from mochi_tpu_torch.protocol import Grant, MultiGrant, Status, Write1RefusedFromServer

    async def main():
        async with VirtualCluster(4, rf=4) as vc:
            byz = vc.replicas[0]

            def always_refuse(req):
                mg = MultiGrant(
                    grants={
                        op.key: Grant(op.key, 0, 1, req.transaction_hash, Status.REFUSED)
                        for op in req.transaction.operations
                    },
                    client_id=req.client_id,
                    server_id=byz.server_id,
                )
                return Write1RefusedFromServer(mg, {}, req.client_id)

            byz.store.process_write1 = always_refuse
            client = vc.client()
            await client.execute_write_transaction(
                TransactionBuilder().write("live-k", "live-v").build()
            )
            r = await client.execute_read_transaction(
                TransactionBuilder().read("live-k").build()
            )
            assert r.operations[0].value == b"live-v"

    run(main())


def test_write_succeeds_despite_one_skewed_timestamp_replica():
    # A replica granting at a skewed epoch must not stall writes: the client
    # picks the majority-timestamp subset.
    async def main():
        async with VirtualCluster(4, rf=4) as vc:
            byz = vc.replicas[0]
            orig = byz.store.process_write1

            def skewed(req):
                resp = orig(req)
                from mochi_tpu_torch.protocol import Write1OkFromServer as Ok

                if isinstance(resp, Ok):
                    from dataclasses import replace as dc_replace

                    mg = resp.multi_grant
                    skewed_grants = {
                        k: dc_replace(g, timestamp=g.timestamp + 5000)
                        for k, g in mg.grants.items()
                    }
                    new_mg = dc_replace(mg, grants=skewed_grants)
                    new_mg = byz._sign_multigrant(new_mg) if hasattr(byz, "_sign_multigrant") else new_mg
                    return Ok(new_mg, resp.current_certificates)
                return resp

            byz.store.process_write1 = skewed
            client = vc.client()
            await client.execute_write_transaction(
                TransactionBuilder().write("skew-k", "skew-v").build()
            )
            r = await client.execute_read_transaction(
                TransactionBuilder().read("skew-k").build()
            )
            assert r.operations[0].value == b"skew-v"

    run(main())


def test_codec_boundaries_and_property_bounds_equal_the_reference():
    """Integers at and past the codec's domain and the properties file's
    token bounds: the port encodes, refuses and parses exactly as the
    reference does."""
    from mochi_tpu.cluster import ClusterConfig as RefConfig
    from mochi_tpu.protocol import codec as ref_codec

    for v in (0, 1, -1, 127, 128, (1 << 63), (1 << 64) - 1, -(1 << 64), 1 << 64, -(1 << 64) - 1):
        try:
            mine = encode(v)
        except TypeError:
            mine = TypeError
        try:
            theirs = ref_codec.encode(v)
        except TypeError:
            theirs = TypeError
        assert mine == theirs, v
    cfg = ClusterConfig.build({f"server-{i}": f"127.0.0.1:{8001 + i}" for i in range(4)}, rf=4)
    for old, new in (("_TOKENS=0,", "_TOKENS=-1,"), ("_TOKENS=0,", "_TOKENS=0,")):
        text = cfg.to_properties().replace(old, new, 1)
        outcomes = []
        for cls in (ClusterConfig, RefConfig):
            try:
                outcomes.append(cls.from_properties(text).to_json())
            except ValueError as exc:
                outcomes.append(str(exc))
        assert outcomes[0] == outcomes[1]
