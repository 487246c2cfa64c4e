"""Batched hot path: drain→decode→verify→apply pipeline evidence.

The batched hot path's contract, pinned as tests:

* a multi-message drain produces exactly ONE BatchingVerifier round trip
  (envelope auth + every Write2 certificate grant share one bitmap) and
  exactly ONE coalesced socket write for the whole batch's responses;
* a forged envelope inside a batch is rejected (BAD_SIGNATURE) without
  poisoning its batchmates, and a forged GRANT inside one certificate
  drops alone while the surviving quorum still commits;
* the store batch entry points match the single-request entry points
  result-for-result, with per-request failures isolated as values;
* frames arriving on DIFFERENT connections in one scheduling tick drain
  as one batch (the cross-connection axis the per-socket
  histogram could never see);
* payload dataclasses reject post-construction container mutation (the
  ``_mcode`` encode-cache desync guard).
"""

from __future__ import annotations

import asyncio
import struct
import time

import pytest

from mochi_tpu_torch.cluster.config import ClusterConfig
from mochi_tpu_torch.crypto.keys import generate_keypair
from mochi_tpu_torch.net.transport import _RpcServerProtocol, new_msg_id
from mochi_tpu_torch.protocol import (
    Action,
    Envelope,
    FailType,
    Grant,
    MultiGrant,
    Operation,
    RequestFailedFromServer,
    Status,
    Transaction,
    Write1ToServer,
    Write2AnsFromServer,
    Write2ToServer,
    WriteCertificate,
    decode_envelope,
    transaction_hash,
)
from mochi_tpu_torch.server.replica import MochiReplica
from mochi_tpu_torch.server.store import BadRequest, DataStore
from mochi_tpu_torch.verifier.spi import BatchingVerifier

_LEN = struct.Struct(">I")


class _FakeTransport:
    """Counts write() calls and captures bytes; quacks like asyncio.Transport."""

    def __init__(self) -> None:
        self.writes = []
        self._closing = False

    def write(self, data: bytes) -> None:
        self.writes.append(bytes(data))

    def is_closing(self) -> bool:
        return self._closing

    def close(self) -> None:
        self._closing = True

    def abort(self) -> None:
        self._closing = True

    def get_extra_info(self, name, default=None):
        return default

    def pause_reading(self) -> None:
        pass

    def resume_reading(self) -> None:
        pass


def _cluster(n=4):
    kps = {f"server-{i}": generate_keypair() for i in range(n)}
    config = ClusterConfig.build(
        {sid: f"127.0.0.1:{9500 + i}" for i, sid in enumerate(kps)},
        rf=n,
        public_keys={sid: kp.public_key for sid, kp in kps.items()},
    )
    return config, kps


def _signed_write2(config, kps, client_kp, client_id, key, forged_env=False,
                   forged_grant_sid=None):
    txn = Transaction((Operation(Action.WRITE, key, b"v-" + key.encode()),))
    th = transaction_hash(txn)
    grants = {}
    for sid, kp in kps.items():
        mg = MultiGrant(
            {key: Grant(key, 7, config.configstamp, th, Status.OK)}, client_id, sid
        )
        sig = kp.sign(mg.signing_bytes())
        if sid == forged_grant_sid:
            sig = bytes(64)  # forged: fails verification, batchmates must not
        grants[sid] = mg.with_signature(sig)
    env = Envelope(
        payload=Write2ToServer(WriteCertificate(grants), txn),
        msg_id=new_msg_id(),
        sender_id=client_id,
        timestamp_ms=int(time.time() * 1000),
    )
    sig = client_kp.sign(env.signing_bytes())
    if forged_env:
        sig = bytes(64)
    return env.with_signature(sig)


def _frames(*envelopes) -> bytes:
    from mochi_tpu_torch.protocol import encode_envelope

    out = b""
    for env in envelopes:
        frame = encode_envelope(env)
        out += _LEN.pack(len(frame)) + frame
    return out


async def _pump_until(cond, timeout_s=5.0):
    deadline = time.monotonic() + timeout_s
    while not cond():
        assert time.monotonic() < deadline, "condition not reached"
        await asyncio.sleep(0.005)


def _replica_with_counting_verifier(config, kps, client_pub):
    calls = []

    def backend(items):
        from mochi_tpu_torch.crypto.keys import verify

        calls.append(len(items))
        return [verify(it.public_key, it.message, it.signature) for it in items]

    verifier = BatchingVerifier(backend, max_delay_s=0.0)
    replica = MochiReplica(
        "server-0",
        config,
        kps["server-0"],
        verifier=verifier,
        client_public_keys=dict(client_pub),
        shed_lag_ms=0.0,
    )
    return replica, verifier, calls


def test_multi_message_drain_one_roundtrip_one_write():
    """3 signed Write2s in one delivery: 1 verifier round trip (15 items:
    3 envelope sigs + 3x4 grant sigs — own grants defer to the pooled
    round trip for pending-auth envelopes rather than re-signing on the
    loop), 1 coalesced socket write."""

    async def main():
        config, kps = _cluster()
        client_kp = generate_keypair()
        replica, verifier, calls = _replica_with_counting_verifier(
            config, kps, {"client-a": client_kp.public_key}
        )
        proto = _RpcServerProtocol(replica.rpc)
        fake = _FakeTransport()
        proto.connection_made(fake)
        envs = [
            _signed_write2(config, kps, client_kp, "client-a", f"bh-{i}")
            for i in range(3)
        ]
        proto.data_received(_frames(*envs))
        await _pump_until(lambda: len(fake.writes) >= 1)

        assert len(fake.writes) == 1, "responses must leave in ONE write"
        assert verifier.batches_flushed == 1, "ONE BatchingVerifier round trip"
        assert len(calls) == 1 and calls[0] == 15
        # all three committed, responses correlate to their requests
        blob = fake.writes[0]
        responses, pos = [], 0
        while pos < len(blob):
            (length,) = _LEN.unpack_from(blob, pos)
            responses.append(decode_envelope(blob[pos + 4 : pos + 4 + length]))
            pos += 4 + length
        assert len(responses) == 3
        by_reply = {r.reply_to: r for r in responses}
        for env in envs:
            assert isinstance(by_reply[env.msg_id].payload, Write2AnsFromServer)
        for i in range(3):
            sv = replica.store._get(f"bh-{i}")
            assert sv is not None and sv.exists
        await verifier.close()

    asyncio.run(main())


def test_forged_envelope_rejected_without_poisoning_batchmates():
    async def main():
        config, kps = _cluster()
        client_kp = generate_keypair()
        replica, verifier, calls = _replica_with_counting_verifier(
            config, kps, {"client-a": client_kp.public_key}
        )
        proto = _RpcServerProtocol(replica.rpc)
        fake = _FakeTransport()
        proto.connection_made(fake)
        good1 = _signed_write2(config, kps, client_kp, "client-a", "fg-good1")
        forged = _signed_write2(
            config, kps, client_kp, "client-a", "fg-forged", forged_env=True
        )
        good2 = _signed_write2(config, kps, client_kp, "client-a", "fg-good2")
        proto.data_received(_frames(good1, forged, good2))
        await _pump_until(lambda: len(fake.writes) >= 1)

        assert len(fake.writes) == 1 and verifier.batches_flushed == 1
        blob = fake.writes[0]
        responses, pos = [], 0
        while pos < len(blob):
            (length,) = _LEN.unpack_from(blob, pos)
            responses.append(decode_envelope(blob[pos + 4 : pos + 4 + length]))
            pos += 4 + length
        by_reply = {r.reply_to: r for r in responses}
        assert isinstance(by_reply[good1.msg_id].payload, Write2AnsFromServer)
        assert isinstance(by_reply[good2.msg_id].payload, Write2AnsFromServer)
        bad = by_reply[forged.msg_id].payload
        assert isinstance(bad, RequestFailedFromServer)
        assert bad.fail_type == FailType.BAD_SIGNATURE
        # the forged envelope's transaction must NOT have applied
        assert replica.store._get("fg-forged") is None
        assert replica.store._get("fg-good1").exists
        assert replica.store._get("fg-good2").exists
        await verifier.close()

    asyncio.run(main())


def test_forged_grant_drops_alone_quorum_survives():
    """One forged GRANT inside one cert: the grant is dropped, the cert's
    remaining 2f+1 in-set grants still commit, batchmates unaffected."""

    async def main():
        config, kps = _cluster()
        client_kp = generate_keypair()
        replica, verifier, _ = _replica_with_counting_verifier(
            config, kps, {"client-a": client_kp.public_key}
        )
        proto = _RpcServerProtocol(replica.rpc)
        fake = _FakeTransport()
        proto.connection_made(fake)
        # forge server-3's grant (not server-0: its own-grant check is local)
        tainted = _signed_write2(
            config, kps, client_kp, "client-a", "fgr-tainted",
            forged_grant_sid="server-3",
        )
        clean = _signed_write2(config, kps, client_kp, "client-a", "fgr-clean")
        proto.data_received(_frames(tainted, clean))
        await _pump_until(lambda: len(fake.writes) >= 1)

        assert replica.store._get("fgr-tainted").exists  # 3 of 4 grants = quorum
        assert replica.store._get("fgr-clean").exists
        assert replica.metrics.counters.get("replica.dropped-grants") == 1
        await verifier.close()

    asyncio.run(main())


def test_cross_connection_frames_drain_as_one_batch():
    """Two frames on two DIFFERENT connections in one tick: one drain, one
    verifier round trip — the cross-connection aggregation axis."""

    async def main():
        config, kps = _cluster()
        client_kp = generate_keypair()
        replica, verifier, calls = _replica_with_counting_verifier(
            config, kps, {"client-a": client_kp.public_key}
        )
        protos = []
        fakes = []
        for _ in range(2):
            proto = _RpcServerProtocol(replica.rpc)
            fake = _FakeTransport()
            proto.connection_made(fake)
            protos.append(proto)
            fakes.append(fake)
        envs = [
            _signed_write2(config, kps, client_kp, "client-a", f"xc-{i}")
            for i in range(2)
        ]
        # same call stack = same scheduling tick, two distinct connections
        protos[0].data_received(_frames(envs[0]))
        protos[1].data_received(_frames(envs[1]))
        await _pump_until(lambda: all(f.writes for f in fakes))

        assert verifier.batches_flushed == 1, "both connections shared one round trip"
        assert len(calls) == 1
        occupancy = replica.metrics.histograms["replica.batch-occupancy"]
        assert occupancy.total_count == 1 and occupancy.total_sum == 2.0
        drain = replica.metrics.histograms["transport.drain-frames"]
        assert drain.total_count == 1 and drain.total_sum == 2.0
        await verifier.close()

    asyncio.run(main())


def test_optimistic_budget_overflow_uses_second_roundtrip(monkeypatch):
    """Budget exhausted: a pending-auth Write2's certificate waits for the
    auth verdict.  The forged envelope then costs exactly ONE pooled
    verify (its auth item — the pre-batch price); the authentic one still
    commits via the overflow round trip."""
    import mochi_tpu_torch.server.replica as replica_mod

    monkeypatch.setattr(replica_mod, "OPTIMISTIC_CERT_ITEM_BUDGET", 0)

    async def main():
        config, kps = _cluster()
        client_kp = generate_keypair()
        replica, verifier, calls = _replica_with_counting_verifier(
            config, kps, {"client-a": client_kp.public_key}
        )
        proto = _RpcServerProtocol(replica.rpc)
        fake = _FakeTransport()
        proto.connection_made(fake)
        forged = _signed_write2(
            config, kps, client_kp, "client-a", "ob-forged", forged_env=True
        )
        good = _signed_write2(config, kps, client_kp, "client-a", "ob-good")
        proto.data_received(_frames(forged, good))
        await _pump_until(lambda: len(fake.writes) >= 1)

        # round trip 1: the two auth items only; round trip 2: the GOOD
        # envelope's 3 non-own cert grants (forged never reaches it)
        assert calls == [2, 3], calls
        assert replica.store._get("ob-good").exists
        assert replica.store._get("ob-forged") is None
        blob = fake.writes[0] if len(fake.writes) == 1 else b"".join(fake.writes)
        responses, pos = [], 0
        while pos < len(blob):
            (length,) = _LEN.unpack_from(blob, pos)
            responses.append(decode_envelope(blob[pos + 4 : pos + 4 + length]))
            pos += 4 + length
        by_reply = {r.reply_to: r for r in responses}
        assert isinstance(by_reply[good.msg_id].payload, Write2AnsFromServer)
        bad = by_reply[forged.msg_id].payload
        assert isinstance(bad, RequestFailedFromServer)
        assert bad.fail_type == FailType.BAD_SIGNATURE
        await verifier.close()

    asyncio.run(main())


def test_malformed_payload_dies_alone_in_batch():
    """A Write2 whose grant carries type-garbage (string configstamp) blows
    up deep in certificate prep — it must be dropped ALONE (no response,
    like the old per-task blast radius) while its batchmate commits."""

    async def main():
        config, kps = _cluster()
        client_kp = generate_keypair()
        replica, verifier, _ = _replica_with_counting_verifier(
            config, kps, {"client-a": client_kp.public_key}
        )
        proto = _RpcServerProtocol(replica.rpc)
        fake = _FakeTransport()
        proto.connection_made(fake)

        good = _signed_write2(config, kps, client_kp, "client-a", "mp-good")
        # hand-build a cert whose grants carry a STRING configstamp
        txn = Transaction((Operation(Action.WRITE, "mp-bad", b"v"),))
        th = transaction_hash(txn)
        grants = {}
        for sid, kp in kps.items():
            mg = MultiGrant(
                {"mp-bad": Grant("mp-bad", 7, "garbage-cs", th, Status.OK)},
                "client-a",
                sid,
            )
            grants[sid] = mg.with_signature(kp.sign(mg.signing_bytes()))
        bad_env = Envelope(
            payload=Write2ToServer(WriteCertificate(grants), txn),
            msg_id=new_msg_id(),
            sender_id="client-a",
            timestamp_ms=int(time.time() * 1000),
        )
        bad_env = bad_env.with_signature(client_kp.sign(bad_env.signing_bytes()))

        proto.data_received(_frames(bad_env, good))
        await _pump_until(lambda: len(fake.writes) >= 1)
        blob = fake.writes[0]
        responses, pos = [], 0
        while pos < len(blob):
            (length,) = _LEN.unpack_from(blob, pos)
            responses.append(decode_envelope(blob[pos + 4 : pos + 4 + length]))
            pos += 4 + length
        # batchmate answered; the malformed one got NO response at all
        assert [r.reply_to for r in responses] == [good.msg_id]
        assert isinstance(responses[0].payload, Write2AnsFromServer)
        assert replica.store._get("mp-good").exists
        assert replica.store._get("mp-bad") is None
        await verifier.close()

    asyncio.run(main())


def test_macd_admin_write1_denied_on_inline_path():
    """A MAC'd (non-admin-signed) Write1 touching config keys must be
    refused BAD_REQUEST on the grant path — the authorization gate the
    pre-batch dispatch enforced (it must not even acquire grants)."""

    async def main():
        from mochi_tpu_torch.cluster.config import CONFIG_CLUSTER_KEY
        from mochi_tpu_torch.crypto import session as session_crypto

        admin_kp = generate_keypair()
        kps = {f"server-{i}": generate_keypair() for i in range(4)}
        config = ClusterConfig.build(
            {sid: f"127.0.0.1:{9600 + i}" for i, sid in enumerate(kps)},
            rf=4,
            public_keys={sid: kp.public_key for sid, kp in kps.items()},
        )
        config.admin_keys.append(admin_kp.public_key)
        replica = MochiReplica("server-0", config, kps["server-0"], shed_lag_ms=0.0)
        # fake an established MAC session for the client
        session_key = b"k" * 32
        replica._sessions["client-a"] = session_key
        txn = Transaction((Operation(Action.WRITE, CONFIG_CLUSTER_KEY, None),))
        env = Envelope(
            payload=Write1ToServer("client-a", txn, 5, transaction_hash(txn)),
            msg_id=new_msg_id(),
            sender_id="client-a",
            timestamp_ms=int(time.time() * 1000),
        )
        env = session_crypto.seal(env, session_key)
        (response,) = replica.handle_inline_batch([env])
        assert isinstance(response.payload, RequestFailedFromServer)
        assert response.payload.fail_type == FailType.BAD_REQUEST
        # and no grant was issued for the config key
        sv = replica.store._get(CONFIG_CLUSTER_KEY)
        assert sv is None or not sv.grants

    asyncio.run(main())


# ------------------------------------------------------- store batch entries


def test_store_write1_batch_matches_singles_and_isolates_bad_requests():
    config, _ = _cluster()
    store_a = DataStore("server-0", config)
    store_b = DataStore("server-0", config)
    txn = Transaction((Operation(Action.WRITE, "sb-k", None),))
    th = transaction_hash(txn)
    reqs = [
        Write1ToServer("c", txn, 5, th),
        Write1ToServer("c", txn, 2000, th),  # seed out of range -> BadRequest
        Write1ToServer("c", txn, 9, th),
    ]
    batch = store_a.process_write1_batch(reqs)
    assert isinstance(batch[1], BadRequest)
    singles = []
    for req in reqs:
        try:
            singles.append(store_b.process_write1(req))
        except BadRequest as exc:
            singles.append(exc)
    assert batch[0] == singles[0] and batch[2] == singles[2]
    assert str(batch[1]) == str(singles[1])
    # identical grant books afterwards
    assert store_a._get("sb-k").grants == store_b._get("sb-k").grants


def test_store_write2_batch_matches_singles():
    config, kps = _cluster()
    client_kp = generate_keypair()
    envs = [
        _signed_write2(config, kps, client_kp, "c", f"w2b-{i}") for i in range(3)
    ]
    reqs = [e.payload for e in envs]
    store_a = DataStore("server-1", config)
    store_b = DataStore("server-1", config)
    batch = store_a.process_write2_batch(reqs)
    singles = [store_b.process_write2(r) for r in reqs]
    assert batch == singles
    for i in range(3):
        assert store_a._get(f"w2b-{i}").exists


# --------------------------------------------------- frozen payload containers


def test_payload_nested_containers_are_frozen():
    config, kps = _cluster()
    client_kp = generate_keypair()
    env = _signed_write2(config, kps, client_kp, "c", "fz-k")
    wc = env.payload.write_certificate
    mg = next(iter(wc.grants.values()))
    with pytest.raises(TypeError):
        wc.grants["evil"] = mg
    with pytest.raises(TypeError):
        mg.grants["evil"] = next(iter(mg.grants.values()))
    # the decode path (from_obj bypasses __init__) must freeze too
    from mochi_tpu_torch.protocol import encode_envelope

    decoded = decode_envelope(encode_envelope(env))
    dwc = decoded.payload.write_certificate
    with pytest.raises(TypeError):
        dwc.grants["evil"] = mg
    dmg = next(iter(dwc.grants.values()))
    with pytest.raises(TypeError):
        dmg.grants["evil"] = next(iter(dmg.grants.values()))
    # Write1Ok / Write1Refused current_certificates
    store = DataStore("server-0", config)
    txn = Transaction((Operation(Action.WRITE, "fz-w1", None),))
    ok = store.process_write1(
        Write1ToServer("c", txn, 3, transaction_hash(txn))
    )
    with pytest.raises(TypeError):
        ok.current_certificates["evil"] = wc
    # equality with plain-dict-constructed peers is unaffected
    assert wc == WriteCertificate(dict(wc.grants))


def test_frozen_containers_keep_mcode_cache_sound():
    """The encode-cache desync scenario: encode once (populates the _mcode
    cache), attempt a container mutation, and confirm the encoding cannot
    silently desync — the mutation raises instead."""
    config, kps = _cluster()
    client_kp = generate_keypair()
    env = _signed_write2(config, kps, client_kp, "c", "fz-cache")
    from mochi_tpu_torch.protocol import encode_envelope

    first = encode_envelope(env)  # populates payload.__dict__["_mcode"]
    assert "_mcode" in env.payload.__dict__
    # item assignment raises TypeError; mutating METHODS don't even exist
    # on the proxy (AttributeError) — both shapes block the desync
    with pytest.raises((TypeError, AttributeError)):
        env.payload.write_certificate.grants.clear()
    assert encode_envelope(env) == first


# ----------------------------------------------------------------- histograms


def test_metrics_histogram_snapshot_and_prometheus():
    from mochi_tpu_torch.utils.metrics import Metrics

    m = Metrics()
    h = m.histogram("test.occupancy")
    for v in (1, 1, 3, 17, 5000):
        h.observe(v)
    snap = m.snapshot()["histograms"]["test.occupancy"]
    assert snap["count"] == 5
    assert snap["buckets"]["1"] == 2  # two <=1 observations
    assert snap["buckets"]["+Inf"] == 1  # 5000 overflows the last bound
    text = m.to_prometheus({"server": "s0"})
    assert 'mochi_histogram_bucket{name="test.occupancy",server="s0",le="+Inf"} 5' in text
    assert 'mochi_histogram_count{name="test.occupancy",server="s0"} 5' in text
    # cumulative le buckets are monotonic
    counts = [
        int(line.rsplit(" ", 1)[1])
        for line in text.splitlines()
        if line.startswith("mochi_histogram_bucket")
    ]
    assert counts == sorted(counts)


# ------------------------------------------------------- standing-rules data


def test_standing_rules_host_record_reads_results_file():
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "standing_rules",
        os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "scripts", "standing_rules.py"),
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rate, src = mod._host_core_n64_record()
    # the scanner reads the NEWEST committed host battery: r07
    # (the wheel-less-host record; its caveat lives in the file)
    assert src == "benchmarks/results_r07.json"
    assert rate == pytest.approx(1.09)


# ------------------------------------------------- early-quorum safety pins
#
# The early-quorum predicates are LIVENESS devices — a
# predicate that lies (fires before a real quorum exists) may only slow or
# fail a transaction, never let the client accept a result on fewer than
# 2f+1 verified responses.  Both halves pinned: the Write2 tally and the
# Write1 grant assembly.


def _staggered_sim():
    """Per-replica delays spread far enough apart that each response
    arrives in its own event-loop wake — on bare loopback every reply
    lands in ONE wake and even a lying predicate sees the full set, which
    would void these pins."""
    from mochi_tpu_torch.netsim import LinkEvent, LinkSpec, NetSim

    sim = NetSim.mesh(seed=17, rtt_ms=2.0)
    return sim, [
        LinkEvent(0.0, "set", pat_src, pat_dst, LinkSpec(delay_ms=d / 2.0))
        for i, d in enumerate((4.0, 30.0, 60.0, 90.0))
        for pat_src, pat_dst in ((f"server-{i}", "*"), ("*", f"server-{i}"))
    ]


def test_lying_write2_predicate_cannot_commit_below_quorum(monkeypatch):
    from mochi_tpu_torch.client import txn as txn_mod
    from mochi_tpu_torch.client.errors import InconsistentWrite, RequestRefused
    from mochi_tpu_torch.client.txn import TransactionBuilder
    from mochi_tpu_torch.testing.virtual_cluster import VirtualCluster

    async def main():
        sim, events = _staggered_sim()
        async with VirtualCluster(4, rf=4, netsim=sim) as vc:  # f=1, quorum=3
            client = vc.client(write_attempts=3, refusal_retries=2)
            await client.execute_write_transaction(
                TransactionBuilder().write("pin-warm", b"w").build()
            )
            for ev in events:
                sim.apply_event(ev)
            # QuorumTally.add lies: "satisfied" at the FIRST response, so
            # every fan-out early-returns with ~1 reply.
            monkeypatch.setattr(
                txn_mod.QuorumTally, "add", lambda self, *a, **k: True
            )
            with pytest.raises((InconsistentWrite, RequestRefused)):
                await client.execute_write_transaction(
                    TransactionBuilder().write("pin-key", b"v").build()
                )

    asyncio.run(asyncio.wait_for(main(), timeout=60))


def test_lying_grant_assembler_cannot_build_thin_certificate(monkeypatch):
    from mochi_tpu_torch.client import txn as txn_mod
    from mochi_tpu_torch.client.errors import RequestRefused
    from mochi_tpu_torch.client.txn import TransactionBuilder
    from mochi_tpu_torch.testing.virtual_cluster import VirtualCluster

    async def main():
        sim, events = _staggered_sim()
        async with VirtualCluster(4, rf=4, netsim=sim) as vc:
            client = vc.client(write_attempts=3, refusal_retries=2)
            await client.execute_write_transaction(
                TransactionBuilder().write("pin-warm2", b"w").build()
            )
            for ev in events:
                sim.apply_event(ev)
            # GrantAssembler.add lies without recording a chosen subset:
            # Write1 early-returns on the first grant, and the client's
            # authoritative recomputation must refuse to certify.
            monkeypatch.setattr(
                txn_mod.GrantAssembler, "add", lambda self, grant: True
            )
            with pytest.raises(RequestRefused):
                await client.execute_write_transaction(
                    TransactionBuilder().write("pin-key2", b"v").build()
                )

    asyncio.run(asyncio.wait_for(main(), timeout=60))


def test_early_quorum_kill_switch_disables_predicates():
    from mochi_tpu_torch.client.txn import TransactionBuilder
    from mochi_tpu_torch.testing.virtual_cluster import VirtualCluster

    async def main():
        async with VirtualCluster(4, rf=4) as vc:
            client = vc.client(early_quorum=False)
            await client.execute_write_transaction(
                TransactionBuilder().write("ks", b"v").build()
            )
            res = await client.execute_read_transaction(
                TransactionBuilder().read("ks").build()
            )
            assert res.operations[0].value == b"v"
            # no predicate ever installed: the early-return counter and
            # straggler families must be absent
            assert "fanout.early-return" not in client.metrics.counters
            assert not any(
                n.startswith("fanout") for n in client.metrics.histograms
            )

    asyncio.run(asyncio.wait_for(main(), timeout=60))


def test_store_batches_equal_the_reference():
    """The Write1 batch of the singles case (a seed out of range among
    good requests) and a Write2 batch through the port's stores and the
    reference's: the same grants, the same BadRequest, the same answers."""
    from mochi_tpu_torch.protocol import Write2ToServer, WriteCertificate
    from tests.torch_crosswire import PairedStores

    st = PairedStores()
    txn = Transaction((Operation(Action.WRITE, "pb-k", b"v"),))
    blind = Transaction((Operation(Action.WRITE, "pb-k", None),))
    th = transaction_hash(txn)
    reqs = [Write1ToServer("c", blind, 5, th), Write1ToServer("c", blind, 2000, th), Write1ToServer("c", blind, 9, th)]
    outs = st.both("process_write1_batch", reqs)
    assert all(isinstance(o[1], BadRequest) for o in outs)
    cert = WriteCertificate({o[0].multi_grant.server_id: o[0].multi_grant for o in outs})
    st.both("process_write2_batch", [Write2ToServer(cert, txn), Write2ToServer(cert, txn)])
