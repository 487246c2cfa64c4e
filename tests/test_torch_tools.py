"""The port's operator tools and causal tracing on the CPU: ``tools/trace.py``,
``tools/reconfigure.py``, ``tools/gen_cluster.py`` and ``obs/trace.py``.

Ported from the JAX package's ``tests/test_trace.py`` (seeded head sampling,
forced records, the wire context, the bounded ring, cost cards and span-tree
connectivity, an in-process cluster's connected trace, the conviction flight
recorder and its bound, a trace across two replica processes merged from
their SIGTERM flight dumps, and the merge CLI) and ``tests/test_tools_cli.py``
(``gen_cluster`` writes a loadable config, ``reconfigure`` removes a server
from a live cluster).  Added: the merge CLI of each package turns the same
flight dumps into the same output.
"""

from __future__ import annotations

import asyncio
import glob
import json
import os
import time

import pytest

from mochi_tpu.tools import trace as jtrace_tool
from mochi_tpu_torch.client.txn import TransactionBuilder
from mochi_tpu_torch.cluster.config import ClusterConfig
from mochi_tpu_torch.crypto.keys import keypair_from_seed
from mochi_tpu_torch.obs import trace as T
from mochi_tpu_torch.testing.virtual_cluster import VirtualCluster
from mochi_tpu_torch.tools import gen_cluster, reconfigure
from mochi_tpu_torch.tools import trace as trace_tool


def _all_events(vc, clients):
    evs = []
    for c in clients:
        evs.extend(c.tracer.events())
    for r in vc.replicas:
        evs.extend(r.tracer.events())
    return evs


# ------------------------------------------------------------------- core


def test_mint_sampling_is_seeded_and_head_based():
    a = T.Tracer("p", sample_rate=0.5, seed=123)
    b = T.Tracer("p", sample_rate=0.5, seed=123)
    va = [a.mint().sampled for _ in range(64)]
    vb = [b.mint().sampled for _ in range(64)]
    assert va == vb, "same seed + label must give the same sampling stream"
    assert 0 < sum(va) < 64, "rate 0.5 should sample some and skip some"
    off = T.Tracer("p", sample_rate=0.0)
    assert off.mint() is None and not off.enabled


def test_record_skips_unsampled_and_force_upgrades():
    tr = T.Tracer("p", sample_rate=1.0, seed=1)
    ctx = tr.mint()
    unsampled = T.TraceContext("aa" * 8, "bb" * 8, None, sampled=False)
    assert tr.record("x", unsampled, time.time(), 0.001) is None
    assert tr.record("x", None, time.time(), 0.001) is None
    assert len(tr.ring) == 0
    # forced: records with forced=True even for unsampled/absent contexts
    assert tr.force_mark("err", unsampled) is not None
    assert tr.force_mark("err", None) is not None
    assert all(ev["args"]["forced"] for ev in tr.ring)
    assert tr.spans_forced == 2
    # sampled context records plainly
    sid = tr.record("ok", ctx, time.time(), 0.002, args={"rtt": 1})
    assert sid is not None and tr.ring[-1]["args"]["parent_id"] == ctx.span_id


def test_wire_roundtrip_and_malformed_tolerance():
    ctx = T.TraceContext("ab" * 8, "cd" * 8, None, sampled=True)
    back = T.TraceContext.from_wire(ctx.to_wire())
    assert back.trace_id == ctx.trace_id and back.span_id == ctx.span_id
    assert back.sampled
    for junk in ((), (b"", b"x", 1), ("a", "b", 1), (b"x" * 99, b"y", 1),
                 (b"x", b"y", "z"), None, 42):
        assert T.TraceContext.from_wire(junk) is None


def test_ring_is_bounded_under_openloop_shaped_burst():
    """Config-9 shape in miniature: far more span traffic than the ring
    holds — memory stays O(ring), newest evidence wins."""
    tr = T.Tracer("p", sample_rate=1.0, seed=7, ring=128)
    for i in range(10_000):
        ctx = tr.mint()
        tr.record("burst", ctx, time.time(), 0.0001, args={"i": i})
    assert len(tr.ring) == 128
    assert tr.spans_recorded == 10_000
    # oldest aged out, newest retained
    kept = [ev["args"]["i"] for ev in tr.ring]
    assert min(kept) == 10_000 - 128 and max(kept) == 9_999


def test_cost_cards_and_tree_connectivity():
    tr = T.Tracer("client", sample_rate=1.0, seed=3)
    ctx = tr.mint()
    t0 = time.time()
    tr.record("txn.write", ctx, t0, 0.05, span_id=ctx.span_id)
    tr.record("client.fanout", ctx, t0, 0.01,
              args={"rtt": 1, "wire_bytes": 512})
    remote = T.Tracer("replica", sample_rate=1.0, seed=4)
    # the remote side parents under the client's span (wire propagation)
    rctx = T.TraceContext.from_wire(ctx.to_wire())
    remote.record("replica.handle_batch", rctx, t0, 0.004,
                  args={"verify_items": 3, "verify_unique": 2,
                        "verify_memoized": 1, "queue_us": 120.0})
    evs = T.merge_events([tr.export_chrome(), remote.export_chrome()])
    cards = T.cost_cards(evs)
    card = cards[ctx.trace_id]
    assert card["rtt"] == 1 and card["wire_bytes"] == 512
    assert card["verify_items"] == 3
    assert card["verify_unique"] == 2 and card["verify_memoized"] == 1
    assert card["queue_us"] == 120.0
    assert set(card["stages_us"]) == {
        "txn.write", "client.fanout", "replica.handle_batch"
    }
    assert T.span_tree_connected(evs, ctx.trace_id)
    # an orphan (parent never recorded) breaks connectivity
    orphan = T.TraceContext(ctx.trace_id, "99" * 8, None, True)
    lone = T.Tracer("x", sample_rate=1.0)
    lone.record("dangling", orphan.child(lone.new_span_id()), t0, 0.001)
    assert not T.span_tree_connected(
        evs + lone.events(), ctx.trace_id
    )


# --------------------------------------------------------- in-process e2e


def test_cluster_trace_end_to_end(monkeypatch):
    monkeypatch.setenv("MOCHI_TRACE_SAMPLE", "1.0")
    monkeypatch.setenv("MOCHI_TRACE_SEED", "11")
    asyncio.run(asyncio.wait_for(_cluster_main(), timeout=60))


async def _cluster_main():
    async with VirtualCluster(4, rf=4) as vc:
        client = vc.client()
        await client.execute_write_transaction(
            TransactionBuilder().write("tr-k", b"v").build()
        )
        res = await client.execute_read_transaction(
            TransactionBuilder().read("tr-k").build()
        )
        assert bytes(res.operations[0].value) == b"v"
        evs = _all_events(vc, [client])
        cards = T.cost_cards(evs)
        writes = [
            (tid, c) for tid, c in cards.items() if "txn.write" in c["stages_us"]
        ]
        reads = [
            (tid, c) for tid, c in cards.items() if "txn.read" in c["stages_us"]
        ]
        assert len(writes) == 1 and len(reads) == 1
        tid, card = writes[0]
        # the write's span tree is CONNECTED across client + all replicas
        assert T.span_tree_connected(evs, tid)
        assert any(p.startswith("client:") for p in card["processes"])
        assert sum(p.startswith("replica:") for p in card["processes"]) == 4
        # the cost card carries the tentpole's ledger: 2 RTTs (write1 +
        # write2 fan-outs), wire bytes, verify items with the unique/
        # memoized split, store apply + queue wait
        assert card["rtt"] == 2
        assert card["wire_bytes"] > 0
        assert card["verify_items"] > 0
        assert card["verify_unique"] + card["verify_memoized"] > 0
        assert "store.write1-apply" in card["stages_us"]
        assert "store.write2-apply" in card["stages_us"]
        for stage in ("write1-phase", "write2-fanout-wait", "write2-tally"):
            assert stage in card["stages_us"], card["stages_us"]
        # reads: 1 RTT, no verifies (MAC'd inline path)
        rtid, rcard = reads[0]
        assert rcard["rtt"] == 1 and rcard["verify_items"] == 0
        assert T.span_tree_connected(evs, rtid)


def test_unsampled_traffic_keeps_untraced_wire(monkeypatch):
    """sample_rate=0: no contexts mint, envelopes carry no trace field and
    no spans record anywhere — the zero-overhead posture."""
    monkeypatch.delenv("MOCHI_TRACE", raising=False)
    monkeypatch.delenv("MOCHI_TRACE_SAMPLE", raising=False)
    asyncio.run(asyncio.wait_for(_unsampled_main(), timeout=60))


async def _unsampled_main():
    async with VirtualCluster(4, rf=4) as vc:
        client = vc.client()
        await client.execute_write_transaction(
            TransactionBuilder().write("tr-u", b"v").build()
        )
        assert not client.tracer.enabled
        assert _all_events(vc, [client]) == []


# ------------------------------------------------- conviction flight path


def test_forge_cert_conviction_produces_connected_flight_dump(
    tmp_path, monkeypatch
):
    """The acceptance scenario: a forged certificate reaching a replica is
    convicted (BAD_CERTIFICATE), and the flight-recorder dump + client ring
    merge into a span tree containing the convicted message's path from
    client send to replica verdict."""
    monkeypatch.setenv("MOCHI_TRACE_SAMPLE", "1.0")
    monkeypatch.setenv("MOCHI_TRACE_SEED", "13")
    monkeypatch.setenv("MOCHI_TRACE_DIR", str(tmp_path))
    asyncio.run(asyncio.wait_for(_conviction_main(tmp_path), timeout=60))


async def _conviction_main(tmp_path):
    from mochi_tpu_torch.client.txn import TxnTrace
    from mochi_tpu_torch.protocol import (
        FailType, RequestFailedFromServer, Write2ToServer, WriteCertificate,
    )
    async with VirtualCluster(4, rf=4) as vc:
        client = vc.client()
        txn = TransactionBuilder().write("fc-k", b"v").build()
        await client.execute_write_transaction(txn)
        # the committed certificate with every grant signature forged —
        # the config-10 forge-cert leg distilled to the seam that convicts
        sv = vc.replicas[0].store._get("fc-k")
        forged = WriteCertificate(
            {
                sid: mg.with_signature(b"\x00" * 64)
                for sid, mg in sv.current_certificate.grants.items()
            }
        )
        with TxnTrace(client.tracer, "txn.write") as tt:
            with tt.stage("write2-fanout-wait"):
                responses = await client._fan_out(
                    txn, lambda: Write2ToServer(forged, txn)
                )
        assert responses, "replicas must answer the forged Write2"
        assert all(
            isinstance(p, RequestFailedFromServer)
            and p.fail_type == FailType.BAD_CERTIFICATE
            for p in responses.values()
        ), responses
        dumps = sorted(glob.glob(os.path.join(str(tmp_path), "flight-*.json")))
        assert dumps, "conviction must drive the flight recorder to disk"
        docs = [json.load(open(p)) for p in dumps]
        assert any(d["reason"] == "bad-certificate" for d in docs)
        evs = T.merge_events(docs)
        evs.extend(client.tracer.events())
        for r in vc.replicas:
            evs.extend(r.tracer.events())
        convictions = [
            ev for ev in evs if ev["name"] == "replica.conviction"
        ]
        assert convictions
        # the conviction is attributed to the client's transaction, and the
        # span tree is connected from the client's send to the verdict
        tid = tt.ctx.trace_id
        attributed = [
            ev for ev in convictions if ev["args"].get("trace_id") == tid
        ]
        assert attributed, "traced Write2 must attribute its conviction"
        assert T.span_tree_connected(evs, tid)
        names = {
            ev["name"]
            for ev in evs
            if ev["args"].get("trace_id") == tid
        }
        # client send side ... replica verdict side, one connected trace
        assert "client.fanout" in names and "replica.conviction" in names
        assert "write2-fanout-wait" in names and "txn.write" in names


def test_conviction_dumps_even_when_head_unsampled(tmp_path, monkeypatch):
    """always-sample-on-conviction: with tracing effectively off for this
    client (rate 0 → no wire context), a convicted certificate still
    force-records a verdict span and dumps the flight ring."""
    monkeypatch.delenv("MOCHI_TRACE", raising=False)
    monkeypatch.delenv("MOCHI_TRACE_SAMPLE", raising=False)
    monkeypatch.setenv("MOCHI_TRACE_DIR", str(tmp_path))
    asyncio.run(asyncio.wait_for(_unsampled_conviction(tmp_path), timeout=60))


async def _unsampled_conviction(tmp_path):
    from mochi_tpu_torch.protocol import (
        FailType, RequestFailedFromServer, Write2ToServer, WriteCertificate,
    )
    async with VirtualCluster(4, rf=4) as vc:
        client = vc.client()
        assert not client.tracer.enabled  # head sampling is OFF
        txn = TransactionBuilder().write("fc-u", b"v").build()
        await client.execute_write_transaction(txn)
        sv = vc.replicas[0].store._get("fc-u")
        forged = WriteCertificate(
            {
                sid: mg.with_signature(b"\x00" * 64)
                for sid, mg in sv.current_certificate.grants.items()
            }
        )
        responses = await client._fan_out(
            txn, lambda: Write2ToServer(forged, txn)
        )
        assert all(
            isinstance(p, RequestFailedFromServer)
            and p.fail_type == FailType.BAD_CERTIFICATE
            for p in responses.values()
        )
        dumps = glob.glob(os.path.join(str(tmp_path), "flight-*.json"))
        assert dumps
        docs = [json.load(open(p)) for p in dumps]
        assert any(d["reason"] == "bad-certificate" for d in docs)
        forced = [
            ev
            for ev in T.merge_events(docs)
            if ev["name"] == "replica.conviction" and ev["args"].get("forced")
        ]
        assert forced, "unsampled conviction must still force-record"


def test_conviction_flight_dumps_are_bounded(tmp_path, monkeypatch):
    """A forged-cert FLOOD must buy bounded disk: past CONVICTION_DUMPS_MAX
    per reason, convictions still force-record spans but stop writing
    full-ring dumps."""
    monkeypatch.setenv("MOCHI_TRACE_DIR", str(tmp_path))
    asyncio.run(asyncio.wait_for(_dump_bound_main(tmp_path), timeout=60))


async def _dump_bound_main(tmp_path):
    from mochi_tpu_torch.server.replica import CONVICTION_DUMPS_MAX
    async with VirtualCluster(4, rf=4) as vc:
        r = vc.replicas[0]
        for i in range(CONVICTION_DUMPS_MAX * 3):
            r._convict("bad-certificate", None, {"i": i})
        dumps = glob.glob(os.path.join(str(tmp_path), "flight-*.json"))
        assert len(dumps) == CONVICTION_DUMPS_MAX, len(dumps)
        # every conviction still recorded a (cheap) forced span
        marks = [
            ev for ev in r.tracer.events() if ev["name"] == "replica.conviction"
        ]
        assert len(marks) == CONVICTION_DUMPS_MAX * 3


# ------------------------------------------------------ cross-process e2e


def test_cross_process_trace_merges_into_one_tree(tmp_path, monkeypatch):
    monkeypatch.setenv("MOCHI_TRACE_SAMPLE", "1.0")
    monkeypatch.setenv("MOCHI_TRACE_SEED", "17")
    asyncio.run(asyncio.wait_for(_procs_main(tmp_path), timeout=120))


async def _procs_main(tmp_path):
    from mochi_tpu_torch.testing.process_cluster import ProcessCluster

    flight_dir = os.path.join(str(tmp_path), "flight")
    pc = ProcessCluster(
        4,
        rf=4,
        n_processes=2,
        verifier="cpu",
        env={
            "MOCHI_TRACE_SAMPLE": "1.0",
            "MOCHI_TRACE_SEED": "17",
            "MOCHI_TRACE_DIR": flight_dir,
        },
    )
    async with pc:
        client = pc.client()
        # one txn spanning both server processes (rf=4 of 4 servers: the
        # replica set covers every shard, hosted 2 per process)
        await client.execute_write_transaction(
            TransactionBuilder().write("xp-a", b"1").write("xp-b", b"2").build()
        )
        client_events = client.tracer.events()
        assert client_events
    # the SIGTERM drain dumped each replica's ring (server/__main__ →
    # MochiReplica.drain → flight dump) — merge them with the client ring
    dumps = sorted(glob.glob(os.path.join(flight_dir, "flight-*.json")))
    assert len(dumps) >= 2, dumps
    docs = [json.load(open(p)) for p in dumps]
    assert all(d["reason"] == "drain" for d in docs)
    evs = T.merge_events(docs) + client_events
    cards = T.cost_cards(evs)
    writes = {
        tid: c for tid, c in cards.items() if "txn.write" in c["stages_us"]
    }
    assert len(writes) == 1
    tid, card = next(iter(writes.items()))
    assert T.span_tree_connected(evs, tid), card
    replica_procs = {p for p in card["processes"] if p.startswith("replica:")}
    assert len(replica_procs) == 4, card["processes"]
    assert any(p.startswith("client:") for p in card["processes"])
    assert card["rtt"] == 2 and card["verify_items"] > 0


# ----------------------------------------------------------------- tools


def test_trace_merge_cli(tmp_path, capsys):
    main = trace_tool.main

    a = T.Tracer("client", sample_rate=1.0, seed=5)
    ctx = a.mint()
    a.record("txn.write", ctx, time.time(), 0.01, span_id=ctx.span_id)
    b = T.Tracer("replica", sample_rate=1.0, seed=6)
    b.record(
        "replica.handle_batch",
        T.TraceContext.from_wire(ctx.to_wire()),
        time.time(),
        0.002,
        args={"verify_items": 2},
    )
    pa = os.path.join(str(tmp_path), "a.json")
    pb = os.path.join(str(tmp_path), "b.json")
    a.dump_flight("test", path=pa)
    b.dump_flight("test", path=pb)

    assert main([pa, pb]) == 0
    merged = json.loads(capsys.readouterr().out)
    assert len(merged["traceEvents"]) == 2
    assert merged["otherData"]["traces"] == 1

    out = os.path.join(str(tmp_path), "cards.json")
    assert main([pa, pb, "--cards", "-o", out]) == 0
    cards = json.load(open(out))
    assert cards[ctx.trace_id]["verify_items"] == 2
    assert cards[ctx.trace_id]["connected"] is True

    # --trace-id filters to one transaction
    assert main([pa, pb, "--trace-id", "ffffffffffffffff"]) == 0
    empty = json.loads(capsys.readouterr().out)
    assert empty["traceEvents"] == []

    # unreadable input fails typed
    assert main([os.path.join(str(tmp_path), "missing.json")]) == 2


def test_global_summary_is_always_nonempty():
    s = T.global_summary()
    assert isinstance(s, dict) and s
    for k in ("enabled", "sample_rate", "spans_recorded", "traces_started"):
        assert k in s


# ------------------------------------------------------------ tool CLIs


def run(coro):
    asyncio.run(coro)


def test_gen_cluster_cli_produces_loadable_config(tmp_path):
    out = tmp_path / "cluster"
    gen_cluster.main(
        [
            "--out-dir", str(out),
            "--servers", "5",
            "--rf", "4",
            "--base-port", "19301",
            "--with-admin",
        ]
    )
    cfg = ClusterConfig.from_json((out / "cluster_config.json").read_text())
    assert cfg.n_servers == 5 and cfg.rf == 4 and cfg.quorum == 3
    assert cfg.admin_keys, "--with-admin must pin an admin key"
    # every seed file reconstructs the keypair whose public key the
    # config carries
    for sid in cfg.servers:
        seed = bytes.fromhex((out / f"{sid}.seed").read_text().strip())
        kp = keypair_from_seed(seed)
        assert cfg.public_keys[sid] == kp.public_key, sid
    admin_seed = bytes.fromhex((out / "admin.seed").read_text().strip())
    assert keypair_from_seed(admin_seed).public_key in cfg.admin_keys


def test_reconfigure_cli_removes_server_live(tmp_path):
    async def main():
        async with VirtualCluster(5, rf=4) as vc:
            client = vc.client()
            await client.execute_write_transaction(
                TransactionBuilder().write("cli-key", b"v").build()
            )
            cfg_path = tmp_path / "cfg.json"
            cfg_path.write_text(vc.config.to_json())
            out_path = tmp_path / "cfg2.json"
            # reconfigure.main runs its own event loop — give it a thread
            await asyncio.to_thread(
                reconfigure.main,
                [
                    "--config", str(cfg_path),
                    "--remove", "server-4",
                    "--out", str(out_path),
                ],
            )
            new_cfg = ClusterConfig.from_json(out_path.read_text())
            assert "server-4" not in new_cfg.servers
            assert new_cfg.configstamp == vc.config.configstamp + 1
            # the cluster actually installed it and still serves the data
            for r in vc.replicas[:4]:
                assert r.config.configstamp == new_cfg.configstamp
            res = await client.execute_read_transaction(
                TransactionBuilder().read("cli-key").build()
            )
            assert res.operations[0].value == b"v"
            await client.close()

    run(main())


# ------------------------------------------------ against the reference


def _flight_dumps(tmp_path, seed: int):
    """Three processes' flight dumps of two traced transactions (a client,
    two replicas parented under it over the wire, one forced conviction
    mark), written with fixed wall times."""
    client = T.Tracer("client:c0", sample_rate=1.0, seed=seed)
    replicas = [T.Tracer(f"replica:server-{i}", sample_rate=1.0, seed=seed + 1 + i) for i in range(2)]
    t0 = 1_700_000_000.0
    for k in range(2):
        ctx = client.mint()
        client.record("txn.write", ctx, t0 + k, 0.05, span_id=ctx.span_id)
        client.record("client.fanout", ctx, t0 + k, 0.01, args={"rtt": 1, "wire_bytes": 256 + k})
        for i, r in enumerate(replicas):
            rctx = T.TraceContext.from_wire(ctx.to_wire())
            r.record("replica.handle_batch", rctx, t0 + k + 0.001 * i, 0.002,
                     args={"verify_items": 43, "verify_unique": 43 - i, "verify_memoized": i, "queue_us": 10.0 * i})
        if k == 1:
            replicas[0].force_mark("replica.conviction", T.TraceContext.from_wire(ctx.to_wire()))
    paths = []
    for name, tr in (("client", client), ("r0", replicas[0]), ("r1", replicas[1])):
        path = os.path.join(str(tmp_path), f"flight-{name}.json")
        tr.dump_flight("test", path=path)
        paths.append(path)
    return paths


@pytest.mark.parametrize("mode", [[], ["--cards"], ["--trace-id", None]], ids=["merge", "cards", "one-trace"])
def test_trace_merge_cli_equals_the_reference(tmp_path, mode):
    """The same flight dumps through each package's merge CLI (a merged
    Chrome trace, the cost cards, one transaction's tree) give the same
    output byte for byte."""
    paths = _flight_dumps(tmp_path, 21)
    if mode and mode[0] == "--trace-id":
        with open(paths[0]) as fh:
            first = json.load(fh)["traceEvents"][0]["args"]["trace_id"]
        mode = ["--trace-id", first]
    mine, ref = os.path.join(str(tmp_path), "mine.json"), os.path.join(str(tmp_path), "ref.json")
    assert trace_tool.main(paths + mode + ["-o", mine]) == 0
    assert jtrace_tool.main(paths + mode + ["-o", ref]) == 0
    with open(mine, "rb") as a, open(ref, "rb") as b:
        mine_bytes, ref_bytes = a.read(), b.read()
    assert mine_bytes == ref_bytes
    doc = json.loads(mine_bytes)
    if mode == ["--cards"]:
        assert len(doc) == 2 and all(card["connected"] for card in doc.values())
    else:
        assert doc["traceEvents"] and doc["otherData"]["merged_from"] == 3
