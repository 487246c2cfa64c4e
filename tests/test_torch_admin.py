"""The port's admin HTTP shell (``mochi_tpu_torch/admin/http.py``) on the CPU.

Ported from the JAX package's ``tests/test_admin.py`` (``/status``,
``/metrics``, ``/metrics.prom``, ``/trace``, ``/json`` and ``/`` of a live
replica, the durable and paged storage surfaces, the fan-out surfaces and
the client shell) and ``tests/test_metrics_prom.py`` (a real parser
roundtrips every ``mochi_*`` family, label values are escape-safe, and
identity-labelled families are capped with an ``other`` series).  Added: over
a ``VirtualCluster(4, rf=4)`` of each package with CPU verifiers, after the
same writes, ``/status`` has the same keys outside the verifier section and
``/metrics.prom`` the same series; the verifier section of a
``CudaBatchVerifier`` replica carries the port's comb fields; the replica
and service shells bind to loopback.
"""

from __future__ import annotations

import asyncio
import json
import re
import urllib.request

import pytest

from mochi_tpu.admin import AdminServer as JAdminServer
from mochi_tpu.client.txn import TransactionBuilder as JTransactionBuilder
from mochi_tpu.testing.virtual_cluster import VirtualCluster as JVirtualCluster
from mochi_tpu_torch.admin import AdminServer
from mochi_tpu_torch.admin.http import (
    PROM_MAX_SERIES,
    _byzantine_prom,
    _cap_identities,
    _clients_prom,
    _fanout_prom,
    _num_activity,
)
from mochi_tpu_torch.client.txn import TransactionBuilder
from mochi_tpu_torch.testing.virtual_cluster import VirtualCluster
from mochi_tpu_torch.utils.metrics import STRAGGLER_BOUNDS_MS, Metrics


def _get(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as resp:
        body = resp.read().decode()
        return resp.status, resp.headers.get("Content-Type"), body


def test_admin_endpoints():
    asyncio.run(asyncio.wait_for(_main(), timeout=60))


async def _main():
    async with VirtualCluster(5, rf=4) as vc:
        client = vc.client()
        await client.execute_write_transaction(
            TransactionBuilder().write("adm-key", b"v").build()
        )
        replica = vc.replicas[0]
        admin = AdminServer(replica, port=0)
        await admin.start()
        try:
            port = admin.bound_port
            loop = asyncio.get_running_loop()

            status, ctype, body = await loop.run_in_executor(None, _get, port, "/status")
            assert status == 200 and ctype == "application/json"
            doc = json.loads(body)
            assert doc["server_id"] == replica.server_id
            assert doc["cluster"]["rf"] == 4 and doc["cluster"]["quorum"] == 3
            assert doc["store"]["keys"] >= 0
            # per-shard ownership/traffic accounting (token-ring): with
            # rf=4 of 5 servers each replica serves 4/5 of the ring, and
            # the committed write above must have counted as OWNED traffic
            # on an owning replica — foreign counters stay 0 when client
            # routing matches the ring
            shard = doc["shard"]
            assert shard["tokens_primary"] > 0
            assert 0 < shard["tokens_in_replica_set"] <= 1024
            if replica.server_id in replica.config.replica_set_for_key("adm-key"):
                assert shard["write1_owned"] >= 1 and shard["write2_applied"] >= 1
            assert shard["write1_foreign"] == 0 and shard["read_foreign"] == 0
            # admission-control surface (docs/OPERATIONS.md §4g): the
            # deterministic load signal, shed state, and bounded-table
            # sizes — admission defaults ON, nothing shed at this load
            ov = doc["overload"]
            assert ov["enabled"] is True and ov["shed_p"] == 0.0
            assert ov["overloaded"] is False and ov["write1_shed"] == 0
            assert ov["sessions"]["size"] >= 1  # the client's MAC session
            assert ov["sessions"]["size"] <= ov["sessions"]["max"]
            assert ov["sessions"]["evictions"] == 0
            for k in ("load", "batch_ewma", "inflight_envs",
                      "sendq_out_bytes", "sendq_total_bytes",
                      "paused_conns", "verify_inflight", "retry_after_ms"):
                assert k in ov, k
            # per-client grant/quota/reclaim surface (round 13, docs
            # §4h): knobs + wedge liveness metric + per-identity ledger
            cl = doc["clients"]
            for k in ("quota", "ttl_ms", "reclaims", "quota_refused",
                      "outstanding_total", "max_wedge_ms", "open_wedges",
                      "per_client", "quota_refusals_served"):
                assert k in cl, k
            assert cl["reclaims"] == 0 and cl["quota_refused"] == 0
            if replica.server_id in replica.config.replica_set_for_key("adm-key"):
                me = cl["per_client"].get(client.client_id, {})
                assert me.get("issued", 0) >= 1, cl["per_client"]
            # durable-storage surface (round 14, docs §4i): the key is
            # present in EVERY posture — the in-memory default reports
            # engine "memory" with zeroed anti-entropy accounting
            st = doc["storage"]
            assert st["engine"] == "memory"
            assert st["anti_entropy"]["delta_keys_pulled"] == 0
            assert st["anti_entropy"]["full_keys_pulled"] == 0

            status, _, body = await loop.run_in_executor(None, _get, port, "/metrics")
            assert status == 200
            json.loads(body)

            status, ctype, body = await loop.run_in_executor(
                None, _get, port, "/metrics.prom"
            )
            assert status == 200 and "text/plain" in ctype
            assert "mochi_counter_total{" in body or "mochi_timer_count{" in body
            assert f'server="{replica.server_id}"' in body
            # the overload gauges ride one stat-labeled family
            assert 'mochi_shed{stat="shed_p"' in body
            assert 'mochi_shed{stat="sendq_out_bytes"' in body
            assert 'mochi_shed{stat="sessions.size"' in body
            # per-client grant accounting: aggregate rows (client="") plus
            # one row per tracked identity
            assert 'mochi_client{client="",stat="reclaims"' in body
            assert 'mochi_client{client="",stat="quota"' in body
            # storage gauges ride one stat-labeled family in every posture
            assert 'mochi_storage{stat="anti_entropy.delta_keys_pulled"' in body
            if replica.server_id in replica.config.replica_set_for_key("adm-key"):
                assert f'mochi_client{{client="{client.client_id}"' in body
            # every sample line: name{labels} value
            for line in body.splitlines():
                if line and not line.startswith("#"):
                    assert "} " in line and line.startswith("mochi_"), line

            # round-15 causal tracing: the span-ring posture on /status and
            # the Chrome trace-event export at /trace (empty ring without
            # MOCHI_TRACE*, but the surface must exist and parse)
            tr = doc["trace"]
            for k in ("enabled", "sample_rate", "ring", "spans_recorded"):
                assert k in tr, tr
            status, ctype, body = await loop.run_in_executor(
                None, _get, port, "/trace"
            )
            assert status == 200 and ctype == "application/json"
            trace_doc = json.loads(body)
            assert isinstance(trace_doc["traceEvents"], list)
            assert trace_doc["otherData"]["process"] == f"replica:{replica.server_id}"

            status, _, body = await loop.run_in_executor(None, _get, port, "/json")
            assert status == 200 and json.loads(body)["hello"] == "mochi-tpu"

            status, ctype, body = await loop.run_in_executor(None, _get, port, "/")
            assert status == 200 and "text/html" in ctype and replica.server_id in body
            # human-readable cluster view (L6 parity with the reference's
            # static index.html): membership table with every member's URL,
            # live store + verifier sections
            for other in replica.config.servers.values():
                assert other.server_id in body and other.url in body
            assert "Membership" in body and "Store" in body and "Verifier" in body
            assert "Overload" in body and "shed_p" in body
            # the round-13 Clients table: quota knobs + wedge metric rows
            assert "Clients" in body and "max_wedge_ms" in body
            # the round-14 Storage table: engine posture row at minimum
            assert "Storage" in body and "engine" in body
        finally:
            await admin.close()


def test_admin_storage_surfaces_durable():
    """Round-14 satellite pin: a durable-engine replica's /status "storage"
    key, the ``mochi_storage{stat=...}`` prom family (WAL growth, fsync
    count, snapshot age, replay progress, anti-entropy deltas), the fsync
    latency histogram, and the "/" page Storage table."""

    async def body(td):
        async with VirtualCluster(4, rf=4, storage_dir=td) as vc:
            client = vc.client()
            for i in range(8):
                await client.execute_write_transaction(
                    TransactionBuilder().write(f"adm-st-{i}", b"v").build()
                )
            replica = vc.replicas[0]
            # a deterministic snapshot so snapshot_age_s/seq are live
            await replica.storage.snapshot(replica.store)
            admin = AdminServer(replica, port=0)
            await admin.start()
            try:
                port = admin.bound_port
                loop = asyncio.get_running_loop()
                _, _, raw = await loop.run_in_executor(None, _get, port, "/status")
                st = json.loads(raw)["storage"]
                assert st["engine"] == "durable"
                assert st["fsync"] == "always"
                assert st["wal_entries"] >= 8
                assert st["wal_bytes"] > 0
                assert st["fsyncs"] >= 1
                assert st["snapshots"] >= 1
                assert st["snapshot_age_s"] is not None
                assert st["replay"]["convicted"] == 0
                assert "anti_entropy" in st
                _, _, prom = await loop.run_in_executor(
                    None, _get, port, "/metrics.prom"
                )
                for stat in (
                    "wal_entries", "wal_bytes", "fsyncs", "snapshots",
                    "snapshot_age_s", "replay.entries", "replay.convicted",
                    "anti_entropy.delta_keys_pulled",
                ):
                    assert f'mochi_storage{{stat="{stat}"' in prom, stat
                # the fsync latency histogram rides the registry exposition
                # ('always' policy: the ack path itself fsync'd above)
                assert 'name="storage-fsync-ms"' in prom
                _, _, page = await loop.run_in_executor(None, _get, port, "/")
                assert "Storage" in page and "wal_entries" in page
            finally:
                await admin.close()

    import os
    import tempfile

    # 'always' so the ack path itself fsyncs: the fsync counter and latency
    # histogram are then deterministically non-empty (the default 'group'
    # policy fsyncs on a timer — a race in a test)
    os.environ["MOCHI_WAL_FSYNC"] = "always"
    try:
        with tempfile.TemporaryDirectory() as td:
            asyncio.run(asyncio.wait_for(body(td), timeout=120))
    finally:
        del os.environ["MOCHI_WAL_FSYNC"]


def test_admin_storage_surfaces_paged():
    """Round-17 satellite pin: a paged-engine replica's /status "storage"
    key (pages/cache/compaction/memtable blocks), the flattened
    ``mochi_storage{stat="pages.resident"}``-style prom leaves, and the
    "/" page Storage table rendering the paged counters."""

    async def body(td):
        async with VirtualCluster(
            4, rf=4, storage_dir=td, storage_engine="paged"
        ) as vc:
            client = vc.client()
            for i in range(8):
                await client.execute_write_transaction(
                    TransactionBuilder().write(f"adm-pg-{i}", b"v").build()
                )
            replica = vc.replicas[0]
            # a deterministic page flush so pages/cache counters are live
            await replica.storage.flush()
            await replica.storage.snapshot(replica.store)
            admin = AdminServer(replica, port=0)
            await admin.start()
            try:
                port = admin.bound_port
                loop = asyncio.get_running_loop()
                _, _, raw = await loop.run_in_executor(None, _get, port, "/status")
                st = json.loads(raw)["storage"]
                assert st["engine"] == "paged"
                assert st["pages"]["count"] >= 1
                assert st["pages"]["resident"] >= 1
                assert st["pages"]["convicted"] == 0
                assert st["cache"]["cap_bytes"] > 0
                assert st["cache"]["resident_bytes"] >= 0
                assert st["compaction"]["debt"] >= 0
                assert st["memtable"]["cap_bytes"] > 0
                _, _, prom = await loop.run_in_executor(
                    None, _get, port, "/metrics.prom"
                )
                for stat in (
                    "pages.count", "pages.resident", "pages.convicted",
                    "cache.cap_bytes", "cache.hits", "cache.misses",
                    "cache.evictions", "compaction.debt",
                    "compaction.runs", "memtable.dirty_keys",
                ):
                    assert f'mochi_storage{{stat="{stat}"' in prom, stat
                _, _, page = await loop.run_in_executor(None, _get, port, "/")
                assert "Storage" in page and "pages.count" in page
                assert "cache.cap_bytes" in page
            finally:
                await admin.close()

    import tempfile

    with tempfile.TemporaryDirectory() as td:
        asyncio.run(asyncio.wait_for(body(td), timeout=120))


def test_fanout_surfaces_and_client_admin_shell():
    asyncio.run(asyncio.wait_for(_fanout_main(), timeout=60))


async def _fanout_main():
    from mochi_tpu_torch.admin import ClientAdminServer

    async with VirtualCluster(4, rf=4) as vc:
        client = vc.client()
        await client.execute_write_transaction(
            TransactionBuilder().write("fanout-key", b"v").build()
        )
        loop = asyncio.get_running_loop()

        # replica /status always carries the fanout key (empty peers on a
        # pure responder — dashboards need no existence probe)
        admin = AdminServer(vc.replicas[0], port=0)
        await admin.start()
        try:
            _, _, body = await loop.run_in_executor(
                None, _get, admin.bound_port, "/status"
            )
            doc = json.loads(body)
            assert doc["fanout"] == {"early_returns": 0, "peers": {}}
        finally:
            await admin.close()

        # the client shell surfaces the INITIATOR-side evidence: populate
        # the exact names transport's straggler drain records
        m = client.metrics
        m.mark("fanout.early-return")
        m.mark("fanout.late-response.server-2")
        m.mark("fanout.straggler-timeout.server-3")
        m.histogram("fanout-straggler-ms.server-2", STRAGGLER_BOUNDS_MS).observe(3.1)
        cadmin = ClientAdminServer(client, port=0)
        await cadmin.start()
        try:
            port = cadmin.bound_port
            _, ctype, body = await loop.run_in_executor(None, _get, port, "/status")
            assert ctype == "application/json"
            doc = json.loads(body)
            assert doc["client_id"] == client.client_id
            assert doc["fanout"]["early_returns"] == 1
            peers = doc["fanout"]["peers"]
            assert peers["server-2"]["late_response"] == 1
            assert peers["server-2"]["straggler_ms"]["count"] == 1
            assert peers["server-3"]["straggler_timeout"] == 1

            _, ctype, body = await loop.run_in_executor(
                None, _get, port, "/metrics.prom"
            )
            assert ctype.startswith("text/plain")
            assert 'mochi_fanout{peer="server-2",stat="late_response"' in body
            assert 'stat="early_returns"' in body
            # the full lateness histogram rides the standard family
            assert 'name="fanout-straggler-ms.server-2"' in body

            _, ctype, body = await loop.run_in_executor(None, _get, port, "/")
            assert ctype == "text/html"
            assert "Fan-out" in body and "server-2" in body
            # the client shell's own grant/quota view (round 13): the
            # Clients table plus its /status "clients" key
            assert "Clients" in body and "quota_refusals" in body
            _, _, body = await loop.run_in_executor(None, _get, port, "/status")
            doc = json.loads(body)
            assert doc["clients"]["quota_refusals"] == 0
            assert "per_replica_quota_refused" in doc["clients"]
            # round-15: the client shell exports its span ring too
            assert "trace" in doc and "sample_rate" in doc["trace"]
            _, ctype, body = await loop.run_in_executor(None, _get, port, "/trace")
            assert ctype == "application/json"
            assert isinstance(json.loads(body)["traceEvents"], list)
        finally:
            await cadmin.close()

        # replica "/" page gained the Fan-out table too
        admin2 = AdminServer(vc.replicas[1], port=0)
        await admin2.start()
        try:
            _, _, body = await loop.run_in_executor(
                None, _get, admin2.bound_port, "/"
            )
            assert "Fan-out" in body
        finally:
            await admin2.close()


# ------------------------------------------------------------- the parser
#
# A faithful subset of the Prometheus text exposition format: enough to
# parse every line this repo emits and to UNESCAPE label values, so the
# roundtrip assertion is against parser-visible content, not substrings.

_SAMPLE_RE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)\{(.*)\}\s+(\S+)$")


def _unescape(v: str) -> str:
    out = []
    i = 0
    while i < len(v):
        c = v[i]
        if c == "\\" and i + 1 < len(v):
            nxt = v[i + 1]
            if nxt == "\\":
                out.append("\\")
            elif nxt == '"':
                out.append('"')
            elif nxt == "n":
                out.append("\n")
            else:
                raise ValueError(f"bad escape \\{nxt}")
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _parse_labels(raw: str) -> dict:
    labels = {}
    i = 0
    while i < len(raw):
        eq = raw.index("=", i)
        name = raw[i:eq]
        assert raw[eq + 1] == '"', raw
        j = eq + 2
        buf = []
        while raw[j] != '"':
            if raw[j] == "\\":
                buf.append(raw[j : j + 2])
                j += 2
            else:
                buf.append(raw[j])
                j += 1
        labels[name] = _unescape("".join(buf))
        i = j + 1
        if i < len(raw) and raw[i] == ",":
            i += 1
    return labels


def parse_exposition(body: str):
    """-> (samples, helped, typed): every sample line parsed, and the
    family names that carried # HELP / # TYPE headers."""
    samples = []
    helped, typed = set(), set()
    for line in body.splitlines():
        if not line:
            continue
        if line.startswith("# HELP "):
            helped.add(line.split()[2])
            continue
        if line.startswith("# TYPE "):
            typed.add(line.split()[2])
            continue
        assert not line.startswith("#"), f"unknown comment line: {line}"
        m = _SAMPLE_RE.match(line)
        assert m, f"unparseable sample line: {line!r}"
        name, raw_labels, value = m.groups()
        float(value)  # must be numeric
        samples.append((name, _parse_labels(raw_labels), float(value)))
    return samples, helped, typed


def _family(name: str) -> str:
    for suffix in ("_bucket", "_sum", "_count"):
        if name.endswith(suffix) and name != "mochi_timer_count":
            return name[: -len(suffix)]
    return name


# A deliberately hostile identity: quote, backslash, newline, and brace —
# everything that breaks naive exposition emitters.
EVIL_ID = 'peer"x\\y\nz{a="b"}'


def test_registry_exposition_roundtrips_every_family():
    m = Metrics()
    with m.timer("write-transactions"):
        pass
    m.mark("replica.write1-shed", 3)
    m.mark(f"suspect.bad-grant.{EVIL_ID}", 2)  # attacker-named counter
    m.set_gauge("overload.load", 0.25)
    m.histogram("replica.batch-occupancy").observe(4)
    body = m.to_prometheus({"server": EVIL_ID})
    samples, helped, typed = parse_exposition(body)
    assert samples
    families = {_family(name) for name, _, _ in samples}
    assert families <= helped, f"missing HELP: {families - helped}"
    assert families <= typed, f"missing TYPE: {families - typed}"
    # the hostile strings roundtrip exactly through escape + parse
    assert any(lab.get("server") == EVIL_ID for _, lab, _ in samples)
    assert any(
        lab.get("name") == f"suspect.bad-grant.{EVIL_ID}"
        for _, lab, _ in samples
    )
    by = {
        (name, lab.get("name", "")): v for name, lab, v in samples
    }
    assert by[("mochi_counter_total", f"suspect.bad-grant.{EVIL_ID}")] == 2


def test_fanout_family_escapes_and_caps_identities():
    m = Metrics()
    m.mark("fanout.early-return", 5)
    # one hostile peer + a Sybil flood far past the cap
    m.mark(f"fanout.late-response.{EVIL_ID}", 99)
    m.histogram(f"fanout-straggler-ms.{EVIL_ID}", STRAGGLER_BOUNDS_MS).observe(2.0)
    for i in range(PROM_MAX_SERIES * 4):
        m.mark(f"fanout.straggler-timeout.sybil-{i:04d}")
    body = _fanout_prom(m, "server", "server-0")
    samples, helped, typed = parse_exposition(body)
    assert "mochi_fanout" in helped and "mochi_fanout" in typed
    peers = {lab["peer"] for _, lab, _ in samples}
    # bounded: at most the cap (+1 for the aggregate peer="" row)
    assert len(peers - {""}) <= PROM_MAX_SERIES
    assert "other" in peers, "overflow identities must fold into 'other'"
    # the hostile high-activity peer keeps its own (escaped) row
    assert EVIL_ID in peers
    # the overflow row carries the folded counts (flood minus kept rows)
    other_total = sum(
        v for _, lab, v in samples
        if lab["peer"] == "other" and lab["stat"] == "straggler_timeout"
    )
    kept_sybils = sum(1 for p in peers if p.startswith("sybil-"))
    assert other_total == PROM_MAX_SERIES * 4 - kept_sybils


def test_byzantine_and_client_families_cap_identities():
    class _StubReplica:
        server_id = "server-0"

        def byzantine_stats(self):
            return {
                "equivocations": {
                    f"sybil-{i:04d}": 1 for i in range(PROM_MAX_SERIES * 2)
                },
                "bad_grants": {EVIL_ID: 7},
                "resync_bad_certificates": 1,
            }

        def client_grant_stats(self):
            return {
                "quota": 64,
                "ttl_ms": 1000,
                "reclaims": 0,
                "quota_refused": 0,
                "outstanding_total": 0,
                "max_wedge_ms": 0.0,
                "open_wedges": 0,
                "quota_refusals_served": 0,
                "banned_clients": 0,
                "per_client": {
                    f"client-{i:05d}": {"issued": i, "outstanding": 1}
                    for i in range(PROM_MAX_SERIES * 3)
                },
            }

    r = _StubReplica()
    samples, helped, typed = parse_exposition(_byzantine_prom(r))
    assert "mochi_byzantine" in helped and "mochi_byzantine" in typed
    eq_peers = {
        lab["peer"] for _, lab, _ in samples if lab["stat"] == "equivocations"
    }
    assert len(eq_peers) <= PROM_MAX_SERIES and "other" in eq_peers
    assert any(lab["peer"] == EVIL_ID for _, lab, _ in samples)

    samples, helped, typed = parse_exposition(_clients_prom(r))
    assert "mochi_client" in helped and "mochi_client" in typed
    clients = {lab["client"] for _, lab, _ in samples} - {""}
    assert len(clients) <= PROM_MAX_SERIES and "other" in clients
    # highest-activity identities keep their rows; the long tail folds
    assert f"client-{PROM_MAX_SERIES * 3 - 1:05d}" in clients
    other_issued = sum(
        v for _, lab, v in samples
        if lab["client"] == "other" and lab["stat"] == "issued"
    )
    assert other_issued > 0


def test_cap_identities_keeps_top_activity_and_merges_other():
    table = {f"id-{i:03d}": {"n": i} for i in range(PROM_MAX_SERIES + 40)}
    capped = _cap_identities(table, _num_activity)
    assert len(capped) == PROM_MAX_SERIES
    assert "other" in capped
    # the top-activity identity survives; the least-active folded
    assert f"id-{PROM_MAX_SERIES + 39:03d}" in capped
    assert "id-000" not in capped
    folded = set(table) - set(capped)
    assert capped["other"]["n"] == sum(int(k[3:]) for k in folded)
    # under the cap: untouched (no 'other' row manufactured)
    small = {"a": {"n": 1}, "b": {"n": 2}}
    assert _cap_identities(small, _num_activity) == small


@pytest.mark.parametrize("n_scrapes", [1, 3])
def test_full_admin_exposition_parses(n_scrapes):
    """End-to-end: a live replica's whole /metrics.prom body parses and
    every mochi_* family carries HELP + TYPE."""
    import asyncio


    async def main():
        async with VirtualCluster(4, rf=4) as vc:
            client = vc.client()
            await client.execute_write_transaction(
                TransactionBuilder().write("pm-k", b"v").build()
            )
            admin = AdminServer(vc.replicas[0], port=0)
            await admin.start()
            try:
                import urllib.request

                loop = asyncio.get_running_loop()

                def _get():
                    with urllib.request.urlopen(
                        f"http://127.0.0.1:{admin.bound_port}/metrics.prom",
                        timeout=5,
                    ) as resp:
                        return resp.read().decode()

                for _ in range(n_scrapes):
                    body = await loop.run_in_executor(None, _get)
                    samples, helped, typed = parse_exposition(body)
                    families = {_family(name) for name, _, _ in samples}
                    assert families, "exposition must carry samples"
                    assert families <= helped, families - helped
                    assert families <= typed, families - typed
            finally:
                await admin.close()

    asyncio.run(asyncio.wait_for(main(), timeout=60))


# ------------------------------------------------ against the reference


def _key_paths(obj, client_id: str, prefix: str = "", opaque=("per_client", "peers", "buckets")) -> set:
    """Every key path of a JSON document's dicts, the client's own id made
    generic; the entries of identity-keyed dicts and of a histogram's
    non-empty buckets (``opaque``: they depend on timing) are not descended
    into."""
    out = set()
    if isinstance(obj, dict):
        for k, v in obj.items():
            path = f"{prefix}.{'<client>' if k == client_id else k}" if prefix else k
            out.add(path)
            if k not in opaque:
                out |= _key_paths(v, client_id, path, opaque)
    return out


def _series(body: str, client_id: str) -> set:
    """(name, labels) of every sample, the client's own id made generic."""
    samples, _, _ = parse_exposition(body)
    return {
        (name, tuple(sorted((k, "<client>" if v == client_id else v) for k, v in labels.items())))
        for name, labels, _ in samples
    }


async def _surfaces(cluster_cls, builder, admin_cls):
    async with cluster_cls(4, rf=4) as vc:
        client = vc.client()
        for i in range(3):
            await client.execute_write_transaction(builder().write(f"df-{i}", b"v%d" % i).build())
        await client.execute_read_transaction(builder().read("df-0").build())
        admin = admin_cls(vc.replicas[0], port=0)
        await admin.start()
        try:
            loop = asyncio.get_running_loop()
            _, _, status = await loop.run_in_executor(None, _get, admin.bound_port, "/status")
            _, _, prom = await loop.run_in_executor(None, _get, admin.bound_port, "/metrics.prom")
        finally:
            await admin.close()
        return json.loads(status), prom, client.client_id


def test_status_keys_and_prom_series_equal_the_reference():
    """The same writes through a ``VirtualCluster(4, rf=4)`` of each
    package (CPU verifiers): replica 0's ``/status`` has the same key paths
    outside the verifier section, and its ``/metrics.prom`` the same series
    (names and labels, the client's id aside)."""

    async def body():
        return (await _surfaces(VirtualCluster, TransactionBuilder, AdminServer),
                await _surfaces(JVirtualCluster, JTransactionBuilder, JAdminServer))

    (mine, mine_prom, mine_client), (ref, ref_prom, ref_client) = asyncio.run(asyncio.wait_for(body(), 120))
    outside = lambda paths: {p for p in paths if p != "verifier" and not p.startswith("verifier.")}  # noqa: E731
    assert outside(_key_paths(mine, mine_client)) == outside(_key_paths(ref, ref_client))
    assert mine["verifier"] == ref["verifier"]  # both an inline CpuVerifier on the same host engine
    assert _series(mine_prom, mine_client) == _series(ref_prom, ref_client)


def test_verifier_section_carries_the_port_comb_fields():
    """A replica over ``CudaBatchVerifier(device="cpu")`` (the kernels'
    plain versions) with the identities registered: ``/status`` names the
    verifier and its comb registry and counters as ``verifier_stats`` does,
    with no ``ready_buckets`` (a CUDA kernel needs no per-shape compile), and
    ``/metrics.prom`` carries them as ``mochi_verifier`` gauges."""
    from mochi_tpu_torch.verifier.cuda import CudaBatchVerifier

    async def body():
        verifier = CudaBatchVerifier(device="cpu")
        async with VirtualCluster(4, rf=4, verifier_factory=lambda: verifier) as vc:
            verifier.register_signers(list(vc.config.public_keys.values()))
            client = vc.client(timeout_s=240.0)
            await client.execute_write_transaction(TransactionBuilder().write("cb", b"v").build())
            admin = AdminServer(vc.replicas[0], port=0)
            await admin.start()
            try:
                loop = asyncio.get_running_loop()
                _, _, status = await loop.run_in_executor(None, _get, admin.bound_port, "/status")
                _, _, prom = await loop.run_in_executor(None, _get, admin.bound_port, "/metrics.prom")
            finally:
                await admin.close()
        return json.loads(status)["verifier"], prom

    st, prom = asyncio.run(asyncio.wait_for(body(), 300))
    assert st["type"] == "CudaBatchVerifier"
    comb = st["comb"]
    assert comb["registered_signers"] == 4 and "ready_buckets" not in comb
    assert comb["device_dispatches_process_total"] > 0 and comb["items_comb_routed_process_total"] > 0
    assert st["general"]["multiply"] in ("pad", "mxu")
    for name in ("comb.registered_signers", "comb.device_dispatches_process_total",
                 "comb.items_comb_routed_process_total"):
        assert f'mochi_verifier{{name="{name}",server="server-0"}}' in prom, name


@pytest.mark.parametrize("shell", ["replica", "client"])
def test_shells_bind_to_loopback_by_default(shell):
    """The unauthenticated admin endpoints listen on loopback unless a host
    is given: the replica's shell and the client's."""
    from mochi_tpu_torch.admin import ClientAdminServer

    async def body():
        async with VirtualCluster(4, rf=4) as vc:
            target = vc.replicas[0] if shell == "replica" else vc.client()
            server = (AdminServer if shell == "replica" else ClientAdminServer)(target, port=0)
            await server.start()
            try:
                return server._server.sockets[0].getsockname()[0]
            finally:
                await server.close()

    assert asyncio.run(asyncio.wait_for(body(), 60)) == "127.0.0.1"
