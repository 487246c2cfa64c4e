"""The port's durable storage (``mochi_tpu_torch/storage``, ``server/persistence.py``)
on the CPU.

Ported from the JAX package's ``tests/test_storage.py``,
``test_persistence.py`` and ``test_storage_paged.py``, the SIGKILL legs
included (every replica process of a ``ProcessCluster`` killed under load,
restarted from disk, every acked write read back, on both engines): WAL framing
under torn tails and bit flips at every offset, the snapshot frame,
verified recovery with a delta resync, tampered values, forged grant
signatures, reordered records and a torn non-final segment convicted, the
crash windows, and the paged engine's fault-in under a tiny cache, audit
and compaction.  Added: the on-disk formats are the JAX package's byte for
byte (each package recovers a directory the other wrote to the same
``persistence.snapshot_bytes``), and compactions are serialized.
"""

from __future__ import annotations

import asyncio
import contextlib
import os
import shutil
import tempfile
import zlib
from unittest import mock

import pytest

from mochi_tpu.client.txn import TransactionBuilder as JTransactionBuilder
from mochi_tpu.cluster.config import ClusterConfig as JClusterConfig
from mochi_tpu.server import persistence as jpersistence
from mochi_tpu.server.store import DataStore as JDataStore
from mochi_tpu.storage import wal as jwal
from mochi_tpu.storage.durable import DurableStorage as JDurableStorage
from mochi_tpu.storage.paged import PagedStorage as JPagedStorage
from mochi_tpu.testing.virtual_cluster import VirtualCluster as JVirtualCluster
from mochi_tpu.verifier.spi import CpuVerifier as JCpuVerifier
from mochi_tpu_torch.client.txn import TransactionBuilder
from mochi_tpu_torch.cluster.config import ClusterConfig
from mochi_tpu_torch.protocol import SyncEntry, Transaction, transaction_hash
from mochi_tpu_torch.protocol.codec import encode
from mochi_tpu_torch.server import persistence
from mochi_tpu_torch.server.replica import MochiReplica
from mochi_tpu_torch.server.store import DataStore
from mochi_tpu_torch.storage import DurableStorage, PagedStorage, build_storage, wal
from mochi_tpu_torch.storage.durable import frame_snapshot, unframe_snapshot
from mochi_tpu_torch.storage.paged import _write_page, read_page_entry, scan_page_footer
from mochi_tpu_torch.testing.invariants import InvariantChecker
from mochi_tpu_torch.testing.process_cluster import ProcessCluster
from mochi_tpu_torch.testing.virtual_cluster import VirtualCluster
from mochi_tpu_torch.verifier.spi import CpuVerifier

SID = "server-0"


def _run(coro, timeout: float = 120):
    asyncio.run(asyncio.wait_for(coro, timeout=timeout))


# ------------------------------------------------------------- WAL framing


def _build_segment(path: str, records, server_id: str = SID, index: int = 1):
    w = wal.SegmentWriter(path, server_id, index)
    for seq, rtype, body in records:
        w.append(wal.encode_record(seq, rtype, body))
    w.close()


def _sample_records(n: int = 5):
    # varying body sizes so record boundaries land at irregular offsets
    return [(i + 1, wal.RT_COMMIT, [[f"k{i}"], [[1, f"k{i}", b"x" * (7 * i)]], {}]) for i in range(n)]


def _segment_bytes(tmp_path, records=None) -> bytes:
    path = str(tmp_path / wal.segment_name(1))
    _build_segment(path, records or _sample_records())
    with open(path, "rb") as fh:
        return fh.read()


def test_wal_roundtrip_and_framing_equal_the_reference(tmp_path):
    data = _segment_bytes(tmp_path)
    scan = wal.scan_segment(data, SID)
    assert not scan.torn
    assert [r.seq for r in scan.records] == [1, 2, 3, 4, 5]
    assert scan.records[2].body[0] == ["k2"]
    # byte for byte the JAX package's segment, and read by it
    assert data == jwal.segment_header(SID, 1) + b"".join(
        jwal.encode_record(s, t, b) for s, t, b in _sample_records())
    assert [r.seq for r in jwal.scan_segment(data, SID).records] == [1, 2, 3, 4, 5]


def test_foreign_segment_rejected(tmp_path):
    path = str(tmp_path / wal.segment_name(1))
    _build_segment(path, _sample_records(1), server_id="server-9")
    with open(path, "rb") as fh:
        data = fh.read()
    with pytest.raises(ValueError, match="server-9"):
        wal.scan_segment(data, SID)


def test_torn_tail_every_offset(tmp_path):
    """Truncated at EVERY byte offset, the scan returns exactly the records
    fully inside the prefix, flags ``torn`` for any cut off a record
    boundary, and never yields a partial record."""
    data = _segment_bytes(tmp_path)
    hdr_end = wal.read_segment_header(data, SID)
    full = wal.scan_segment(data, SID)
    ends = [r.offset for r in full.records][1:] + [len(data)]
    clean_cuts = {hdr_end, *ends}
    for cut in range(hdr_end, len(data) + 1):
        scan = wal.scan_segment(data[:cut], SID)
        assert [r.seq for r in scan.records] == [r.seq for r, end in zip(full.records, ends) if end <= cut], cut
        assert scan.torn == (cut not in clean_cuts), cut
        assert bool(scan.detail) == scan.torn, cut


@pytest.mark.parametrize("delta", [0, 4, 8], ids=["length", "crc", "payload"])
def test_bitflip_at_every_record_boundary(tmp_path, delta):
    """One bit flipped at each record's length field, CRC field and
    payload: the scan stops cleanly BEFORE the damaged record."""
    data = _segment_bytes(tmp_path)
    full = wal.scan_segment(data, SID)
    for i, rec in enumerate(full.records):
        flipped = bytearray(data)
        flipped[rec.offset + delta] ^= 0x40
        scan = wal.scan_segment(bytes(flipped), SID)
        assert [r.seq for r in scan.records] == [r.seq for r in full.records[:i]], i
        assert scan.torn, i


def test_torn_segment_header_is_torn_not_fatal(tmp_path):
    data = _segment_bytes(tmp_path, _sample_records(2))
    hdr_end = wal.read_segment_header(data, SID)
    for cut in range(hdr_end):  # every header truncation incl. the empty file
        scan = wal.scan_segment(data[:cut], SID)
        assert scan.torn and not scan.records, cut
    with pytest.raises(ValueError) as exc:
        wal.scan_segment(data, "server-9")
    assert not isinstance(exc.value, wal.TornSegmentHeader)  # a mix-up stays loud


def test_snapshot_frame_crc():
    blob = b"snapshot-doc-bytes" * 10
    framed = frame_snapshot(blob)
    assert unframe_snapshot(framed) == blob
    for pos in (0, len(framed) // 2, len(framed) - 1):
        damaged = bytearray(framed)
        damaged[pos] ^= 0x01
        with pytest.raises(ValueError):
            unframe_snapshot(bytes(damaged))


# ------------------------------------------------------------ persistence


def _tiny_config():
    return ClusterConfig.build({f"server-{i}": f"127.0.0.1:{9000 + i}" for i in range(4)}, rf=4)


def test_snapshot_roundtrip(tmp_path):
    async def main():
        async with VirtualCluster(4, rf=4) as vc:
            client = vc.client()
            await client.execute_write_transaction(TransactionBuilder().write("pk1", b"v1").write("pk2", b"v2").build())
            await client.execute_write_transaction(TransactionBuilder().delete("pk2").build())
            replica = vc.replicas[0]
            path = str(tmp_path / "snap")
            assert persistence.write_snapshot(replica.store, path) > 0 and os.path.exists(path)
            fresh = DataStore(replica.server_id, vc.config)
            assert persistence.load_snapshot(fresh, path) >= 2
            assert fresh.data["pk1"].value == b"v1" and fresh.data["pk1"].exists
            assert not fresh.data["pk2"].exists
            assert fresh.data["pk1"].current_certificate is not None
            assert fresh.data["pk1"].current_epoch == replica.store.data["pk1"].current_epoch
            assert fresh.data["pk1"].last_transaction is not None
            # the JAX package's persistence serializes the same store to the same bytes
            with open(path, "rb") as fh:
                assert fh.read() == jpersistence.snapshot_bytes(replica.store)

    _run(main())


def test_snapshot_reload_enables_writes_without_resync(tmp_path):
    async def main():
        async with VirtualCluster(4, rf=4) as vc:
            client = vc.client()
            await client.execute_write_transaction(TransactionBuilder().write("durable", b"v1").build())
            path = str(tmp_path / "s0.snapshot")
            persistence.write_snapshot(vc.replica("server-0").store, path)
            fresh = await vc.restart_replica("server-0")
            assert persistence.load_snapshot(fresh.store, path) >= 1
            await client.execute_write_transaction(TransactionBuilder().write("durable", b"v2").build())
            res = await client.execute_read_transaction(TransactionBuilder().read("durable").build())
            assert res.operations[0].value == b"v2"

    _run(main())


def test_corrupt_snapshot_rejected(tmp_path):
    store = DataStore("server-x", _tiny_config())
    path = str(tmp_path / "bad")
    with open(path, "wb") as fh:
        fh.write(b"\x08\x01\x06\x05magic\x06\x03bad")
    with pytest.raises(ValueError):
        persistence.load_snapshot(store, path)
    assert persistence.load_snapshot(store, str(tmp_path / "missing")) is None


def test_boot_installs_newer_config_from_snapshot(tmp_path):
    """A snapshot taken after a reconfiguration holds the cs=2 membership;
    a replica booting from it with the old cs=1 config installs it."""

    async def main():
        async with VirtualCluster(4, rf=4) as vc:
            client = vc.client()
            await client.execute_write_transaction(TransactionBuilder().write("bk", b"v").build())
            old_config = vc.config
            urls = {sid: info.url for sid, info in vc.config.servers.items()}
            await client.reconfigure_cluster(vc.config.evolve(urls))
            donor = vc.replicas[0]
            assert donor.config.configstamp == 2
            path = str(tmp_path / "snap")
            persistence.write_snapshot(donor.store, path)
            stale = ClusterConfig.from_json(old_config.to_json())
            stale.configstamp = 1
            fresh = MochiReplica(server_id=donor.server_id, config=stale, keypair=vc.keypairs[donor.server_id],
                                 host="127.0.0.1", port=0, snapshot_path=path)
            await fresh.start()
            try:
                assert fresh.config.configstamp == 2 and fresh.store.config.configstamp == 2
                sv = fresh.store._get("bk")
                assert sv is not None and sv.exists
            finally:
                await fresh.close()

    _run(main())


def test_group_fsync_of_a_segment_a_rotation_closed_counts_as_synced(tmp_path):
    """A snapshot's rotation syncs the old segment and closes it; a group
    fsync that was about to sync that segment then finds it closed, which
    covers its records: it completes instead of raising in the background
    tick."""

    async def body():
        engine = DurableStorage(str(tmp_path), SID, fsync="group")
        await engine.start()
        try:
            engine._staged.append(wal.encode_record(1, wal.RT_RECLAIM, ["k", 1, b"", 1]))
            engine._seq = 1
            await engine.flush()
            old = engine._writer
            old.sync()
            old.close()  # as _rotate does, racing the group fsync
            await engine._do_sync()
            assert engine._synced_seq == 1 and engine.fsyncs == 1
            engine._writer = await asyncio.get_running_loop().run_in_executor(None, engine._open_segment)
        finally:
            await engine.close()

    _run(body())


# ------------------------------------------- cluster-level recovery/tamper


async def _populated(td: str, n: int = 12, engine=None, prefix: str = "sk"):
    vc = VirtualCluster(4, rf=4, storage_dir=td, storage_engine=engine)
    await vc.start()
    client = vc.client()
    for i in range(n):
        await client.execute_write_transaction(TransactionBuilder().write(f"{prefix}{i}", b"v%d" % i).build())
    return vc, client


async def _freeze_storage(td: str, replica) -> str:
    """Copy a replica's live storage dir aside: the disk image of a crash
    at this instant (the graceful restart that follows would otherwise
    snapshot and truncate it).  Copied under the engine's snapshot lock,
    so no snapshot, page flush or compaction renames or deletes a file
    mid-copy; an append may still tear the log's tail, as a crash does.
    (The JAX package's engine has no such lock: its images here are taken
    with no snapshot armed.)"""
    async with getattr(replica.storage, "_snapshot_lock", None) or contextlib.nullcontext():
        src = os.path.join(td, replica.server_id)
        dst = src + ".crash"
        shutil.copytree(src, dst)
    return dst


def _restore_storage(td: str, server_id: str, frozen: str) -> None:
    dst = os.path.join(td, server_id)
    shutil.rmtree(dst)
    shutil.move(frozen, dst)


def _rewrite_last_segment(directory: str, server_id: str, mutate) -> None:
    """Adversarial log rewrite with CORRECT CRCs (an adversary recomputes
    them trivially): ``mutate(records)`` edits ``[seq, rtype, body]``
    triples of the newest segment."""
    _index, path = wal.list_segments(directory)[-1]
    with open(path, "rb") as fh:
        data = fh.read()
    start = wal.read_segment_header(data, server_id)
    scan = wal.scan_segment(data, server_id)
    assert not scan.torn
    records = [[r.seq, r.rtype, r.body] for r in scan.records]
    mutate(records)
    with open(path, "wb") as fh:
        fh.write(data[:start] + b"".join(wal.encode_record(s, t, b) for s, t, b in records))


def _last_data_commit(records):
    for rec in reversed(records):
        if rec[1] == wal.RT_COMMIT and rec[2][0][0].startswith("sk"):
            return rec
    raise AssertionError("no data commit found in segment")


def _all_values(store, n: int, prefix: str = "sk", fmt: bytes = b"v%d"):
    for i in range(n):
        sv = store._get(f"{prefix}{i}")
        assert sv is not None and sv.value == fmt % i, f"{prefix}{i}"


def test_recover_from_disk_and_delta_resync():
    """Restart from disk: committed state replays verified with no
    conviction, and the resync ships only the DELTA written meanwhile."""

    async def body(td):
        vc, client = await _populated(td, n=16)
        try:
            gap_keys = [f"gap{i}" for i in range(4)]

            async def commit_gap(_sid):
                for k in gap_keys:  # the victim is down: a 3/4 quorum commits
                    await client.execute_write_transaction(TransactionBuilder().write(k, b"late").build())

            fresh = await vc.restart_replica("server-1", resync=True, before_boot=commit_gap)
            report = fresh.storage.replay_report()
            assert report["convicted"] == 0 and report["entries"] >= 16, report
            _all_values(fresh.store, 16)
            for k in gap_keys:
                sv = fresh.store._get(k)
                assert sv is not None and sv.value == b"late", k
            ae = fresh.storage_stats()["anti_entropy"]
            assert ae["shards_matched"] > 0, ae
            assert 0 < ae["delta_keys_pulled"] <= 3 * (len(gap_keys) + 2), ae
            assert ae["full_keys_pulled"] == 0, ae
        finally:
            await vc.close()

    with tempfile.TemporaryDirectory() as td:
        _run(body(td))


def _mutate_value(records, tampered):
    rec = _last_data_commit(records)
    tampered.append(rec[2][0][0])
    rec[2][1][0][2] = b"EVIL"  # body[1] = txn ops; op[2] = value


def _mutate_grant_sigs(records, tampered):
    rec = _last_data_commit(records)
    tampered.append(rec[2][0][0])
    for mg_obj in rec[2][2].values():  # cert: {sid: mg_obj}
        mg_obj[3] = b"\x00" * 64  # MultiGrant signature slot


def _mutate_order(records, tampered):
    assert len(records) >= 2
    records[-1], records[-2] = records[-2], records[-1]


@pytest.mark.parametrize("mutate,reason", [
    (_mutate_value, "did not advance"),
    (_mutate_grant_sigs, "signature"),
    (_mutate_order, "regression"),
], ids=["value", "forged-grant-sigs", "reordered"])
def test_tampered_wal_convicted(mutate, reason):
    """Byzantine restart: a value mutated (the grants signed the original
    hash), every grant signature of a certificate forged, or two records
    swapped.  Verified replay convicts the entry with attribution and never
    serves it; invariant 5 counts the conviction as evidence, not as a
    violation."""

    async def body(td):
        vc, _client = await _populated(td)
        try:
            victim = vc.replica("server-1")
            await victim.storage.flush()
            frozen = await _freeze_storage(td, victim)
            tampered: list = []
            _rewrite_last_segment(frozen, "server-1", lambda records: mutate(records, tampered))
            fresh = await vc.restart_replica("server-1", before_boot=lambda sid: _restore_storage(td, sid, frozen))
            report = fresh.storage.replay_report()
            assert any(reason in c["reason"] for c in report["convictions"]), report
            if tampered:
                assert any(c["key"] == tampered[0] for c in report["convictions"]), report
                sv = fresh.store._get(tampered[0])
                assert sv is None or sv.value != b"EVIL"
            checker = InvariantChecker([fresh])
            checker.check_now()
            rep = checker.report()
            assert rep["storage_replay_convictions"] >= 1 and rep["ok"], rep
        finally:
            await vc.close()

    with tempfile.TemporaryDirectory() as td:
        _run(body(td))


def test_torn_nonfinal_segment_convicted():
    async def body(td):
        vc, _client = await _populated(td)
        try:
            victim = vc.replica("server-1")
            await victim.storage.flush()
            frozen = await _freeze_storage(td, victim)
            index, path = wal.list_segments(frozen)[-1]
            with open(path, "r+b") as fh:
                fh.truncate(os.path.getsize(path) - 3)  # tear its tail
            # a later, cleanly rotated segment makes the torn one non-final
            _build_segment(os.path.join(frozen, wal.segment_name(index + 1)),
                           [(10_000, wal.RT_RECLAIM, ["zz", 1, b"", 1])], server_id="server-1", index=index + 1)
            fresh = await vc.restart_replica("server-1", before_boot=lambda sid: _restore_storage(td, sid, frozen))
            report = fresh.storage.replay_report()
            assert any("torn non-final" in c["reason"] for c in report["convictions"]), report
        finally:
            await vc.close()

    with tempfile.TemporaryDirectory() as td:
        _run(body(td))


@pytest.mark.parametrize("crash", ["snapshot-before-truncate", "empty-final-segment"])
def test_crash_windows_recover_without_conviction(crash):
    """A crash between the snapshot and the truncation (the watermark
    no-ops the overlap), or during segment creation (an empty final
    segment is a torn tail): the replica boots, convicts nothing and
    serves every committed key."""

    async def body(td):
        vc, _client = await _populated(td)
        try:
            victim = vc.replica("server-1")
            await victim.storage.flush()
            frozen = await _freeze_storage(td, victim)
            if crash == "snapshot-before-truncate":
                await victim.storage.snapshot(victim.store)
                shutil.copy(os.path.join(td, "server-1", "snapshot.bin"), os.path.join(frozen, "snapshot.bin"))
            else:
                index = wal.list_segments(frozen)[-1][0]
                open(os.path.join(frozen, wal.segment_name(index + 1)), "wb").close()
            fresh = await vc.restart_replica("server-1", before_boot=lambda sid: _restore_storage(td, sid, frozen))
            report = fresh.storage.replay_report()
            assert report["convicted"] == 0, report
            assert report["torn_tail"] is (crash == "empty-final-segment"), report
            _all_values(fresh.store, 12)
        finally:
            await vc.close()

    with tempfile.TemporaryDirectory() as td:
        _run(body(td))


def test_snapshot_captures_under_append_lock():
    async def body(td):
        vc, _client = await _populated(td, n=4)
        try:
            victim = vc.replica("server-1")
            engine = victim.storage
            real = persistence.snapshot_bytes
            held = []

            def spy(store, extra=None):
                held.append(engine._append_lock.locked())
                return real(store, extra=extra)

            with mock.patch.object(persistence, "snapshot_bytes", spy):
                await engine.snapshot(victim.store)
            assert held == [True]
        finally:
            await vc.close()

    with tempfile.TemporaryDirectory() as td:
        _run(body(td))


def test_idempotent_reapply_not_restaged():
    async def body(td):
        vc, _client = await _populated(td)
        try:
            victim = vc.replica("server-1")
            sv = victim.store._get("sk3")
            before = victim.storage.wal_entries
            assert victim.store.apply_sync_entry(SyncEntry("sk3", sv.last_transaction, sv.current_certificate)) is False
            assert victim.storage.wal_entries == before
            await vc.restart_replica("server-1", resync=True)
            fresh = await vc.restart_replica("server-1")
            assert fresh.storage.replay_report()["convicted"] == 0
            _all_values(fresh.store, 12)
        finally:
            await vc.close()

    with tempfile.TemporaryDirectory() as td:
        _run(body(td))


# ------------------------------------------------------------ paged engine


@contextlib.contextmanager
def _paged_env(cache_bytes: int = 2048, memtable_bytes: int = 4096, **extra):
    """Pin tiny caps (read at every boot inside the block)."""
    keys = {"MOCHI_PAGE_CACHE_BYTES": str(cache_bytes), "MOCHI_MEMTABLE_BYTES": str(memtable_bytes), **extra}
    with mock.patch.dict(os.environ, keys):
        yield


async def _flush_to_pages(replica) -> None:
    """Force the memtable out: every committed key lands in a page and the
    WAL truncates behind the manifest watermark."""
    await replica.storage.flush()
    await replica.storage.snapshot(replica.store)


def _rewrite_page_with(directory: str, server_id: str, mutate) -> str:
    """Rewrite the first data page whose entry ``mutate`` changes, with
    every CRC and footer hash RECOMPUTED; returns the mutated key."""
    for name in sorted(os.listdir(directory)):
        if not (name.startswith("page-") and name.endswith(".pg")):
            continue
        path = os.path.join(directory, name)
        page_id, rows, _size = scan_page_footer(path, server_id)
        tampered, entries = None, []
        for key, off, length, crc, _txh, epoch in rows:
            obj = read_page_entry(path, off, length, crc)
            if tampered is None and mutate(key, obj):
                tampered = key
            blob = encode(obj)
            entries.append((key, blob, zlib.crc32(blob), transaction_hash(Transaction.from_obj(obj[1])), int(epoch)))
        if tampered is not None:
            _write_page(path, server_id, page_id, entries)
            return tampered
    raise AssertionError("no data page found to tamper with")


def test_engine_selection_param_env_and_rejection(tmp_path):
    s = build_storage(str(tmp_path / "a"), "server-0")
    assert isinstance(s, DurableStorage) and not isinstance(s, PagedStorage)
    assert s.name == "durable" and s.pager is False
    p = build_storage(str(tmp_path / "b"), "server-0", engine="paged")
    assert isinstance(p, PagedStorage) and p.name == "paged" and p.pager is True
    with mock.patch.dict(os.environ, {"MOCHI_STORAGE_ENGINE": "paged"}):
        assert isinstance(build_storage(str(tmp_path / "c"), "server-0"), PagedStorage)
        assert not isinstance(build_storage(str(tmp_path / "d"), "server-0", engine="wal"), PagedStorage)
    with pytest.raises(ValueError, match="lsm9000"):
        build_storage(str(tmp_path / "e"), "server-0", engine="lsm9000")
    assert build_storage(None, "server-0").name == "memory"


def test_paged_recover_faults_in_under_tiny_cache():
    async def body(td):
        vc, _client = await _populated(td, n=24, engine="paged", prefix="pk")
        try:
            await _flush_to_pages(vc.replica("server-1"))
            fresh = await vc.restart_replica("server-1")
            assert fresh.storage.replay_report()["convicted"] == 0
            assert fresh.storage.stats()["pages"]["count"] >= 1
            _all_values(fresh.store, 24, prefix="pk")
            st = fresh.storage.stats()
            assert st["cache"]["misses"] >= 24 and st["cache"]["evictions"] > 0, st
            assert st["pages"]["convicted"] == 0, st
            checker = InvariantChecker([fresh])
            checker.check_now()
            assert checker.report()["ok"]
        finally:
            await vc.close()

    with _paged_env(cache_bytes=512, memtable_bytes=2048):
        with tempfile.TemporaryDirectory() as td:
            _run(body(td))


def test_tampered_page_value_convicted_and_quorum_serves_honest():
    async def body(td):
        vc, client = await _populated(td, engine="paged", prefix="pk")
        try:
            await _flush_to_pages(vc.replica("server-1"))
            frozen = await _freeze_storage(td, vc.replica("server-1"))

            def mutate(key, obj) -> bool:
                if not key.startswith("pk"):
                    return False
                for op in obj[1]:  # txn obj: op list; op: [action, key, value]
                    if op[1] == key and op[2] is not None:
                        op[2] = b"EVIL"
                        return True
                return False

            tampered = _rewrite_page_with(frozen, "server-1", mutate)
            fresh = await vc.restart_replica("server-1", before_boot=lambda sid: _restore_storage(td, sid, frozen))
            sv = fresh.store._get(tampered)
            assert sv is None or sv.value != b"EVIL", sv
            report = fresh.storage.replay_report()
            assert any(c["key"] == tampered and "rejected" in c["reason"] for c in report["convictions"]), report
            assert fresh.storage.stats()["pages"]["convicted"] >= 1
            checker = InvariantChecker([fresh])
            checker.check_now()
            rep = checker.report()
            assert rep["storage_replay_convictions"] >= 1 and rep["ok"], rep
            res = await client.execute_read_transaction(TransactionBuilder().read(tampered).build())
            assert res.operations[0].value == b"v%d" % int(tampered[2:])
        finally:
            await vc.close()

    with _paged_env():
        with tempfile.TemporaryDirectory() as td:
            _run(body(td))


def test_forged_grant_signature_in_page_convicted_by_audit():
    """Grant signatures zeroed in a page entry (its hashes still agree, so
    the fault-in recheck cannot see it): the batch audit convicts it.  The
    boot audit is off for the restart, so the sweep under test is this
    one and not the background tick's."""

    async def body(td):
        vc, _client = await _populated(td, engine="paged", prefix="pk")
        try:
            await _flush_to_pages(vc.replica("server-1"))
            frozen = await _freeze_storage(td, vc.replica("server-1"))

            def mutate(key, obj) -> bool:
                if not key.startswith("pk"):
                    return False
                for mg_obj in obj[2].values():  # cert obj: {sid: mg_obj}
                    mg_obj[3] = b"\x00" * 64
                return True

            tampered = _rewrite_page_with(frozen, "server-1", mutate)
            with mock.patch.dict(os.environ, {"MOCHI_PAGE_AUDIT": "off"}):
                fresh = await vc.restart_replica("server-1", before_boot=lambda sid: _restore_storage(td, sid, frozen))
            audit = await fresh.storage.audit(fresh.store)
            assert audit["convicted"] >= 1, audit
            report = fresh.storage.replay_report()
            assert any(c["key"] == tampered and "signature" in c["reason"] for c in report["convictions"]), report
            sv = fresh.store._get(tampered)
            assert sv is None or sv.grants == {}, sv
        finally:
            await vc.close()

    with _paged_env():
        with tempfile.TemporaryDirectory() as td:
            _run(body(td))


async def _applied(replica, keys_values, timeout_s: float = 30.0) -> None:
    """Wait until ``replica`` has applied every (key, value).  A write acks
    at 2f+1 grants, and with the SDK's early-quorum return a replica
    outside that quorum may apply it later; a flush must not race it."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout_s
    while True:
        missing = [k for k, v in keys_values if (replica.store._get(k) is None or replica.store._get(k).value != v)]
        if not missing:
            return
        assert loop.time() < deadline, f"{replica.server_id} never applied {missing[:5]}"
        await asyncio.sleep(0.01)


def test_compaction_drops_superseded_and_reverifies():
    """Two generations of the same keys in pages, the older one dead:
    compaction merges the pages, drops the superseded versions,
    re-verifies every surviving entry's grant signatures, and every value
    reads back after a restart on the compacted image.  The background
    tick may have armed a compaction of its own; compactions run one at a
    time, so when ``compact()`` returns every compaction is done and the
    page set is the merged one whichever ran."""

    async def body(td):
        vc, client = await _populated(td, n=10, engine="paged", prefix="pk")
        try:
            victim = vc.replica("server-1")
            await _applied(victim, [(f"pk{i}", b"v%d" % i) for i in range(10)])
            await _flush_to_pages(victim)
            for i in range(10):
                await client.execute_write_transaction(TransactionBuilder().write(f"pk{i}", b"w%d" % i).build())
            await _applied(victim, [(f"pk{i}", b"w%d" % i) for i in range(10)])
            await _flush_to_pages(victim)
            st0 = victim.storage.stats()
            assert st0["pages"]["count"] >= 2 and st0["compaction"]["debt"] > 0, st0

            await victim.storage.compact()
            st1 = victim.storage.stats()
            assert st1["pages"]["count"] == 1 < st0["pages"]["count"], (st0, st1)
            assert st1["compaction"]["runs"] >= 1 and st1["compaction"]["rewritten"] >= 10, st1
            assert st1["compaction"]["reverified"] >= 10, st1
            assert st1["compaction"]["debt"] == 0 and st1["pages"]["convicted"] == 0, st1

            fresh = await vc.restart_replica("server-1")
            assert fresh.storage.replay_report()["convicted"] == 0
            _all_values(fresh.store, 10, prefix="pk", fmt=b"w%d")
        finally:
            await vc.close()

    with _paged_env():
        with tempfile.TemporaryDirectory() as td:
            _run(body(td))


def test_concurrent_compactions_write_one_page():
    """Two compactions started together (the background tick's and an
    explicit one) run one after the other: the second finds a single page
    and writes nothing, so no page of dead entries is left behind.  The
    JAX package's engine interleaves them and leaves one."""

    async def body(td):
        vc, client = await _populated(td, n=10, engine="paged", prefix="pk")
        try:
            victim = vc.replica("server-1")
            await _applied(victim, [(f"pk{i}", b"v%d" % i) for i in range(10)])
            await _flush_to_pages(victim)
            for i in range(10):
                await client.execute_write_transaction(TransactionBuilder().write(f"pk{i}", b"w%d" % i).build())
            await _applied(victim, [(f"pk{i}", b"w%d" % i) for i in range(10)])
            await _flush_to_pages(victim)
            before = victim.storage.stats()["compaction"]
            first, second = await asyncio.gather(victim.storage.compact(), victim.storage.compact())
            st = victim.storage.stats()
            assert first["rewritten"] == 10 and second == {"pages": 0, "rewritten": 0}, (first, second, before)
            assert st["pages"]["count"] == 1 and st["compaction"]["debt"] == 0, st
        finally:
            await vc.close()

    # the background compaction stays unarmed: the two calls here are the race
    with _paged_env(MOCHI_PAGE_COMPACT_DEBT="2"):
        with tempfile.TemporaryDirectory() as td:
            _run(body(td))


@pytest.mark.parametrize("engine", ["wal", "paged"])
def test_concurrent_snapshots_run_one_at_a_time(engine, monkeypatch):
    """Two snapshots (page flushes) started together run one after the
    other: the second captures the store only once the first's document
    or manifest is written.  Interleaved, the older document could land
    last after the newer one truncated the log it covers, and a flush could
    return before the keys it found dirty were in a page.  The file writes
    are slowed so that an interleaving, where one is allowed, is certain."""
    import time

    async def body(td):
        vc, _client = await _populated(td, n=6, engine=engine, prefix="pk")
        try:
            victim = vc.replica("server-1")
            await _applied(victim, [(f"pk{i}", b"v%d" % i) for i in range(6)])
            events = []
            if engine == "wal":
                real_capture = persistence.snapshot_bytes
                monkeypatch.setattr(persistence, "snapshot_bytes",
                                    lambda *a, **k: events.append("capture") or real_capture(*a, **k))
            else:
                real_capture = victim.storage._capture_dirty
                monkeypatch.setattr(victim.storage, "_capture_dirty",
                                    lambda store: events.append("capture") or real_capture(store))
            real_write = persistence.write_snapshot_blob

            def slow_write(blob, path):
                time.sleep(0.05)
                events.append("written")
                return real_write(blob, path)

            monkeypatch.setattr(persistence, "write_snapshot_blob", slow_write)
            await asyncio.gather(victim.storage.snapshot(victim.store), victim.storage.snapshot(victim.store))
            assert events == ["capture", "written", "capture", "written"], events
            monkeypatch.undo()
            fresh = await vc.restart_replica("server-1")
            assert fresh.storage.replay_report()["convicted"] == 0
            _all_values(fresh.store, 6, prefix="pk")
        finally:
            await vc.close()

    with tempfile.TemporaryDirectory() as td:
        _run(body(td))


# ------------------------------- each package recovers the other's disk


def _jax_recover(directory: str, sid: str, config_json: str, engine: str) -> bytes:
    cls = JPagedStorage if engine == "paged" else JDurableStorage
    return asyncio.run(_recover_bytes(cls, JDataStore, JCpuVerifier, jpersistence,
                                      JClusterConfig.from_json(config_json), directory, sid))


def _port_recover(directory: str, sid: str, config_json: str, engine: str) -> bytes:
    cls = PagedStorage if engine == "paged" else DurableStorage
    return asyncio.run(_recover_bytes(cls, DataStore, CpuVerifier, persistence,
                                      ClusterConfig.from_json(config_json), directory, sid))


async def _recover_bytes(engine_cls, store_cls, verifier_cls, persistence_mod, config, directory, sid) -> bytes:
    """One package's engine recovers ``directory`` (a copy, left as it
    found it) into an empty store of that package, every paged key faulted
    in; returns the store's snapshot bytes."""
    with tempfile.TemporaryDirectory() as td:
        copy = os.path.join(td, sid)
        shutil.copytree(directory, copy)
        store = store_cls(sid, config)
        engine = engine_cls(copy, sid, fsync="off")
        verifier = verifier_cls()
        try:
            report = await engine.recover(store, verifier=verifier)
            assert report["convicted"] == 0, report
            store.storage, engine.store = engine, store
            for key in sorted(getattr(engine, "_index", ())):
                assert store._get(key) is not None, key
            return persistence_mod.snapshot_bytes(store)
        finally:
            await verifier.close()


async def _write_image(cluster_cls, builder, td: str, engine: str):
    """Six committed keys paged (paged engine) or snapshotted (WAL engine),
    six more in the WAL tail, then server-1's directory frozen."""
    vc = cluster_cls(4, rf=4, storage_dir=td, storage_engine=engine)
    await vc.start()
    try:
        client = vc.client()
        victim = vc.replica("server-1")
        for gen, fmt in enumerate((b"a%d", b"b%d")):
            for i in range(6 * gen, 6 * gen + 6):
                await client.execute_write_transaction(builder().write(f"xk{i}", fmt % i).build())
            await _applied(victim, [(f"xk{i}", fmt % i) for i in range(6 * gen, 6 * gen + 6)])
            await victim.storage.flush()
            if gen == 0:
                await victim.storage.snapshot(victim.store)
        return await _freeze_storage(td, victim), vc.config.to_json()
    finally:
        await vc.close()


@pytest.mark.parametrize("engine", ["wal", "paged"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_recovers_the_others_directory(writer, engine):
    """A directory one package's cluster wrote (snapshot or pages, plus a
    WAL tail) recovers in both packages to the same snapshot bytes, at
    ``VirtualCluster(4, rf=4)`` with CPU verifiers."""
    cluster_cls, builder = (JVirtualCluster, JTransactionBuilder) if writer == "jax" else (VirtualCluster,
                                                                                          TransactionBuilder)
    with _paged_env(cache_bytes=1 << 20, memtable_bytes=1 << 20):
        with tempfile.TemporaryDirectory() as td:
            frozen, config_json = asyncio.run(asyncio.wait_for(_write_image(cluster_cls, builder, td, engine), 120))
            mine = _port_recover(frozen, "server-1", config_json, engine)
            theirs = _jax_recover(frozen, "server-1", config_json, engine)
    assert mine == theirs
    doc = persistence.read_snapshot_doc(mine, "server-1")
    values = {obj[0]: obj[1] for obj in doc["data"]}
    assert values == {f"xk{i}": (b"a%d" if i < 6 else b"b%d") % i for i in range(12)}


# --------------------------------------- cross-process SIGKILL -> recover


@pytest.mark.parametrize("engine", ["wal", "paged"])
def test_sigkill_full_cluster_zero_acked_write_loss(engine):
    """The acceptance pin, on either engine: a ``ProcessCluster`` under
    live load, EVERY replica process SIGKILLed mid-stream (no drain, no
    snapshot: the only durability is the write-before-ack WAL append), all
    four restarted from disk, and every acknowledged write must read back —
    zero lost."""

    async def body():
        async with ProcessCluster(
            4, rf=4, n_processes=4, verifier="cpu", storage_dir=True, wal_fsync="group",
            storage_engine=engine,
        ) as pc:
            client = pc.client(timeout_s=8.0)
            acked = {}

            async def load():
                i = 0
                while True:
                    key, value = f"pk{i}", b"v%d" % i
                    try:
                        await client.execute_write_transaction(TransactionBuilder().write(key, value).build())
                    except Exception:
                        return  # in flight at the kill: indeterminate
                    acked[key] = value
                    i += 1

            writer = asyncio.ensure_future(load())
            while len(acked) < 10:
                await asyncio.sleep(0.02)
            for i in range(4):
                pc.kill_replica(f"server-{i}")
            await writer  # errors out on the dead cluster
            await client.close()

            for i in range(4):
                await pc.restart_replica(f"server-{i}")
            reader = pc.client(timeout_s=8.0)
            lost = []
            for key, value in sorted(acked.items()):
                res = await reader.execute_read_transaction(TransactionBuilder().read(key).build())
                if res.operations[0].value != value:
                    lost.append(key)
            assert not lost, f"{len(lost)} acked writes lost: {lost[:5]}"
            pc.check_alive()
            assert len(pc.ready_seconds["proc-0"]) == 2  # the boot and the restart

    _run(body(), timeout=240)
