"""Regression pins for the port's wire-taint pass and the seam it fixed.

Three layers:

1. **The true positive, fixed** — the pass convicted exactly one live
   flow: WAL reclaim records replayed into ``store.reclaimed`` (and the
   epoch bump) with only CRC framing between the attacker and the ledger.
   CRCs are torn-tail detection, not authentication: an adversary who
   rewrites its own log recomputes them trivially (the exact threat model
   the storage tamper suite pins for *commit* records, which
   re-verify their certificates — reclaims had nothing).  The fix gives
   every reclaim record a node-keyed HMAC bound to its log position,
   re-verified at replay through ``_reclaim_auth_ok`` — the sanctioned
   ``wal``-class verifier edge in the registry.  These tests pin the
   round trip, the conviction of tampered/relocated/forged records, and
   the legacy-acceptance ratchet.

2. **Non-vacuity of the registry** — deleting any single sanctioned
   verifier edge must convict the downstream sink: a seeded mutation
   sweep over the good fixture (every sanitizer site covered), plus live-
   tree mutations that strip ``_grant_ok`` / ``_auth_mac`` /
   ``_check_certificate`` / ``_page_entry_admissible`` from the port's real
   client/replica/paged engine and require the full-tree scan of
   ``mochi_tpu_torch/`` to turn red.  This is what makes "the tree scans
   clean" meaningful: a scope left pointing at another package's paths
   would scan nothing and pass.  Stripping the paged engine's registration
   block (its page-read source and per-entry recheck) must surface the
   disk-tainted ``sync-adopt`` flow.

3. **Machinery** — fast-path edge registration (the fast-path contract),
   suppression + hygiene interaction, ``--changed-only`` gating, and the
   per-file cache (warm-run identity, mtime invalidation, worker-pool
   equivalence).
"""

from __future__ import annotations

import asyncio
import os
import random
import re
import shutil
import subprocess
import sys
import textwrap

import pytest

from mochi_tpu_torch.analysis import core, wire_taint
from mochi_tpu_torch.cluster import ClusterConfig
from mochi_tpu_torch.server.store import DataStore
from mochi_tpu_torch.storage import wal
from mochi_tpu_torch.storage.durable import RECLAIM_KEY_FILE, DurableStorage

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "analysis_fixtures")
SID = "server-0"


def make_store(sid: str = SID) -> DataStore:
    cfg = ClusterConfig.build(
        {f"server-{i}": f"127.0.0.1:{8001 + i}" for i in range(4)}, rf=4
    )
    return DataStore(sid, cfg)


def _rewrite_segment(directory: str, server_id: str, mutate) -> None:
    """Adversarial rewrite with CORRECT CRCs (an attacker recomputes them
    trivially — framing is not the integrity argument)."""
    _index, path = wal.list_segments(directory)[-1]
    with open(path, "rb") as fh:
        data = fh.read()
    start = wal.read_segment_header(data, server_id)
    scan = wal.scan_segment(data, server_id)
    assert not scan.torn
    records = [[r.seq, r.rtype, r.body] for r in scan.records]
    mutate(records)
    with open(path, "wb") as fh:
        fh.write(
            data[:start]
            + b"".join(wal.encode_record(s, t, b) for s, t, b in records)
        )


async def _staged_reclaim_dir(td: str) -> str:
    """A storage dir whose WAL holds one MAC'd reclaim record."""
    d = os.path.join(td, SID)
    eng = DurableStorage(d, SID)
    await eng.start()
    eng.stage_reclaim("k1", 7, b"h" * 32, 3)
    await eng.flush()
    await eng.close()
    return d


# ------------------------------------------------- 1. the fixed seam


def test_reclaim_roundtrip_replays_with_mac(tmp_path):
    async def body():
        d = await _staged_reclaim_dir(str(tmp_path))
        eng = DurableStorage(d, SID)
        assert not eng._reclaim_key_created  # key survived the restart
        store = make_store()
        report = await eng.recover(store)
        assert report["convicted"] == 0, report
        assert report["reclaims"] == 1
        assert report.get("legacy_reclaims", 0) == 0
        assert store.reclaimed[("k1", 7)] == b"h" * 32
        assert store._get_or_create("k1").current_epoch == 3

    asyncio.run(asyncio.wait_for(body(), timeout=60))


def test_tampered_reclaim_body_convicted(tmp_path):
    """Mutate the granted hash inside the logged reclaim (CRC recomputed):
    the MAC no longer covers the bytes, replay convicts, and NOTHING of
    the record — ledger entry, epoch bump — is adopted."""

    async def body():
        d = await _staged_reclaim_dir(str(tmp_path))

        def mutate(records):
            assert records[-1][1] == wal.RT_RECLAIM
            records[-1][2][2] = b"EVIL" * 8  # granted_hash slot

        _rewrite_segment(d, SID, mutate)
        store = make_store()
        report = await DurableStorage(d, SID).recover(store)
        assert report["convicted"] == 1, report
        assert any(
            "reclaim MAC mismatch" in c["reason"]
            for c in report["convictions"]
        ), report
        assert store.reclaimed == {}
        assert store._get_or_create("k1").current_epoch == 0

    asyncio.run(asyncio.wait_for(body(), timeout=60))


def test_relocated_reclaim_convicted(tmp_path):
    """The MAC binds the record's sequence number: replaying the SAME
    valid body at a different log position (a splice/reorder attack) is
    convicted even though the body bytes are untouched."""

    async def body():
        d = await _staged_reclaim_dir(str(tmp_path))

        def mutate(records):
            records[-1][0] = records[-1][0] + 1  # shift the seq, keep body

        _rewrite_segment(d, SID, mutate)
        store = make_store()
        report = await DurableStorage(d, SID).recover(store)
        assert any(
            "reclaim MAC mismatch" in c["reason"]
            for c in report["convictions"]
        ), report
        assert store.reclaimed == {}

    asyncio.run(asyncio.wait_for(body(), timeout=60))


def test_forged_reclaim_without_node_key_convicted(tmp_path):
    """An attacker who can write the log but has no node key cannot mint
    an acceptable reclaim: a fresh 5-ary record with a guessed MAC is
    convicted."""

    async def body():
        d = await _staged_reclaim_dir(str(tmp_path))

        def mutate(records):
            records.append(
                [records[-1][0] + 1, wal.RT_RECLAIM,
                 ["k2", 9, b"g" * 32, 5, b"\x00" * 32]]
            )

        _rewrite_segment(d, SID, mutate)
        store = make_store()
        report = await DurableStorage(d, SID).recover(store)
        assert report["reclaims"] == 1  # the genuine record still lands
        assert ("k2", 9) not in store.reclaimed
        assert any(
            "reclaim MAC mismatch" in c["reason"]
            for c in report["convictions"]
        ), report

    asyncio.run(asyncio.wait_for(body(), timeout=60))


def test_legacy_reclaim_ratchet(tmp_path):
    """Pre-MAC logs stay replayable exactly once: a 4-ary legacy body is
    accepted (and counted) when no reclaim key predated this boot — the
    log necessarily predates the upgrade — but the moment a key exists,
    bare bodies are tampering and convict."""

    def write_legacy_segment(d: str) -> None:
        os.makedirs(d, exist_ok=True)
        w = wal.SegmentWriter(os.path.join(d, wal.segment_name(1)), SID, 1)
        w.append(wal.encode_record(1, wal.RT_RECLAIM, ["old", 4, b"x" * 32, 2]))
        w.close()

    async def body():
        # leg 1: fresh dir, no key on disk -> key minted this boot ->
        # legacy record accepted and counted
        d1 = str(tmp_path / "fresh")
        write_legacy_segment(d1)
        assert not os.path.exists(os.path.join(d1, RECLAIM_KEY_FILE))
        eng = DurableStorage(d1, SID)
        assert eng._reclaim_key_created
        store = make_store()
        report = await eng.recover(store)
        assert report["convicted"] == 0, report
        assert report.get("legacy_reclaims") == 1, report
        assert store.reclaimed[("old", 4)] == b"x" * 32

        # leg 2: the key now exists -> the SAME legacy body is convicted
        store2 = make_store()
        eng2 = DurableStorage(d1, SID)
        assert not eng2._reclaim_key_created
        report2 = await eng2.recover(store2)
        assert any(
            "reclaim missing MAC" in c["reason"]
            for c in report2["convictions"]
        ), report2
        assert store2.reclaimed == {}

    asyncio.run(asyncio.wait_for(body(), timeout=60))


def test_reclaim_key_file_permissions(tmp_path):
    d = str(tmp_path / SID)
    eng = DurableStorage(d, SID)
    path = os.path.join(d, RECLAIM_KEY_FILE)
    assert os.path.exists(path)
    assert os.stat(path).st_mode & 0o077 == 0, "key must be owner-only"
    assert len(eng._reclaim_key) >= 16


# --------------------------------------- 2. non-vacuity of the registry


def run_cli(*args: str, cwd: str = REPO, env_extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "-m", "mochi_tpu_torch.analysis", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=180,
    )


_SANITIZER_CALL = re.compile(
    r"self\.(_auth_mac|_authentic|_reclaim_auth_ok|_grant_ok)\(([^)]*)\)"
)


def _good_fixture_sites():
    with open(os.path.join(FIXTURES, "wire_taint_good.py")) as fh:
        src = fh.read()
    sites = list(_SANITIZER_CALL.finditer(src))
    assert len(sites) >= 5, "good fixture lost its sanitizer sites"
    return src, sites


def _drop_site(src: str, m: re.Match) -> str:
    """Replace one sanitizer call with a taint-free stand-in (``bool`` is a
    registered clean call), preserving syntax — the verifier edge is gone,
    the control flow stays."""
    first = m.group(2).split(",")[0].strip()
    return src[: m.start()] + f"bool({first})" + src[m.end():]


@pytest.mark.parametrize("seed", range(8))
def test_seeded_sanitizer_drop_convicts(seed, tmp_path):
    src, sites = _good_fixture_sites()
    rng = random.Random(seed)
    m = sites[rng.randrange(len(sites))]
    target = tmp_path / "mutated.py"
    target.write_text(_drop_site(src, m))
    result = core.run([str(target)], rules=["wire-taint"], scoped=False,
                      cache=False)
    assert result.new, f"seed {seed}: dropping {m.group(1)} did not convict"
    assert all(f.rule == "wire-taint" for f in result.new)


def test_every_fixture_sanitizer_site_is_load_bearing(tmp_path):
    """Exhaustive companion to the seeded sweep: EVERY sanitizer call in
    the good fixture convicts its sink when dropped — no edge in the
    corpus is decorative."""
    src, sites = _good_fixture_sites()
    for i, m in enumerate(sites):
        target = tmp_path / f"mut{i}.py"
        target.write_text(_drop_site(src, m))
        result = core.run([str(target)], rules=["wire-taint"], scoped=False,
                          cache=False)
        assert result.new, f"site {i} ({m.group(1)}) is vacuous"


LIVE_MUTATIONS = [
    # (file, original, replacement, sink expected to convict)
    ("mochi_tpu_torch/client/client.py",
     "and self._grant_ok(p.multi_grant, txn_hash)",
     "and p.multi_grant is not None",
     "grant-subset"),
    ("mochi_tpu_torch/server/replica.py",
     "if not self._auth_mac(env):",
     "if not bool(env):",
     "-apply"),
    # sync-adopt checks the aggregate fast edge first, then the
    # attributing per-grant audit — dropping BOTH must convict the sink
    # (the memo warm-up gather above the loop discards its result, so it
    # alone cannot launder the entry)
    ("mochi_tpu_torch/server/replica.py",
     "checked = await self._check_certificate_fast(\n"
     "                        entry.certificate\n"
     "                    )\n"
     "                    if checked is None:\n"
     "                        # fast path off, aggregate ineligible, or a failed\n"
     "                        # aggregate: the attributing per-grant audit\n"
     "                        checked = await self._check_certificate(\n"
     "                            entry.certificate\n"
     "                        )",
     "checked = entry.certificate",
     "sync-adopt"),
    # the paged engine's fault path — drop the per-entry recheck
    # between read_page_entry (taint source) and apply_sync_entry (CERT
    # sink) and the disk-tainted entry reaches adoption unsanctioned
    ("mochi_tpu_torch/storage/paged.py",
     "if not self._page_entry_admissible(store, key, txn, cert, ent):",
     "if txn is None and cert is None:",
     "sync-adopt"),
]


@pytest.mark.parametrize("path,old,new,sink", LIVE_MUTATIONS)
def test_live_tree_verifier_edge_is_load_bearing(path, old, new, sink,
                                                 tmp_path):
    """Strip one sanctioned verifier call from the REAL tree: the full
    scan must convict the downstream sink.  This is the acceptance
    criterion's non-vacuity proof on live code, not fixtures."""
    root = tmp_path / "tree"
    shutil.copytree(
        os.path.join(REPO, "mochi_tpu_torch"), root / "mochi_tpu_torch",
        ignore=shutil.ignore_patterns("__pycache__", "*.so"),
    )
    target = root / path
    src = target.read_text()
    assert old in src, f"mutation anchor drifted: {old!r} not in {path}"
    target.write_text(src.replace(old, new))
    proc = run_cli("mochi_tpu_torch/", "--rules", "wire-taint", cwd=str(root),
                   env_extra={"MOCHI_ANALYSIS_CACHE": "0"})
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "wire-taint" in proc.stdout
    assert sink in proc.stdout, proc.stdout


def test_paged_registration_block_is_load_bearing(tmp_path):
    """Strip the paged engine's wire-taint registration (the page-read
    source and the page-entry-recheck sanitizer) from a copy of the port:
    the full scan must then report the disk-tainted page entry reaching
    ``sync-adopt`` in ``mochi_tpu_torch/storage/paged.py``."""
    root = tmp_path / "tree"
    shutil.copytree(
        os.path.join(REPO, "mochi_tpu_torch"), root / "mochi_tpu_torch",
        ignore=shutil.ignore_patterns("__pycache__", "*.so"),
    )
    target = root / "mochi_tpu_torch" / "storage" / "paged.py"
    src = target.read_text()
    cut = src.index("\nwire_taint.register_edge(")
    assert "page-entry-recheck" in src[cut:]
    target.write_text(src[:cut] + "\n")
    proc = run_cli("mochi_tpu_torch/", "--rules", "wire-taint", cwd=str(root),
                   env_extra={"MOCHI_ANALYSIS_CACHE": "0"})
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert any(
        ln.startswith("mochi_tpu_torch/storage/paged.py:")
        and "sync-adopt" in ln
        for ln in proc.stdout.splitlines()
    ), proc.stdout


def test_live_tree_copy_scans_clean(tmp_path):
    """Harness control for the mutation tests: the UNMUTATED copy scans
    clean, so the convictions above are caused by the mutation alone."""
    root = tmp_path / "tree"
    shutil.copytree(
        os.path.join(REPO, "mochi_tpu_torch"), root / "mochi_tpu_torch",
        ignore=shutil.ignore_patterns("__pycache__", "*.so"),
    )
    proc = run_cli("mochi_tpu_torch/", "--rules", "wire-taint", cwd=str(root),
                   env_extra={"MOCHI_ANALYSIS_CACHE": "0"})
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ----------------------------------------------------- 3. the machinery


FAST_PATH_SRC = textwrap.dedent(
    """
    class FastReplica:
        def on_frame(self, frame, store):
            env = decode_env(frame)
            if not self._fast_mac_ok(env):
                return None
            return store.process_write1(env)
    """
)


def test_fast_path_must_register_verifier_edge(tmp_path):
    """The fast-path contract: an unregistered fast-path check is NOT a
    verifier — the sink downstream convicts until the edge is registered
    via register_verifier_edge (and registration clears it)."""
    target = tmp_path / "fast.py"
    target.write_text(FAST_PATH_SRC)
    before = core.run([str(target)], rules=["wire-taint"], scoped=False,
                      cache=False)
    assert len(before.new) == 1 and before.new[0].rule == "wire-taint"
    edge = wire_taint.register_verifier_edge(
        "fast-mac", "_fast_mac_ok", [wire_taint.CLS_ENV],
        note="test fast path",
    )
    try:
        after = core.run([str(target)], rules=["wire-taint"], scoped=False,
                         cache=False)
        assert after.new == [], [f.render() for f in after.new]
    finally:
        wire_taint._RUNTIME_EDGES.remove(edge)


def test_wire_taint_suppression_and_hygiene(tmp_path):
    bad = (
        "class R:\n"
        "    def f(self, frame, store):\n"
        "        env = decode_env(frame)\n"
        "        # mochi-lint: disable=wire-taint -- byzantine harness, "
        "unverified by design\n"
        "        return store.process_write1(env)\n"
    )
    target = tmp_path / "supp.py"
    target.write_text(bad)
    result = core.run([str(target)], rules=["wire-taint"], scoped=False,
                      cache=False)
    assert result.new == [] and len(result.suppressed) == 1
    # hygiene: the same comment with the finding fixed is itself a finding
    clean = bad.replace("env = decode_env(frame)", "env = frame")
    target.write_text(clean)
    result2 = core.run([str(target)], scoped=False, hygiene=True, cache=False)
    assert any(f.rule == core.HYGIENE_RULE for f in result2.new), [
        f.render() for f in result2.new
    ]


def test_changed_only_gates_wire_taint(tmp_path):
    """A PR adding an unverified flow fails --changed-only; pre-existing
    debt in untouched files only warns."""

    def git(*args):
        return subprocess.run(
            ["git", "-c", "user.email=t@t", "-c", "user.name=t", *args],
            cwd=str(repo), capture_output=True, text=True, timeout=30,
        )

    repo = tmp_path / "repo"
    (repo / "pkg").mkdir(parents=True)
    subprocess.run(["git", "init", "-q", str(repo)], cwd=str(tmp_path),
                   capture_output=True, timeout=30)
    shutil.copy(os.path.join(FIXTURES, "wire_taint_bad.py"),
                repo / "pkg" / "old.py")
    git("add", "-A")
    assert git("commit", "-q", "-m", "seed").returncode == 0
    shutil.copy(os.path.join(FIXTURES, "wire_taint_bad.py"),
                repo / "pkg" / "new.py")
    proc = run_cli("pkg", "--changed-only", "HEAD", "--no-path-filter",
                   cwd=str(repo), env_extra={"MOCHI_ANALYSIS_CACHE": "0"})
    assert proc.returncode == 1, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert any(ln.startswith("pkg/new.py") and "[wire-taint" in ln
               for ln in lines), proc.stdout
    assert any(ln.startswith("warning") and "pkg/old.py" in ln
               for ln in lines), proc.stdout


def test_cache_warm_run_identical(tmp_path):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    for name in ("wire_taint_bad.py", "unbounded_growth_bad.py",
                 "await_races_bad.py"):
        shutil.copy(os.path.join(FIXTURES, name), pkg / name)
    cdir = str(tmp_path / "cache")
    env = {"MOCHI_ANALYSIS_CACHE_DIR": cdir, "MOCHI_ANALYSIS_CACHE": "1"}
    cold = run_cli(str(pkg), "--no-path-filter", cwd=str(tmp_path),
                   env_extra=env)
    assert os.listdir(cdir), "cold run populated no cache records"
    warm = run_cli(str(pkg), "--no-path-filter", cwd=str(tmp_path),
                   env_extra=env)
    assert cold.returncode == warm.returncode == 1
    assert cold.stdout == warm.stdout, (
        "warm (cached) run diverged from cold run"
    )


def test_cache_invalidated_on_edit(tmp_path):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    target = pkg / "mod.py"
    target.write_text("def f(frame):\n    return frame\n")
    cdir = str(tmp_path / "cache")
    env = {"MOCHI_ANALYSIS_CACHE_DIR": cdir, "MOCHI_ANALYSIS_CACHE": "1"}
    first = run_cli(str(pkg), "--no-path-filter", cwd=str(tmp_path),
                    env_extra=env)
    assert first.returncode == 0, first.stdout + first.stderr
    target.write_text(
        "def f(frame, store):\n"
        "    env = decode_env(frame)\n"
        "    return store.process_write1(env)\n"
    )
    # ensure the mtime moves even on coarse filesystem clocks
    st = os.stat(target)
    os.utime(target, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))
    second = run_cli(str(pkg), "--no-path-filter", cwd=str(tmp_path),
                     env_extra=env)
    assert second.returncode == 1, (
        "stale cache served: the edited file's finding was dropped\n"
        + second.stdout + second.stderr
    )
    assert "[wire-taint" in second.stdout


def test_worker_pool_matches_serial():
    paths = [os.path.join(FIXTURES, n) for n in sorted(os.listdir(FIXTURES))
             if n.endswith(".py")]
    serial = core.run(paths, scoped=False, cache=False, jobs=1)
    pooled = core.run(paths, scoped=False, cache=False, jobs=4)

    def key(result):
        return sorted(f.fingerprint for f in result.new)

    assert key(serial) == key(pooled)
    assert serial.files_scanned == pooled.files_scanned
