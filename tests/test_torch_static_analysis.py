"""Tier-1 gate: the port's tree is lint-clean under mochi_tpu_torch.analysis.

Two guarantees, both via the port's CLI:

1. ``python -m mochi_tpu_torch.analysis mochi_tpu_torch/ chip_smoke.py``
   exits 0 on the current tree with the empty
   ``config/analysis_baseline_torch.json`` and the suppression-hygiene pass
   on — a new finding anywhere in the port fails this test;
2. each of the ten seeded regression fixtures of
   ``tests/analysis_fixtures/`` (read in place), dropped into a scanned
   tree, flips the exit code to non-zero — the checkers can't silently rot
   into no-ops.
"""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "analysis_fixtures")
BASELINE = os.path.join(REPO, "config", "analysis_baseline_torch.json")


def run_cli(*args: str, cwd: str = REPO) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    # the repo may be run from a checkout without `pip install -e .`
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run(
        [sys.executable, "-m", "mochi_tpu_torch.analysis", *args],
        cwd=cwd,
        env=env,
        capture_output=True,
        text=True,
        timeout=120,
    )


def test_tree_is_lint_clean():
    proc = run_cli("mochi_tpu_torch/", "chip_smoke.py")
    assert proc.returncode == 0, f"new findings:\n{proc.stdout}{proc.stderr}"
    # hygiene is on (no --no-hygiene), and the scan covered the port: the
    # replica anchors the registry-rot check, the native seam its C rules
    assert " 0 new, 0 baselined" in proc.stdout, proc.stdout


def test_baseline_file_is_empty():
    # The shipped baseline grandfathers nothing: every finding on the tree
    # is fixed or carries an explicit justified suppression.  A PR that
    # re-baselines instead of fixing turns this red.
    import json

    with open(BASELINE) as fh:
        doc = json.load(fh)
    assert doc["fingerprints"] == []


SEEDED = [
    "async_blocking_bad.py",
    "cancellation_bad.py",
    "trace_safety_bad.py",
    "const_time_bad.py",
    "invariants_bad.py",
    "await_races_bad.py",
    "native_ct_bad.c",
    "span_lazy_bad.py",
    "wire_taint_bad.py",
    "unbounded_growth_bad.py",
]


@pytest.mark.parametrize("bad_fixture", SEEDED)
def test_seeded_regression_flips_exit_code(bad_fixture, tmp_path):
    # Simulate the regression landing in a scanned package: the fixture is
    # copied into a fresh tree and the CLI must go non-zero on it.
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    shutil.copy(os.path.join(FIXTURES, bad_fixture), pkg / bad_fixture)
    proc = run_cli(str(pkg), "--no-path-filter", cwd=str(tmp_path))
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "[" in proc.stdout  # at least one rendered finding


def test_clean_file_exits_zero(tmp_path):
    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "ok.py").write_text("import asyncio\n\nasync def f():\n    await asyncio.sleep(1)\n")
    proc = run_cli(str(pkg), "--no-path-filter", cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ------------------------------------------------------- diff-aware strict


BAD_SRC = "import time\nasync def f():\n    time.sleep(1)\n"
OK_SRC = "import asyncio\nasync def f():\n    await asyncio.sleep(1)\n"


def _git(repo: str, *args: str) -> subprocess.CompletedProcess:
    return subprocess.run(
        ["git", "-c", "user.email=t@t", "-c", "user.name=t", *args],
        cwd=repo, capture_output=True, text=True, timeout=30,
    )


@pytest.fixture
def diff_repo(tmp_path):
    """A throwaway git repo: pkg/old.py (committed, has a finding) and
    pkg/new.py (untracked, has a finding)."""
    repo = tmp_path / "repo"
    (repo / "pkg").mkdir(parents=True)
    assert _git(str(tmp_path), "init", "-q", str(repo)).returncode == 0
    (repo / "pkg" / "old.py").write_text(BAD_SRC)
    _git(str(repo), "add", "-A")
    assert _git(str(repo), "commit", "-q", "-m", "seed").returncode == 0
    (repo / "pkg" / "new.py").write_text(BAD_SRC)
    return str(repo)


def test_changed_only_fails_on_changed_warns_on_rest(diff_repo):
    proc = run_cli("pkg", "--changed-only", "HEAD", "--no-path-filter", cwd=diff_repo)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    failing = [
        ln for ln in proc.stdout.splitlines()
        if ln.startswith("pkg/new.py") and "[async-blocking" in ln
    ]
    warned = [
        ln for ln in proc.stdout.splitlines()
        if ln.startswith("warning") and "pkg/old.py" in ln
    ]
    assert failing and warned, proc.stdout


def test_changed_only_exits_zero_when_only_unchanged_files_dirty(diff_repo):
    os.remove(os.path.join(diff_repo, "pkg", "new.py"))
    proc = run_cli("pkg", "--changed-only", "HEAD", "--no-path-filter", cwd=diff_repo)
    # old.py's finding is pre-existing debt, not this PR's — warn, exit 0
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "pkg/old.py" in proc.stdout and "warning" in proc.stdout


def test_changed_only_catches_working_tree_edit(diff_repo):
    # an EDITED (not just untracked) file fails too: diff vs REF covers the
    # working tree, not only commits
    os.remove(os.path.join(diff_repo, "pkg", "new.py"))
    with open(os.path.join(diff_repo, "pkg", "old.py"), "a") as fh:
        fh.write("\nasync def g():\n    time.sleep(2)\n")
    proc = run_cli("pkg", "--changed-only", "HEAD", "--no-path-filter", cwd=diff_repo)
    assert proc.returncode == 1, proc.stdout + proc.stderr


def test_changed_only_unknown_ref_falls_back_to_full_strict(diff_repo):
    proc = run_cli(
        "pkg", "--changed-only", "no-such-ref", "--no-path-filter", cwd=diff_repo
    )
    # never silently passes: git can't answer -> every finding fails
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "falling back to full-strict" in proc.stderr


def test_changed_only_from_subdir_anchors_at_repo_root(diff_repo):
    # git reports repo-root-relative names; invoked from a SUBDIR with an
    # absolute path arg, the changed set must still match — an empty set
    # here would downgrade the new file's finding to a warning (silent pass)
    proc = run_cli(
        os.path.join(diff_repo, "pkg"), "--changed-only", "HEAD",
        "--no-path-filter", cwd=os.path.join(diff_repo, "pkg"),
    )
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert any(
        ln.startswith("pkg/new.py") and not ln.startswith("warning")
        for ln in proc.stdout.splitlines()
    ), proc.stdout


def test_changed_only_diffs_the_scanned_repo_not_the_cwd(diff_repo, tmp_path):
    # The changed set must come from the SCANNED repo: gating repoB from a
    # cwd inside repoA used to diff repoA, see nothing changed, and
    # downgrade repoB's brand-new finding to a warning — a silent pass on
    # the gate's own fail-closed contract.
    other = tmp_path / "other"
    other.mkdir()
    assert _git(str(tmp_path), "init", "-q", str(other)).returncode == 0
    (other / "seed.py").write_text(OK_SRC)
    _git(str(other), "add", "-A")
    assert _git(str(other), "commit", "-q", "-m", "seed").returncode == 0
    proc = run_cli(
        os.path.join(diff_repo, "pkg"), "--changed-only", "HEAD",
        "--no-path-filter", cwd=str(other),
    )
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert any(
        "new.py" in ln and not ln.startswith("warning")
        for ln in proc.stdout.splitlines()
        if "[async-blocking" in ln
    ), proc.stdout


def test_changed_display_paths_fails_closed_outside_repo(tmp_path, monkeypatch):
    # no repo -> None (full-strict fallback), never an empty changed set
    from mochi_tpu_torch.analysis.__main__ import changed_display_paths

    monkeypatch.chdir(tmp_path)
    assert changed_display_paths("HEAD") is None


def test_changed_only_matches_nested_non_package_dirs(diff_repo):
    # Finding display paths anchor at the scan root; the changed set is
    # absolute and membership is suffix-matched — a nested dir WITHOUT
    # __init__.py (where the two anchorings diverge) must still FAIL on
    # its changed file, not downgrade it to a warning.
    sub = os.path.join(diff_repo, "pkg", "sub")
    os.makedirs(sub)
    with open(os.path.join(sub, "nested_new.py"), "w") as fh:
        fh.write(BAD_SRC)
    proc = run_cli("pkg", "--changed-only", "HEAD", "--no-path-filter", cwd=diff_repo)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert any(
        "nested_new.py" in ln and not ln.startswith("warning")
        for ln in proc.stdout.splitlines()
        if "[async-blocking" in ln
    ), proc.stdout
