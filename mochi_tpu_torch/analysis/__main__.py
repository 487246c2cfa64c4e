"""CLI for the static-analysis pass.

Exit codes: 0 clean (new findings == 0), 1 new findings, 2 usage error.
``--write-baseline`` records the current findings as accepted and exits 0 —
the ratchet for landing the pass on a tree with known debt.

``--changed-only REF`` is the diff-aware strict mode for PR gates: findings
in files changed vs the git ref (plus untracked files) FAIL; findings in
untouched files print as warnings and exit 0 — a PR cannot add findings
silently, and an unrelated tree-wide regression cannot block it either.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import List, Optional, Set

from .core import all_rules, run, write_baseline

DEFAULT_BASELINE = os.path.join("config", "analysis_baseline_torch.json")
DEFAULT_PATHS = ["mochi_tpu_torch", "chip_smoke.py"]


def changed_display_paths(
    ref: str, scan_paths: Optional[List[str]] = None
) -> Optional[Set[str]]:
    """ABSOLUTE paths of files changed vs ``ref`` (committed diff +
    working tree + untracked), or None when git can't answer (not a repo,
    unknown ref) — the caller then falls back to full-strict, never to
    silently passing.  The repo is resolved FROM the scanned paths, not
    the process cwd: scanning another repo (or a nested one) from here
    must diff THAT repo, or its brand-new findings would be judged
    against this repo's changed set and silently downgrade to warnings.
    Absolute, not display: a finding's display path is
    anchoring-dependent (package root vs scan root vs parent dir), and
    recomputing it here without the runner's scan_root can diverge for
    nested non-package dirs — membership is therefore judged by
    ``is_changed`` suffix match, which no anchoring choice can break."""
    anchors = set()
    for p in scan_paths or ["."]:
        ap = os.path.abspath(p)
        anchors.add(ap if os.path.isdir(ap) else (os.path.dirname(ap) or "."))
    roots: Set[str] = set()
    try:
        for anchor in anchors:
            top = subprocess.run(
                ["git", "rev-parse", "--show-toplevel"],
                capture_output=True, text=True, timeout=30, cwd=anchor,
            )
            if top.returncode != 0:
                return None
            roots.add(top.stdout.strip())
        names: List[str] = []
        for root in roots:
            # Run both listings FROM the repo root: `diff --name-only` is
            # root-relative from anywhere, but `ls-files` reports
            # cwd-relative names — mixing the two from a subdir would
            # mis-anchor untracked files and silently downgrade their
            # findings to warnings.
            diff = subprocess.run(
                ["git", "diff", "--name-only", ref, "--"],
                capture_output=True, text=True, timeout=30, cwd=root,
            )
            untracked = subprocess.run(
                ["git", "ls-files", "--others", "--exclude-standard"],
                capture_output=True, text=True, timeout=30, cwd=root,
            )
            # EVERY git call must have succeeded: a failed ls-files (index
            # lock, transient error, ref unknown in this repo) would make
            # brand-new files look "unchanged" and downgrade their findings
            # to warnings — fail closed to full-strict.
            if diff.returncode != 0 or untracked.returncode != 0:
                return None
            names.extend(
                os.path.abspath(os.path.join(root, ln.strip()))
                for out in (diff.stdout, untracked.stdout)
                for ln in out.splitlines()
                if ln.strip()
            )
    except (OSError, subprocess.TimeoutExpired):
        return None
    # deleted files (present in the diff, gone on disk) have no findings
    return {n.replace(os.sep, "/") for n in names if os.path.exists(n)}


def is_changed(finding_path: str, changed_abs: Set[str]) -> bool:
    """Whether a finding's display path names one of the changed files.

    Display paths are repo-relative with a display-dependent anchor
    (``mochi_tpu_torch/server/replica.py``, ``repo/chip_smoke.py`` — always
    ``/``-separated); matching by path-component suffix against the
    absolute changed set is anchor-proof.  A suffix collision can only
    mark an UNCHANGED file's finding as failing — the gate fails closed,
    never open."""
    return any(
        a == finding_path or a.endswith("/" + finding_path)
        for a in changed_abs
    )


def main(argv: List[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m mochi_tpu_torch.analysis",
        description="mochi-tpu project-native static analysis",
    )
    parser.add_argument(
        "paths", nargs="*", default=DEFAULT_PATHS,
        help=f"files or directories to scan (default: {' '.join(DEFAULT_PATHS)})",
    )
    parser.add_argument(
        "--rules",
        help=f"comma-separated subset of: {', '.join(all_rules())}",
    )
    parser.add_argument(
        "--baseline", default=None,
        help=f"baseline JSON (default: {DEFAULT_BASELINE} if it exists)",
    )
    parser.add_argument(
        "--write-baseline", action="store_true",
        help="accept current findings into the baseline file and exit 0",
    )
    parser.add_argument(
        "--no-path-filter", action="store_true",
        help="drop per-checker path scoping (fixture/self-test use)",
    )
    parser.add_argument(
        "--changed-only", metavar="REF", default=None,
        help=(
            "diff-aware strict mode: findings in files changed vs REF "
            "(+ untracked) fail; findings elsewhere warn (exit 0)"
        ),
    )
    parser.add_argument(
        "--no-hygiene", action="store_true",
        help=(
            "skip the suppression-hygiene pass (unused suppressions / "
            "stale baseline entries reported as findings on full-rule runs)"
        ),
    )
    parser.add_argument(
        "--jobs", type=int, default=None, metavar="N",
        help=(
            "worker processes for the per-file scan (default: "
            "MOCHI_ANALYSIS_JOBS, else auto — parallel only on large cold "
            "runs); results are identical at any setting"
        ),
    )
    parser.add_argument(
        "--no-cache", action="store_true",
        help=(
            "bypass the per-file record cache (also MOCHI_ANALYSIS_CACHE=0); "
            "results are identical, only the scan is slower"
        ),
    )
    parser.add_argument(
        "--format", choices=("text", "json"), default="text",
    )
    args = parser.parse_args(argv)

    rules = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
    baseline = args.baseline
    if baseline is None and os.path.exists(DEFAULT_BASELINE):
        baseline = DEFAULT_BASELINE

    try:
        result = run(
            args.paths,
            rules=rules,
            baseline=None if args.write_baseline else baseline,
            scoped=not args.no_path_filter,
            hygiene=not (args.no_hygiene or args.write_baseline),
            jobs=args.jobs,
            cache=False if args.no_cache else None,
        )
    except ValueError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2

    if args.write_baseline:
        target = args.baseline or DEFAULT_BASELINE
        os.makedirs(os.path.dirname(target) or ".", exist_ok=True)
        write_baseline(target, result.new, scanned=result.scanned)
        print(f"baseline written: {target} ({len(result.new)} findings)")
        return 0

    failing = list(result.new)
    warning: List = []
    if args.changed_only:
        changed = changed_display_paths(args.changed_only, args.paths)
        if changed is None:
            print(
                f"--changed-only: git could not resolve {args.changed_only!r}; "
                "falling back to full-strict (every finding fails)",
                file=sys.stderr,
            )
        else:
            failing = [f for f in result.new if is_changed(f.path, changed)]
            warning = [f for f in result.new if not is_changed(f.path, changed)]

    if args.format == "json":
        print(
            json.dumps(
                {
                    "new": [f.__dict__ | {"fingerprint": f.fingerprint} for f in failing],
                    "warned": [
                        f.__dict__ | {"fingerprint": f.fingerprint} for f in warning
                    ],
                    "baselined": len(result.baselined),
                    "suppressed": len(result.suppressed),
                    "files_scanned": result.files_scanned,
                },
                indent=2,
            )
        )
    else:
        for finding in failing:
            print(finding.render())
        for finding in warning:
            print(f"warning (unchanged file): {finding.render()}")
        print(
            f"{result.files_scanned} files scanned: {len(failing)} new"
            + (f", {len(warning)} warned (unchanged vs {args.changed_only})"
               if args.changed_only else "")
            + f", {len(result.baselined)} baselined, "
            f"{len(result.suppressed)} suppressed"
        )
    return 1 if failing else 0


if __name__ == "__main__":
    sys.exit(main())
