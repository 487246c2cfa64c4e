"""Framework for the project-native static-analysis pass.

Why a bespoke pass instead of an off-the-shelf linter: the defects that
actually hurt this codebase are *protocol-specific* — a ``time.sleep`` inside
a replica coroutine stalls every connection multiplexed on that event loop
(the 1-RT read / 2-RT write budget is milliseconds); an ``except Exception``
that eats ``asyncio.CancelledError`` turns shutdown into a hang; a Python
``if`` on a traced value silently forces a host sync inside the batched
verifier; a ``==`` on signature bytes is a timing oracle.  Generic linters
know none of this vocabulary.

Architecture: each checker module exposes ``RULE`` (its name) and
``check(tree, src, path, scoped=True) -> list[Finding]``.  This module owns
the shared plumbing: the :class:`Finding` type, suppression comments,
baseline files, file walking, and the runner.

Suppression syntax (see docs/ANALYSIS.md): a finding on line N is suppressed
by a comment on line N or on line N-1 of the form::

    # mochi-lint: disable=<rule>[,<rule>...] -- <one-line justification>

(``all`` disables every rule; the justification after the rule list is
required by review etiquette, not the parser.  Written with a ``<rule>``
placeholder here so this docstring is not itself a live suppression — the
hygiene pass scans raw lines, docstrings included.)

Baseline: a JSON file ``{"fingerprints": [...]}``.  Findings whose
fingerprint appears in the baseline are reported as "baselined" and do not
fail the run — the mechanism that lets the pass land on an imperfect tree
and ratchet forward.  The shipped baseline is empty: every finding on the
current tree is either fixed or carries an explicit suppression.
"""

from __future__ import annotations

import ast
import hashlib
import json
import os
import pickle
import re
import tempfile
from dataclasses import dataclass, field, replace
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple


@dataclass(frozen=True)
class Finding:
    """One checker hit, addressable and stable enough to baseline."""

    rule: str
    path: str  # posix-style, package-anchored (see display_path)
    line: int
    col: int
    message: str
    snippet: str = ""
    # 0-based index among same-(rule, snippet) findings in this file, in
    # line order; assigned by run().  Without it, two textually identical
    # violations in one file would share a fingerprint and one baseline
    # entry would grandfather both — the ratchet could move backwards.
    occurrence: int = 0
    # Severity tier ("error" is the classic single-tier default).  Tiered
    # checkers (await-races) emit high/medium/advice so triage can rank a
    # check-then-act on a bounded table above an iteration hazard; every
    # tier still FAILS the run — tiers order the work, they don't excuse
    # it.  Not part of the fingerprint: re-tiering a rule must not
    # invalidate baselines or suppressions.
    severity: str = "error"

    @property
    def fingerprint(self) -> str:
        """Content-addressed id: survives line-number drift (the baseline
        must not churn when unrelated edits move code), breaks when the
        flagged code itself changes (a moved-AND-edited line is a new
        finding, as it should be)."""
        basis = f"{self.rule}|{self.path}|{self.snippet.strip()}|{self.occurrence}"
        return hashlib.sha256(basis.encode()).hexdigest()[:16]

    def render(self) -> str:
        sev = "" if self.severity == "error" else f"/{self.severity}"
        return f"{self.path}:{self.line}:{self.col}: [{self.rule}{sev}] {self.message}"


# --------------------------------------------------------------- suppressions

# ``#`` for Python, ``//`` / ``/*`` for the native seam (analysis covers
# ``native/*.c`` since the const-time lexer pass landed).
_SUPPRESS_RE = re.compile(
    # rule tokens only (comma-separated); trailing prose is the REQUIRED
    # one-line justification and must not bleed into the rule list
    r"(?:#|//|/\*)\s*mochi-lint:\s*disable=([A-Za-z0-9_\-]+(?:\s*,\s*[A-Za-z0-9_\-]+)*)"
)


def suppressions_by_line(src: str) -> Dict[int, Set[str]]:
    """Map 1-based line number -> set of rule names disabled there.

    Regex over raw lines rather than the tokenize module: a suppression must
    keep working even in a file the tokenizer rejects (the parse-error path
    still reports, and half-edited files shouldn't crash the linter)."""
    out: Dict[int, Set[str]] = {}
    for i, line in enumerate(src.splitlines(), start=1):
        m = _SUPPRESS_RE.search(line)
        if m:
            out[i] = {r.strip() for r in m.group(1).split(",") if r.strip()}
    return out


def is_suppressed(finding: Finding, supp: Dict[int, Set[str]]) -> bool:
    for line in (finding.line, finding.line - 1):
        rules = supp.get(line)
        if rules and ("all" in rules or finding.rule in rules):
            return True
    return False


def suppression_line_for(finding: Finding, supp: Dict[int, Set[str]]) -> Optional[int]:
    """The comment line that suppressed ``finding`` (same-line wins), or
    None — the accounting the suppression-hygiene rule needs to tell a
    LOAD-BEARING comment from a stale one."""
    for line in (finding.line, finding.line - 1):
        rules = supp.get(line)
        if rules and ("all" in rules or finding.rule in rules):
            return line
    return None


# ------------------------------------------------------------------- baseline


def load_baseline(path: Optional[str]) -> Set[str]:
    if not path or not os.path.exists(path):
        return set()
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    return set(doc.get("fingerprints", []))


def load_baseline_paths(path: Optional[str]) -> Optional[Set[str]]:
    """The display-path set the baseline was written against, or None for
    a legacy/absent baseline that never recorded one.  Staleness of a
    fingerprint can only be judged by a run that scanned AT LEAST these
    files — an unmatched entry on a narrower run may simply belong to a
    file that wasn't looked at."""
    if not path or not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    paths = doc.get("paths")
    return None if paths is None else set(paths)


def write_baseline(
    path: str,
    findings: Sequence[Finding],
    scanned: Optional[Sequence[str]] = None,
) -> None:
    doc = {
        "comment": (
            "mochi_tpu_torch.analysis baseline: findings listed here are "
            "grandfathered and do not fail the run.  Regenerate with "
            "`python -m mochi_tpu_torch.analysis --write-baseline`."
        ),
        "fingerprints": sorted({f.fingerprint for f in findings}),
    }
    if scanned is not None:
        # coverage record: the suppression-hygiene pass convicts stale
        # fingerprints only on runs that re-scan at least these files
        doc["paths"] = sorted(set(scanned))
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(doc, fh, indent=2)
        fh.write("\n")


# ----------------------------------------------------------------- AST helpers


def build_import_map(tree: ast.Module) -> Dict[str, str]:
    """Local name -> dotted origin, for resolving what a call really is.

    ``import numpy as np``          -> {"np": "numpy"}
    ``from time import sleep``      -> {"sleep": "time.sleep"}
    ``from ..crypto import keys``   -> {"keys": "crypto.keys"} (relative
    imports resolve to their suffix; matching is by dotted-suffix anyway).
    """
    out: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                out[alias.asname or alias.name.split(".")[0]] = alias.name
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            for alias in node.names:
                if alias.name == "*":
                    continue
                origin = f"{base}.{alias.name}" if base else alias.name
                out[alias.asname or alias.name] = origin
    return out


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def resolve_call(node: ast.AST, imports: Dict[str, str]) -> Optional[str]:
    """Fully-ish qualified dotted name of a call target, via the import map."""
    dn = dotted_name(node)
    if dn is None:
        return None
    head, _, rest = dn.partition(".")
    origin = imports.get(head)
    if origin is None:
        return dn
    return f"{origin}.{rest}" if rest else origin


def suffix_match(qualified: str, patterns: Iterable[str]) -> Optional[str]:
    """Match ``a.b.c.d`` against patterns by dotted suffix (relative imports
    lose their package prefix, so ``crypto.keys.sign`` must match
    ``mochi_tpu_torch.crypto.keys.sign`` and vice versa).

    A bare single-segment name only matches a single-segment pattern: a
    module-local ``wait()`` or ``verify()`` must not trip deny-list entries
    like ``os.wait`` just because the terminal segment collides — the name
    carries no evidence it is that module's function."""
    parts = qualified.split(".")
    for pat in patterns:
        pp = pat.split(".")
        if len(pp) <= len(parts) and parts[-len(pp):] == pp:
            return pat
        if 2 <= len(parts) <= len(pp) and pp[-len(parts):] == parts:
            return pat
    return None


def snippet_at(src_lines: Sequence[str], line: int) -> str:
    if 1 <= line <= len(src_lines):
        return src_lines[line - 1].strip()
    return ""


# --------------------------------------------------------------------- runner


def display_path(fp: str, scan_root: Optional[str] = None) -> str:
    """The path a finding carries (and its fingerprint hashes).

    Must be (a) CWD-independent — the CLI scans from the repo root while
    a test may pass absolute paths from an arbitrary CWD,
    and a fingerprint mismatch silently un-baselines everything — and
    (b) scope-faithful — per-checker scoping looks for components like
    ``crypto/`` and suffixes like ``cluster/config.py``, so a bare-basename
    display would both drop checkers and break exemptions on single-file
    invocations.  For a file inside a package, anchor at the package root
    (walk up while ``__init__.py`` exists): ``keys.py`` displays as
    ``mochi_tpu_torch/crypto/keys.py`` however it was named.  Otherwise anchor at
    the scan root (directory scans) or the containing directory (file args).
    """
    ap = os.path.abspath(fp)
    pkg_root = os.path.dirname(ap)
    while os.path.exists(os.path.join(pkg_root, "__init__.py")):
        pkg_root = os.path.dirname(pkg_root)
    if pkg_root != os.path.dirname(ap):
        return os.path.relpath(ap, pkg_root).replace(os.sep, "/")
    if scan_root is not None:
        root_name = os.path.basename(os.path.abspath(scan_root))
        rel = os.path.relpath(fp, scan_root)
        return os.path.join(root_name, rel).replace(os.sep, "/")
    parent = os.path.basename(os.path.dirname(ap))
    name = os.path.basename(ap)
    return f"{parent}/{name}" if parent else name


# Scanned source kinds: Python gets the AST checkers; .c gets the lexical
# native checkers (LANG = "c" modules).  display_path/fingerprint/baseline
# machinery is shared — a native finding baselines and suppresses exactly
# like a Python one.
SOURCE_EXTS = (".py", ".c")


def iter_python_files(
    paths: Sequence[str], exts: Sequence[str] = SOURCE_EXTS
) -> List[Tuple[str, str]]:
    """``(display_path, filesystem_path)`` pairs for every source file
    (``exts``) under paths.  (Name kept from the .py-only era — callers and
    tests use it directly.)"""
    out: Dict[str, Tuple[str, str]] = {}  # abspath -> (display, fs path)
    for path in paths:
        norm = os.path.normpath(path)
        if os.path.isfile(norm):
            if norm.endswith(tuple(exts)):
                out.setdefault(os.path.abspath(norm), (display_path(norm), norm))
            continue
        for dirpath, dirnames, filenames in os.walk(norm):
            dirnames[:] = [
                d for d in dirnames if not d.startswith(".") and d != "__pycache__"
            ]
            for fn in sorted(filenames):
                if fn.endswith(tuple(exts)):
                    fp = os.path.join(dirpath, fn)
                    out.setdefault(
                        os.path.abspath(fp), (display_path(fp, scan_root=norm), fp)
                    )
    return sorted(out.values())


def _checkers():
    # Imported here (not module top) so ``core`` stays importable from the
    # checker modules themselves without a cycle.
    from . import (
        async_blocking,
        await_races,
        cancellation,
        const_time,
        invariants,
        native_ct,
        span_lazy,
        trace_safety,
        unbounded_growth,
        wire_taint,
    )

    return [
        async_blocking,
        cancellation,
        trace_safety,
        const_time,
        invariants,
        await_races,
        native_ct,
        span_lazy,
        unbounded_growth,
        wire_taint,
    ]


def _split_checkers(mods):
    """(per-file, whole-tree) partition.  A *tree checker* exposes
    ``extract(tree, src, path, scoped) -> facts`` (picklable, registry-
    independent, cacheable per file) and ``link(facts_list) -> findings``
    (interprocedural, recomputed every run); everything else is the classic
    per-file ``check()`` contract."""
    per_file = [m for m in mods if not hasattr(m, "extract")]
    tree = [m for m in mods if hasattr(m, "extract")]
    return per_file, tree


def all_rules() -> List[str]:
    return [mod.RULE for mod in _checkers()]


@dataclass
class RunResult:
    """Everything a caller (CLI, test, bench gate) needs to render a run."""

    new: List[Finding] = field(default_factory=list)
    baselined: List[Finding] = field(default_factory=list)
    suppressed: List[Finding] = field(default_factory=list)
    files_scanned: int = 0
    # display paths actually scanned — recorded into the baseline by
    # --write-baseline so later runs know the coverage staleness needs
    scanned: List[str] = field(default_factory=list)

    @property
    def clean(self) -> bool:
        return not self.new


HYGIENE_RULE = "suppression-hygiene"


# ---------------------------------------------------------------------- cache
#
# The full pass runs inside tier-1 over the whole tree, so cold cost is
# paid constantly.  Two levers, both semantics-preserving:
#
#  * a per-file record cache keyed by (abspath, mtime_ns, size, scoped,
#    rule set, toolchain token): parse + per-file checkers + tree-checker
#    ``extract()`` facts are pure functions of file bytes, so a warm rerun
#    only re-executes the cheap interprocedural ``link()`` stage;
#  * a process pool over cache misses for cold runs (``--jobs`` /
#    MOCHI_ANALYSIS_JOBS; auto when the miss count is large).
#
# The cache is advisory: any I/O or unpickling trouble degrades to a
# recompute, never to a wrong answer.  MOCHI_ANALYSIS_CACHE=0 disables.

_CACHE_ENV = "MOCHI_ANALYSIS_CACHE"
_CACHE_DIR_ENV = "MOCHI_ANALYSIS_CACHE_DIR"
_JOBS_ENV = "MOCHI_ANALYSIS_JOBS"
_CACHE_ERRORS = (OSError, EOFError, ValueError, TypeError, AttributeError,
                 IndexError, KeyError, pickle.PickleError)


def _toolchain_token() -> str:
    """Version stamp: mtimes+sizes of the analysis package itself, so any
    checker edit invalidates every cached record (a stale record from an
    older checker would silently drop that checker's new findings)."""
    d = os.path.dirname(os.path.abspath(__file__))
    parts = []
    try:
        for fn in sorted(os.listdir(d)):
            if fn.endswith(".py"):
                st = os.stat(os.path.join(d, fn))
                parts.append(f"{fn}:{st.st_mtime_ns}:{st.st_size}")
    except OSError:
        return "no-token"
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:16]


def cache_dir() -> Optional[str]:
    if os.environ.get(_CACHE_ENV, "1").lower() in ("0", "off", "no", "false"):
        return None
    override = os.environ.get(_CACHE_DIR_ENV)
    if override:
        return override
    uid = getattr(os, "getuid", lambda: 0)()
    return os.path.join(tempfile.gettempdir(), f"mochi-torch-analysis-cache-{uid}")


def _cache_path(cdir: str, filepath: str) -> str:
    key = hashlib.sha256(os.path.abspath(filepath).encode()).hexdigest()[:24]
    return os.path.join(cdir, f"{key}.pkl")


def _cache_load(cdir, filepath, token, scoped, rule_names):
    if not cdir:
        return None
    try:
        st = os.stat(filepath)
        with open(_cache_path(cdir, filepath), "rb") as fh:
            doc = pickle.load(fh)
        if (
            doc.get("token") == token
            and doc.get("mtime_ns") == st.st_mtime_ns
            and doc.get("size") == st.st_size
            and doc.get("scoped") == scoped
            and doc.get("rules") == rule_names
        ):
            return doc["record"]
    except _CACHE_ERRORS:
        return None
    return None


def _cache_store(cdir, filepath, token, scoped, rule_names, record) -> None:
    try:
        os.makedirs(cdir, exist_ok=True)
        st = os.stat(filepath)
        doc = {
            "token": token, "mtime_ns": st.st_mtime_ns, "size": st.st_size,
            "scoped": scoped, "rules": rule_names, "record": record,
        }
        target = _cache_path(cdir, filepath)
        tmp = f"{target}.tmp{os.getpid()}"
        with open(tmp, "wb") as fh:
            pickle.dump(doc, fh)
        os.replace(tmp, target)  # atomic: a concurrent reader sees old or new
    except _CACHE_ERRORS:
        pass


def _select_checkers(rule_names: Sequence[str]):
    by_rule = {mod.RULE: mod for mod in _checkers()}
    return [by_rule[r] for r in rule_names if r in by_rule]


def _compute_record(rel: str, filepath: str, scoped: bool,
                    rule_names: Tuple[str, ...]) -> Dict:
    """Everything the triage/link stages need from one file: per-file
    findings, tree-checker facts, the suppression map.  Pure in the file's
    bytes + rule set — the unit the cache stores and the worker pool maps."""
    record: Dict = {
        "error": None, "is_c": filepath.endswith(".c"), "findings": [],
        "facts": {}, "supp": {}, "supp_snippets": {},
    }
    try:
        with open(filepath, encoding="utf-8") as fh:
            src = fh.read()
    except (OSError, UnicodeDecodeError) as exc:
        record["error"] = Finding("parse-error", rel, 1, 0, f"unreadable: {exc}")
        return record
    tree = None
    if not record["is_c"]:
        try:
            tree = ast.parse(src, filename=rel)
        except SyntaxError as exc:
            record["error"] = Finding(
                "parse-error", rel, exc.lineno or 1, exc.offset or 0,
                f"syntax error: {exc.msg}",
            )
            return record
    supp = suppressions_by_line(src)
    record["supp"] = supp
    src_lines = src.splitlines()
    record["supp_snippets"] = {ln: snippet_at(src_lines, ln) for ln in supp}
    per_file_mods, tree_mods = _split_checkers(_select_checkers(rule_names))
    for mod in per_file_mods:
        if (getattr(mod, "LANG", "py") == "c") != record["is_c"]:
            continue
        record["findings"].extend(mod.check(tree, src, rel, scoped=scoped))
    if not record["is_c"]:
        for mod in tree_mods:
            record["facts"][mod.RULE] = mod.extract(tree, src, rel, scoped=scoped)
    return record


def _worker(item):
    rel, filepath, scoped, rule_names = item
    return rel, _compute_record(rel, filepath, scoped, rule_names)


def _resolve_jobs(jobs: Optional[int], miss_count: int) -> int:
    if jobs is None:
        try:
            jobs = int(os.environ.get(_JOBS_ENV, "0") or "0")
        except ValueError:
            jobs = 0
    if jobs and jobs > 0:
        return jobs
    # auto: parallelize only when the cold set is big enough to amortize
    # worker startup (warm runs are cache hits and never get here)
    return min(os.cpu_count() or 1, 4) if miss_count >= 24 else 1


def run(
    paths: Sequence[str],
    rules: Optional[Sequence[str]] = None,
    baseline: Optional[str] = None,
    scoped: bool = True,
    hygiene: bool = False,
    jobs: Optional[int] = None,
    cache: Optional[bool] = None,
) -> RunResult:
    """Run the pass over ``paths`` (files or directories).

    ``rules`` restricts to a subset of checkers; ``scoped=False`` drops the
    per-checker path scoping (used by the fixture tests, whose snippets live
    under tests/ where e.g. the trace-safety scope would never look).

    ``hygiene=True`` (the CLI default on full-rule runs) makes rot itself a
    finding: a ``mochi-lint: disable`` comment that suppressed nothing this
    run, and a baseline fingerprint no current finding matches, each report
    under ``suppression-hygiene`` — the mechanism that keeps the suppression
    surface and the baseline from quietly outliving the code they excused.
    Meaningless under a rule subset (every other rule's suppressions would
    look unused), so it is force-disabled there.

    ``jobs``/``cache`` control the scan machinery only (see the cache block
    above); results are byte-identical across every setting.

    Three stages: (1) per-file — parse, per-file checkers, tree-checker
    ``extract()`` facts, served from the cache or computed (possibly in a
    worker pool); (2) link — each tree checker's ``link()`` over all facts
    (interprocedural, always recomputed); (3) triage — occurrence indexing,
    suppressions, baseline, hygiene, per file exactly as the single-loop
    runner did.
    """
    checkers = _checkers()
    if rules is not None:
        wanted = set(rules)
        unknown = wanted - {mod.RULE for mod in checkers}
        if unknown:
            raise ValueError(f"unknown rules: {sorted(unknown)}")
        checkers = [mod for mod in checkers if mod.RULE in wanted]
        hygiene = False
    rule_names = tuple(mod.RULE for mod in checkers)
    per_file_mods, tree_mods = _split_checkers(checkers)
    known = load_baseline(baseline)
    matched_baseline: Set[str] = set()
    result = RunResult()
    files = iter_python_files(paths)

    # ---- stage 1: per-file records (cache -> pool -> serial)
    token = _toolchain_token()
    cdir = cache_dir() if cache in (None, True) else None
    records: Dict[str, Dict] = {}
    misses: List[Tuple[str, str, bool, Tuple[str, ...]]] = []
    for rel, filepath in files:
        cached = _cache_load(cdir, filepath, token, scoped, rule_names)
        if cached is not None:
            records[rel] = cached
        else:
            misses.append((rel, filepath, scoped, rule_names))
    n_jobs = _resolve_jobs(jobs, len(misses))
    pooled = False
    if n_jobs > 1 and len(misses) > 1:
        try:
            import multiprocessing
            from concurrent.futures import ProcessPoolExecutor

            # spawn, not fork: the caller may have JAX (or anything
            # multithreaded) loaded, and forking a threaded process can
            # deadlock the children
            with ProcessPoolExecutor(
                max_workers=n_jobs,
                mp_context=multiprocessing.get_context("spawn"),
            ) as pool:
                for rel, record in pool.map(_worker, misses, chunksize=8):
                    records[rel] = record
            pooled = True
        except _CACHE_ERRORS:
            # pool unavailable (sandbox, fork limits): records computed so
            # far are kept; the serial loop below fills the rest
            pooled = False
    if not pooled:
        for item in misses:
            if item[0] not in records:
                rel, record = _worker(item)
                records[rel] = record
    if cdir:
        for item in misses:
            _cache_store(cdir, item[1], token, scoped, rule_names,
                         records[item[0]])

    # ---- stage 2: link (interprocedural tree checkers)
    ordered = [rel for rel, _ in files]
    link_by_path: Dict[str, List[Finding]] = {}
    for mod in tree_mods:
        facts = [
            records[rel]["facts"].get(mod.RULE)
            for rel in ordered
            if records[rel]["error"] is None and not records[rel]["is_c"]
        ]
        for finding in mod.link([f for f in facts if f], scoped=scoped):
            link_by_path.setdefault(finding.path, []).append(finding)

    # ---- stage 3: per-file triage (semantics identical to the old loop)
    for rel, filepath in files:
        record = records[rel]
        if record["error"] is not None:
            result.new.append(record["error"])
            continue
        result.files_scanned += 1
        result.scanned.append(rel)
        supp = record["supp"]
        file_findings = list(record["findings"]) + link_by_path.pop(rel, [])
        # Occurrence indices in deterministic (line, col) order, so each of
        # N identical snippets gets its own fingerprint (see Finding).
        seen_snippets: Dict[Tuple[str, str], int] = {}
        used_supp_lines: Set[int] = set()
        for finding in sorted(file_findings, key=lambda f: (f.line, f.col)):
            key = (finding.rule, finding.snippet.strip())
            idx = seen_snippets.get(key, 0)
            seen_snippets[key] = idx + 1
            if idx:
                finding = replace(finding, occurrence=idx)
            supp_line = suppression_line_for(finding, supp)
            if supp_line is not None:
                used_supp_lines.add(supp_line)
                result.suppressed.append(finding)
            elif finding.fingerprint in known:
                matched_baseline.add(finding.fingerprint)
                result.baselined.append(finding)
            else:
                result.new.append(finding)
        if hygiene:
            for line, named in sorted(supp.items()):
                if line in used_supp_lines:
                    continue
                # Only convict a comment this run could have vindicated:
                # every named rule (or "all") must be among the checkers
                # that actually ran over this file kind (tree checkers are
                # Python-side).
                ran = {
                    mod.RULE
                    for mod in per_file_mods
                    if (getattr(mod, "LANG", "py") == "c") == record["is_c"]
                }
                if not record["is_c"]:
                    ran |= {mod.RULE for mod in tree_mods}
                if "all" not in named and not named <= ran:
                    continue
                result.new.append(
                    Finding(
                        HYGIENE_RULE, rel, line, 0,
                        f"unused suppression (disable={','.join(sorted(named))}): "
                        "no finding on this or the next line needs it — delete "
                        "the comment (or fix the drift that orphaned it)",
                        record["supp_snippets"].get(line, ""),
                    )
                )
    # link findings on paths outside the scanned set (defensive: an anchor
    # path the caller excluded) still fail rather than vanish
    for extras in link_by_path.values():
        result.new.extend(extras)
    if hygiene and known:
        # Staleness is only decidable with coverage: an unmatched entry on
        # a partial-path run may belong to a file this run never scanned
        # (convicting it — and the message's --write-baseline advice —
        # would silently amnesty every unscanned file's debt).  The
        # baseline records the display paths it was written against;
        # convict only when this run re-scanned ALL of them (display paths
        # are cwd-independent, so set containment is exact).  A legacy
        # baseline without the record — or one referencing a since-deleted
        # file — never convicts; regenerating once upgrades/heals it.
        recorded = load_baseline_paths(baseline)
        covered = recorded is not None and recorded <= set(result.scanned)
        if covered:
            stale = sorted(known - matched_baseline)
            base_rel = display_path(baseline) if baseline else "baseline"
            for fp in stale:
                result.new.append(
                    Finding(
                        HYGIENE_RULE, base_rel, 1, 0,
                        f"stale baseline entry {fp}: no current finding "
                        "matches it — prune it (python -m mochi_tpu_torch.analysis "
                        "--write-baseline regenerates)",
                        snippet=fp,
                    )
                )
    return result
