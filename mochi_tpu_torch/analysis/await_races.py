"""await-races: stale shared state across ``await`` points (async TOCTOU).

The whole data plane is single-threaded-by-event-loop: the store has no
locks because "the replica's event loop is the lock".  That discipline has
one sharp edge — an ``await`` RELEASES the lock.  Any replica/client state
read before a suspension point and trusted after it may describe a world
that no longer exists: the last three PRs each shipped a hand-found fix of
exactly this class (SessionTable eviction between auth and response-seal,
in-flight msg-id eviction, grant-reclaim racing a slow Write2).  This
checker finds the pattern mechanically, per coroutine, with a linear
await-segment dataflow: every statement gets the index of awaits crossed
before it, and facts that pair across different segments are findings.

Four sub-rules, tiered by how directly each one corrupts protocol state:

* **check-then-act** (severity ``high``) — an ``if``/``while`` guard reads
  a ``self.``-rooted table (truthiness, ``in``, ``.get``, ``len``) and a
  MUTATION of the same table (``[k] = ``, ``del``, ``.pop/.add/.remove/
  .update/...``) executes in a LATER await segment with no re-read of that
  table after the last await before the act.  The guard's verdict is stale
  by the time the act runs — the SessionTable-eviction bug shape.  A
  re-validating read in the act's own segment clears the finding (the
  double-checked idiom), as does an enclosing ``with``/``async with``
  whose context expression names a lock.

* **stale-read** (``medium``) — a local bound from an ELEMENT read of
  shared state (``self.X[k]``, ``self.X.get(k)``, ``.items/.keys/
  .values/.copy``, including inside comprehensions) and first USED in a
  later await segment without rebinding.  The value may be an evicted
  session key, a reclaimed grant, a superseded config row.

* **shared-iter** (``medium``) — ``for``/``async for`` directly over a
  ``self.``-rooted container (not a ``list(...)``/``sorted(...)``/
  ``tuple(...)``/``set(...)``/``dict(...)`` snapshot) whose body awaits:
  any concurrent task that mutates the container mid-iteration raises
  ``RuntimeError: dictionary changed size during iteration`` — at runtime,
  under load, in whichever task loses the race.

* **tally-authority** (``high``) — a ``QuorumTally``/``GrantAssembler``
  liveness tracker's STATE (``.chosen``, ``.satisfied``, anything but
  ``.add``) consumed after an await.  The trackers exist only to decide
  when to stop WAITING (client/txn.py); consuming their verdict as the
  commit-path truth skips the authoritative re-tally that makes
  early-quorum safe ("quorum-tally results consumed without the
  authoritative re-check").

Scope: ``async def`` bodies anywhere in the tree (the bug class is not
path-local).  Shared state means attribute chains rooted at ``self`` —
module globals and closure cells are rarer here and excluded to keep the
signal clean.  Branches of ``if``/``try`` are threaded sequentially
(conservative: an await in either arm splits segments for what follows);
loop bodies containing an await are walked twice so a read late in the
body pairs with a use early in the next iteration.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .core import Finding, snippet_at

RULE = "await-races"

# element-read methods: the call reads a value OUT of the container
_READ_METHODS = {"get", "items", "keys", "values", "copy"}
# mutating-call methods on a shared container
_MUTATE_METHODS = {
    "pop", "popitem", "clear", "update", "setdefault", "add", "remove",
    "discard", "append", "extend", "insert",
}
# wrapping any of these around the iterable snapshots it — iteration is safe
_SNAPSHOT_CALLS = {"list", "tuple", "sorted", "set", "dict", "frozenset", "enumerate"}
# liveness trackers whose post-await state must never be authoritative
_TRACKER_TYPES = {"QuorumTally", "GrantAssembler"}


_LOCK_WORDS = {"lock", "locks", "mutex", "semaphore"}
_WORD_RE = re.compile(r"[A-Za-z][a-z0-9]*")


def _names_a_lock(expr: ast.AST) -> bool:
    """True when a ``with`` context expression names a lock: some
    IDENTIFIER in it (variable, attribute, called type) contains the word
    lock/mutex/semaphore under snake_case/CamelCase splitting.  Word-level,
    not substring — ``self.clock()`` and ``self.blocking_io()`` must NOT
    silence the checker (the substring "lock" inside an unrelated word
    would disable the high-severity check-then-act rule for the block)."""
    for node in ast.walk(expr):
        name = None
        if isinstance(node, ast.Name):
            name = node.id
        elif isinstance(node, ast.Attribute):
            name = node.attr
        if name and not _LOCK_WORDS.isdisjoint(
            w.lower() for w in _WORD_RE.findall(name)
        ):
            return True
    return False


def _self_chain(node: ast.AST) -> Optional[str]:
    """``self.a.b`` -> "self.a.b" for Attribute chains rooted at ``self``
    (Load context only matters to callers)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name) and node.id == "self" and parts:
        return ".".join(["self"] + list(reversed(parts)))
    return None


def _shared_reads(expr: ast.AST) -> Set[str]:
    """Every shared table a guard expression consults: bare truthiness
    (``self.X``), membership (``k in self.X``), ``self.X.get(...)``,
    ``len(self.X)``/``bool(self.X)``, ``self.X[k]``."""
    out: Set[str] = set()
    for node in ast.walk(expr):
        if isinstance(node, ast.Attribute):
            chain = _self_chain(node)
            if chain is not None:
                out.add(chain)
        elif isinstance(node, ast.Name) and node.id == "self":
            continue
    return out


def _store_names(target: ast.AST) -> Set[str]:
    """Every plain Name a binding target (re)binds — Store-context only, so
    ``self.table[k] = v`` does not claim to rebind ``k``.  Tuple/list
    unpacks, starred elements, and for/with targets all hand the name a
    FRESH value, so any stale-read tracking on it must clear."""
    out: Set[str] = set()
    for node in ast.walk(target):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            out.add(node.id)
    return out


def _pattern_names(pattern: ast.AST) -> Set[str]:
    """Names a match-case pattern captures (``MatchAs``/``MatchStar`` binds,
    ``MatchMapping`` rest) — fresh bindings, same invalidation as
    assignment."""
    out: Set[str] = set()
    for node in ast.walk(pattern):
        if isinstance(node, (ast.MatchAs, ast.MatchStar)) and node.name:
            out.add(node.name)
        elif isinstance(node, ast.MatchMapping) and node.rest:
            out.add(node.rest)
    return out


def _element_read_keys(expr: ast.AST) -> Set[str]:
    """Shared chains the expression reads an ELEMENT (or live view) of —
    the narrower read set rule (a) tracks into locals.  Slice subscripts
    (``self.client_id[:8]``) are excluded: slicing COPIES, and in this tree
    it is how immutable ids/byte strings get abbreviated, not how table
    entries get read."""
    out: Set[str] = set()
    for node in ast.walk(expr):
        if isinstance(node, ast.Subscript):
            if isinstance(node.slice, ast.Slice):
                continue
            chain = _self_chain(node.value)
            if chain is not None:
                out.add(chain)
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if node.func.attr in _READ_METHODS:
                chain = _self_chain(node.func.value)
                if chain is not None:
                    out.add(chain)
    return out


def _tracked_read_keys(value: ast.AST) -> Set[str]:
    """Shared chains a LOCAL BINDING inherits staleness from.

    Narrower than :func:`_element_read_keys` at the top level on purpose:
    only value shapes that *are* a read out of shared state taint the local
    — a direct element read (``self.X[k]``), a read-method call
    (``self.X.get(k)``), a comprehension whose body or iterable reads
    shared state, or a conditional/boolean combination of those.  An
    arbitrary call that merely TAKES an element read as an argument
    (``self._new_replica(self.config.servers[k].host)``) constructs a new
    value; flagging it taught the first dry run that constructor calls
    drown the signal."""
    if isinstance(value, ast.Subscript):
        if isinstance(value.slice, ast.Slice):
            return set()
        chain = _self_chain(value.value)
        return {chain} if chain is not None else set()
    if isinstance(value, ast.Call) and isinstance(value.func, ast.Attribute):
        if value.func.attr in _READ_METHODS:
            chain = _self_chain(value.func.value)
            return {chain} if chain is not None else set()
        return set()
    if isinstance(value, (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)):
        return _element_read_keys(value)
    if isinstance(value, ast.BoolOp):
        out: Set[str] = set()
        for sub in value.values:
            out |= _tracked_read_keys(sub)
        return out
    if isinstance(value, ast.IfExp):
        return _tracked_read_keys(value.body) | _tracked_read_keys(value.orelse)
    return set()


def _contains_await(node: ast.AST) -> bool:
    """Await anywhere under ``node``, not counting nested function bodies
    (those suspend their own schedule, not this one)."""
    stack: List[ast.AST] = [node]
    while stack:
        cur = stack.pop()
        if isinstance(cur, (ast.Await, ast.AsyncFor, ast.AsyncWith)):
            return True
        for child in ast.iter_child_nodes(cur):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            stack.append(child)
    return False


@dataclass
class _Guard:
    key: str          # shared chain the guard read
    seg: int          # await segment of the read
    line: int


@dataclass
class _LocalRead:
    keys: Set[str]
    seg: int
    line: int
    reported: bool = False


@dataclass
class _FnState:
    seg: int = 0                      # awaits crossed so far
    guards: List[_Guard] = field(default_factory=list)
    locals_: Dict[str, _LocalRead] = field(default_factory=dict)
    # shared chain -> latest segment it was (re-)read in
    last_read_seg: Dict[str, int] = field(default_factory=dict)
    # local name -> (tracker type, creation segment)
    trackers: Dict[str, Tuple[str, int]] = field(default_factory=dict)
    lock_depth: int = 0               # inside `with <...lock...>:`


class _CoroutineChecker:
    def __init__(self, src_lines, path: str):
        self.src_lines = src_lines
        self.path = path
        self.findings: List[Finding] = []
        self._seen_sites: Set[Tuple[str, int, int]] = set()

    # ------------------------------------------------------------- reporting

    def _report(self, kind: str, severity: str, line: int, col: int, msg: str) -> None:
        site = (kind, line, col)
        if site in self._seen_sites:
            return  # loop second pass re-visits the same nodes
        self._seen_sites.add(site)
        self.findings.append(
            Finding(
                RULE, self.path, line, col, f"[{kind}] {msg}",
                snippet_at(self.src_lines, line), severity=severity,
            )
        )

    # ------------------------------------------------------------ fn driver

    def check_function(self, fn: ast.AsyncFunctionDef) -> None:
        st = _FnState()
        self._walk_body(fn.body, st)

    def _walk_body(self, body, st: _FnState) -> None:
        for stmt in body:
            self._walk_stmt(stmt, st)

    # ----------------------------------------------------------- statements

    def _walk_stmt(self, stmt: ast.stmt, st: _FnState) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return  # nested defs are their own schedules
        if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            self._handle_assign(stmt, st)
            return
        if isinstance(stmt, ast.Expr):
            self._scan_expr(stmt.value, st)
            return
        if isinstance(stmt, ast.Return) and stmt.value is not None:
            self._scan_expr(stmt.value, st)
            return
        if isinstance(stmt, ast.Delete):
            for tgt in stmt.targets:
                if isinstance(tgt, ast.Subscript):
                    chain = _self_chain(tgt.value)
                    if chain is not None:
                        self._mutation(chain, stmt.lineno, stmt.col_offset, st)
            return
        if isinstance(stmt, (ast.If, ast.While)):
            keys = _shared_reads(stmt.test)
            for k in keys:
                st.last_read_seg[k] = st.seg
                st.guards.append(_Guard(k, st.seg, stmt.lineno))
            self._scan_expr(stmt.test, st)
            repeat = isinstance(stmt, ast.While) and _contains_await(stmt)
            self._walk_body(stmt.body, st)
            self._walk_body(stmt.orelse, st)
            if repeat:
                # second pass: late-body facts pair with early-body uses
                for k in keys:
                    st.last_read_seg[k] = st.seg
                    st.guards.append(_Guard(k, st.seg, stmt.lineno))
                self._walk_body(stmt.body, st)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._handle_for(stmt, st)
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            locked = any(
                _names_a_lock(item.context_expr) for item in stmt.items
            )
            for item in stmt.items:
                self._scan_expr(item.context_expr, st)
                if item.optional_vars is not None:
                    for name in _store_names(item.optional_vars):
                        st.locals_.pop(name, None)
                        st.trackers.pop(name, None)
            if isinstance(stmt, ast.AsyncWith):
                st.seg += 1  # __aenter__ suspends
            if locked:
                st.lock_depth += 1
            self._walk_body(stmt.body, st)
            if locked:
                st.lock_depth -= 1
            if isinstance(stmt, ast.AsyncWith):
                st.seg += 1  # __aexit__ suspends
            return
        if isinstance(stmt, ast.Try):
            self._walk_body(stmt.body, st)
            for handler in stmt.handlers:
                self._walk_body(handler.body, st)
            self._walk_body(stmt.orelse, st)
            self._walk_body(stmt.finalbody, st)
            return
        if isinstance(stmt, (ast.Raise, ast.Assert)):
            for sub in ast.iter_child_nodes(stmt):
                self._scan_expr(sub, st)
            return
        if isinstance(stmt, ast.Match):
            # the subject and case guards are guard-shaped reads, and case
            # bodies are real statement suites — the expression-only
            # fallback below would leave every sub-rule blind inside them
            for k in _shared_reads(stmt.subject):
                st.last_read_seg[k] = st.seg
                st.guards.append(_Guard(k, st.seg, stmt.lineno))
            self._scan_expr(stmt.subject, st)
            for case in stmt.cases:
                for name in _pattern_names(case.pattern):
                    st.locals_.pop(name, None)
                    st.trackers.pop(name, None)
                if case.guard is not None:
                    for k in _shared_reads(case.guard):
                        st.last_read_seg[k] = st.seg
                        st.guards.append(_Guard(k, st.seg, case.guard.lineno))
                    self._scan_expr(case.guard, st)
                self._walk_body(case.body, st)
            return
        # fallback: scan any embedded expressions generically
        for sub in ast.iter_child_nodes(stmt):
            if isinstance(sub, ast.expr):
                self._scan_expr(sub, st)

    def _handle_for(self, stmt, st: _FnState) -> None:
        # rule (c): iterating a live shared container with awaits inside
        is_async = isinstance(stmt, ast.AsyncFor)
        it = stmt.iter
        chain = _self_chain(it)
        if chain is None and isinstance(it, ast.Call):
            func = it.func
            # `.copy()` is the other standard snapshot idiom (a NEW dict/
            # set/list): iterating it cannot raise changed-size — only the
            # genuinely-live view methods (items/keys/values/get) count
            if isinstance(func, ast.Attribute) and func.attr in (
                _READ_METHODS - {"copy"}
            ):
                chain = _self_chain(func.value)
            elif isinstance(func, ast.Name) and func.id in _SNAPSHOT_CALLS:
                chain = None  # snapshot: safe
        body_awaits = is_async or any(_contains_await(s) for s in stmt.body)
        if chain is not None and body_awaits:
            self._report(
                "shared-iter", "medium", stmt.lineno, stmt.col_offset,
                f"iterating live shared container `{chain}` across an await: "
                "a concurrent task mutating it mid-suspension raises "
                "`RuntimeError: changed size during iteration` — iterate a "
                "`list(...)` snapshot",
            )
        self._scan_expr(it, st)
        # the loop target is a fresh binding each iteration
        for name in _store_names(stmt.target):
            st.locals_.pop(name, None)
            st.trackers.pop(name, None)
        if is_async:
            st.seg += 1
        repeat = body_awaits
        self._walk_body(stmt.body, st)
        self._walk_body(stmt.orelse, st)
        if repeat:
            self._walk_body(stmt.body, st)

    def _handle_assign(self, stmt, st: _FnState) -> None:
        value = getattr(stmt, "value", None)
        if value is None:
            return
        if isinstance(stmt, ast.AugAssign) and isinstance(stmt.target, ast.Name):
            # `n += ...` LOADS n before evaluating the RHS — that read is
            # subject to rule (a) like any other post-await use
            self._scan_ordered(
                ast.copy_location(
                    ast.Name(id=stmt.target.id, ctx=ast.Load()), stmt.target
                ),
                st,
            )
        self._scan_expr(value, st)
        targets = (
            stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
        )
        # mutations through subscript/attr stores on shared chains
        for tgt in targets:
            if isinstance(tgt, ast.Subscript):
                chain = _self_chain(tgt.value)
                if chain is not None:
                    self._mutation(chain, stmt.lineno, stmt.col_offset, st)
            elif isinstance(tgt, ast.Tuple):
                for elt in tgt.elts:
                    if isinstance(elt, ast.Subscript):
                        chain = _self_chain(elt.value)
                        if chain is not None:
                            self._mutation(chain, stmt.lineno, stmt.col_offset, st)
        if isinstance(stmt, ast.AugAssign) and isinstance(stmt.target, ast.Attribute):
            chain = _self_chain(stmt.target)
            if chain is not None:
                self._mutation(chain, stmt.lineno, stmt.col_offset, st)
        if isinstance(stmt, ast.AugAssign) and isinstance(stmt.target, ast.Name):
            # rebinding ends tracking: the name now holds a derived value
            # (the stale load itself was already judged above)
            st.locals_.pop(stmt.target.id, None)
            st.trackers.pop(stmt.target.id, None)
        # rule (a) tracking: a simple Name bind from an element read starts
        # tracking; EVERY other Name bind (tuple unpack, annotated assign)
        # clears it — the name now holds a fresh value, and a live stale
        # entry would false-positive on its post-await use (which, under
        # the --changed-only PR gate, blocks the PR into a bogus
        # suppression).
        if isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target, ast.Name):
            tgt = stmt.target
        elif (
            isinstance(stmt, ast.Assign)
            and len(stmt.targets) == 1
            and isinstance(stmt.targets[0], ast.Name)
        ):
            tgt = stmt.targets[0]
        else:
            if isinstance(stmt, ast.Assign):
                for t in stmt.targets:
                    for name in _store_names(t):
                        st.locals_.pop(name, None)
                        st.trackers.pop(name, None)
            return
        # rule (d) tracking: liveness trackers by construction
        if isinstance(value, ast.Call):
            fname = value.func
            name = (
                fname.id if isinstance(fname, ast.Name)
                else fname.attr if isinstance(fname, ast.Attribute)
                else None
            )
            if name in _TRACKER_TYPES:
                st.trackers[tgt.id] = (name, st.seg)
                st.locals_.pop(tgt.id, None)
                return
        keys = _tracked_read_keys(value)
        if keys and not _contains_await(value):
            st.locals_[tgt.id] = _LocalRead(keys, st.seg, stmt.lineno)
        else:
            st.locals_.pop(tgt.id, None)
        st.trackers.pop(tgt.id, None)

    # ---------------------------------------------------------- expressions

    def _mutation(self, chain: str, line: int, col: int, st: _FnState) -> None:
        """Rule (b): act on a shared table whose guard is in an older await
        segment with no re-read since the last await."""
        if st.lock_depth > 0:
            return  # double-checked-locking idiom: the lock serializes
        stale_guards = [g for g in st.guards if g.key == chain and g.seg < st.seg]
        if not stale_guards:
            return
        if st.last_read_seg.get(chain) == st.seg:
            return  # re-validated after the last await before the act
        g = stale_guards[-1]
        self._report(
            "check-then-act", "high", line, col,
            f"`{chain}` mutated here but its guard (line {g.line}) ran "
            f"{st.seg - g.seg} await(s) ago: the check's verdict is stale — "
            "re-validate after the await (or restructure so check and act "
            "share one loop turn)",
        )

    def _scan_expr(self, expr: ast.AST, st: _FnState) -> None:
        """Order-aware scan of one expression: visits Awaits (segment
        bumps), local uses (rule a), tracker reads (rule d), mutating calls
        (rule b feed), and re-reads (validation bookkeeping).  DFS in
        source order — for expressions, evaluation order is close enough
        that awaits split what syntactically follows them."""
        self._scan_ordered(expr, st)

    def _scan_ordered(self, node: ast.AST, st: _FnState) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return
        if isinstance(node, ast.Lambda):
            return
        if isinstance(node, ast.Await):
            self._scan_ordered(node.value, st)
            st.seg += 1
            return
        if isinstance(node, ast.Call):
            func = node.func
            if isinstance(func, ast.Attribute):
                # mutating call on shared chain
                if func.attr in _MUTATE_METHODS:
                    chain = _self_chain(func.value)
                    if chain is not None:
                        # arguments (incl. keywords) evaluate BEFORE the
                        # mutation — an await inside either is a segment
                        # boundary the mutation must be judged after
                        for arg in node.args:
                            self._scan_ordered(arg, st)
                        for kw in node.keywords:
                            self._scan_ordered(kw.value, st)
                        self._mutation(chain, node.lineno, node.col_offset, st)
                        return
                # read-method call on shared chain refreshes validation
                if func.attr in _READ_METHODS:
                    chain = _self_chain(func.value)
                    if chain is not None:
                        st.last_read_seg[chain] = st.seg
                # rule (d): tracker state read (non-.add attribute access)
            self._scan_ordered(func, st)
            for arg in node.args:
                self._scan_ordered(arg, st)
            for kw in node.keywords:
                self._scan_ordered(kw.value, st)
            return
        if isinstance(node, ast.Attribute):
            chain = _self_chain(node)
            if chain is not None:
                st.last_read_seg[chain] = st.seg
            if (
                isinstance(node.value, ast.Name)
                and node.value.id in st.trackers
                and node.attr != "add"
            ):
                tname, created = st.trackers[node.value.id]
                if st.seg > created:
                    self._report(
                        "tally-authority", "high", node.lineno, node.col_offset,
                        f"`{node.value.id}.{node.attr}` consumes the {tname} "
                        "liveness tracker's state after an await: the tracker "
                        "only decides when to stop waiting — recompute the "
                        "authoritative quorum over the returned responses "
                        "(client/txn.py contract)",
                    )
            self._scan_ordered(node.value, st)
            return
        if isinstance(node, ast.Subscript):
            chain = _self_chain(node.value)
            if chain is not None:
                st.last_read_seg[chain] = st.seg
            for sub in ast.iter_child_nodes(node):
                self._scan_ordered(sub, st)
            return
        if isinstance(node, ast.Compare):
            # membership test refreshes validation for the container
            for cmp_op, comparator in zip(node.ops, node.comparators):
                if isinstance(cmp_op, (ast.In, ast.NotIn)):
                    chain = _self_chain(comparator)
                    if chain is not None:
                        st.last_read_seg[chain] = st.seg
            for sub in ast.iter_child_nodes(node):
                self._scan_ordered(sub, st)
            return
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load):
            lr = st.locals_.get(node.id)
            if lr is not None and st.seg > lr.seg and not lr.reported:
                lr.reported = True
                self._report(
                    "stale-read", "medium", node.lineno, node.col_offset,
                    f"`{node.id}` was read from shared state "
                    f"({', '.join(sorted(lr.keys))}) at line {lr.line}, "
                    f"{st.seg - lr.seg} await(s) ago: the value may describe "
                    "evicted/reclaimed/superseded state — re-read it after "
                    "the await or justify why staleness is safe",
                )
            return
        for sub in ast.iter_child_nodes(node):
            if isinstance(sub, ast.AST):
                self._scan_ordered(sub, st)


def check(tree: ast.Module, src: str, path: str, scoped: bool = True) -> List[Finding]:
    del scoped  # a stale read across an await is a defect anywhere
    src_lines = src.splitlines()
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.AsyncFunctionDef):
            checker = _CoroutineChecker(src_lines, path)
            checker.check_function(node)
            findings.extend(checker.findings)
    return findings
