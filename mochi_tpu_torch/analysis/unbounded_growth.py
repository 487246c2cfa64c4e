"""unbounded-growth: shared containers keyed by per-identity values need a cap.

The bug class PRs 8/9 fixed by hand, three separate times: the session
table, the per-client stats map, and the ban book each grew one entry per
client identity with no LRU/TTL/cap, so any client churn (or an adversary
minting identities) grew replica memory without bound — a slow-motion
denial of service that no functional test catches because every individual
entry is correct.

The rule: inside a class, a builtin container attribute (``self.X = {}`` /
``[]`` / ``set()`` / ``defaultdict(...)`` / capless ``deque()``) that some
non-``__init__`` method grows with a key or element derived from a method
parameter (i.e. per-request / per-identity data), where the class shows NO
eviction evidence for that attribute — no ``pop``/``popitem``/``popleft``/
``clear``, no ``del self.X[...]``, no rotation (``self.X = ...`` outside
``__init__``), no ``len(self.X)`` bound check — is flagged at **advice**
severity.

Advice, not error, because the analysis cannot see the value-space: a dict
keyed by the fixed replica set is bounded by config even though the key
arrives as a parameter.  Where that's the case, say so with a suppression
naming this rule and the bound (``-- keyed by fixed replica set``).
(Written without a literal example here: the hygiene pass scans raw lines,
docstrings included.)

Bounded-by-construction containers (``deque(maxlen=...)``, wrapper classes
like SessionTable that own their eviction) are never candidates — only raw
builtin containers are.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from .core import Finding, snippet_at

RULE = "unbounded-growth"

_SCOPE_EXCLUDE = (
    "mochi_tpu_torch/testing/", "mochi_tpu_torch/analysis/",
    "mochi_tpu_torch/tools/",
)

_CONTAINER_CALLS = {"dict", "list", "set", "defaultdict", "OrderedDict",
                    "Counter", "deque"}
_GROW_METHODS = {"append", "add", "setdefault", "appendleft", "insert"}
_EVICT_METHODS = {"pop", "popitem", "popleft", "clear", "remove", "discard"}


def _attr_of_self(node: ast.AST) -> Optional[str]:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _container_attr(node: ast.Assign) -> Optional[str]:
    """``self.X = <builtin container ctor>`` -> X, else None.  A
    ``deque(maxlen=...)`` is bounded by construction and never a
    candidate."""
    if len(node.targets) != 1:
        return None
    attr = _attr_of_self(node.targets[0])
    if attr is None:
        return None
    v = node.value
    if isinstance(v, (ast.Dict, ast.List, ast.Set, ast.DictComp,
                      ast.ListComp, ast.SetComp)):
        return attr
    if isinstance(v, ast.Call):
        name = None
        if isinstance(v.func, ast.Name):
            name = v.func.id
        elif isinstance(v.func, ast.Attribute):
            name = v.func.attr
        if name in _CONTAINER_CALLS:
            if name == "deque" and any(kw.arg == "maxlen" for kw in v.keywords):
                return None
            return attr
    return None


def _derived_names(fn: ast.AST, params: Set[str]) -> Set[str]:
    """Names carrying per-request data: the parameters plus anything bound
    from them (loop targets over a parameter, locals assigned from one).
    Two forward passes approximate the transitive closure well enough for
    how handler bodies are actually written."""
    derived = set(params)
    for _ in range(2):
        for node in ast.walk(fn):
            if isinstance(node, (ast.For, ast.AsyncFor)):
                if any(
                    isinstance(n, ast.Name) and n.id in derived
                    for n in ast.walk(node.iter)
                ):
                    for t in ast.walk(node.target):
                        if isinstance(t, ast.Name):
                            derived.add(t.id)
            elif isinstance(node, ast.Assign):
                if any(
                    isinstance(n, ast.Name) and n.id in derived
                    for n in ast.walk(node.value)
                ):
                    for tgt in node.targets:
                        for t in ast.walk(tgt):
                            if isinstance(t, ast.Name) and not _attr_of_self(t):
                                derived.add(t.id)
    return derived


def _uses_derived(node: ast.AST, derived: Set[str]) -> bool:
    return any(
        isinstance(n, ast.Name) and n.id in derived for n in ast.walk(node)
    )


def _check_class(cls: ast.ClassDef, src_lines, path: str) -> List[Finding]:
    methods = [
        n for n in cls.body
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    ]
    containers: Set[str] = set()
    for fn in methods:
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                attr = _container_attr(node)
                if attr is not None:
                    containers.add(attr)
    if not containers:
        return []

    evicted: Set[str] = set()
    for fn in methods:
        in_init = fn.name == "__init__"
        for node in ast.walk(fn):
            # self.X.pop(...) / .clear() / ...
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
                attr = _attr_of_self(node.func.value)
                if attr in containers and node.func.attr in _EVICT_METHODS:
                    evicted.add(attr)
            # len(self.X) bound check anywhere: evidence the class enforces
            # a cap (the comparison is usually adjacent)
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "len"
                and node.args
            ):
                attr = _attr_of_self(node.args[0])
                if attr in containers:
                    evicted.add(attr)
            # del self.X[...]
            if isinstance(node, ast.Delete):
                for tgt in node.targets:
                    base = tgt.value if isinstance(tgt, ast.Subscript) else tgt
                    attr = _attr_of_self(base)
                    if attr in containers:
                        evicted.add(attr)
            # rotation / trim: self.X = <anything> outside __init__
            if not in_init and isinstance(node, ast.Assign):
                for tgt in node.targets:
                    attr = _attr_of_self(tgt)
                    if attr in containers and _container_attr(node) is None:
                        evicted.add(attr)

    findings: List[Finding] = []
    reported: Set[str] = set()
    for fn in methods:
        if fn.name == "__init__":
            continue
        params = {
            a.arg
            for a in (fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs)
            if a.arg not in ("self", "cls")
        }
        if not params:
            continue
        derived = _derived_names(fn, params)
        for node in ast.walk(fn):
            attr = None
            witness = None
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Subscript):
                        a = _attr_of_self(tgt.value)
                        if a in containers and _uses_derived(tgt.slice, derived):
                            attr, witness = a, node
            elif (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _GROW_METHODS
            ):
                a = _attr_of_self(node.func.value)
                if a in containers and any(
                    _uses_derived(arg, derived) for arg in node.args
                ):
                    attr, witness = a, node
            if attr is None or attr in evicted or attr in reported:
                continue
            reported.add(attr)
            findings.append(
                Finding(
                    RULE, path, witness.lineno, witness.col_offset,
                    f"self.{attr} grows with per-request/per-identity data "
                    f"in {cls.name}.{fn.name}() and the class shows no "
                    "eviction (pop/del/clear/rotation/len-cap) — identity "
                    "churn grows it without bound (the SessionTable/"
                    "client_stats/ban-book bug class); add an LRU/TTL/cap "
                    "or justify the bound in a suppression",
                    snippet=snippet_at(src_lines, witness.lineno),
                    severity="advice",
                )
            )
    return findings


def check(tree: ast.Module, src: str, path: str, scoped: bool = True
          ) -> List[Finding]:
    if scoped:
        if not path.startswith("mochi_tpu_torch/"):
            return []
        if any(path.startswith(p) for p in _SCOPE_EXCLUDE):
            return []
    src_lines = src.splitlines()
    out: List[Finding] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            out.extend(_check_class(node, src_lines, path))
    return out
