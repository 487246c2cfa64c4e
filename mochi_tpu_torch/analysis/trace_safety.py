"""jax-trace-safety: host sync points and Python branching on traced values.

The verifier's whole performance story is that one ``jax.jit`` traces the
complete Ed25519 pipeline into a single XLA program (SURVEY.md §7: "no
data-dependent Python control flow").  Inside traced code, a Python ``if``
on an array value raises ``TracerBoolConversionError`` at best — and at
worst silently *retraces per value* when the branch condition happens to be
weakly typed.  ``float(x)`` / ``int(x)`` / ``x.item()`` force a blocking
device->host transfer that serializes the XLA pipeline; ``np.*`` calls on
traced operands silently fall back to host numpy, dropping the operand out
of the fused program.

Scope (``scoped=True``): files under ``crypto/`` and ``parallel/`` — the
two packages whose code runs under trace.  A function is considered traced
if it is decorated with a jit-like decorator (``jit``, ``pjit``,
``pallas_call``, ``partial(jit, ...)``) or if any parameter is annotated as
a JAX array (``jnp.ndarray``, ``jax.Array``) — the convention this
codebase already follows throughout ``crypto/field.py`` / ``curve.py``.

Static-shape escapes are exempt: ``.shape`` / ``.ndim`` / ``.dtype`` /
``.size`` are trace-time constants, so branching on them is exactly how
this code selects kernel variants.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set

from .core import Finding, build_import_map, dotted_name, resolve_call, snippet_at

RULE = "jax-trace-safety"

_JIT_DECORATORS = {"jit", "pjit", "pallas_call", "custom_vjp", "checkpoint"}
_ARRAY_ANNOTATIONS = ("jnp.ndarray", "jax.Array", "jax.numpy.ndarray", "Array")
_STATIC_ATTRS = {"shape", "ndim", "dtype", "size"}
_HOST_SYNC_CALLS = {"float", "int", "bool", "complex"}
_HOST_SYNC_METHODS = {"item", "tolist", "__array__"}


def _decorator_is_jit(node: ast.AST) -> bool:
    if isinstance(node, ast.Call):
        # @partial(jax.jit, ...) / @jax.jit(static_argnums=...)
        inner = dotted_name(node.func)
        if inner and inner.split(".")[-1] == "partial" and node.args:
            return _decorator_is_jit(node.args[0])
        node = node.func
    dn = dotted_name(node)
    return bool(dn) and dn.split(".")[-1] in _JIT_DECORATORS


def _static_argnames(decorators) -> Set[str]:
    """Parameters declared static via ``static_argnames=(...)`` — they are
    Python values at trace time, so branching on them is exactly right."""
    static: Set[str] = set()
    for dec in decorators:
        if not isinstance(dec, ast.Call):
            continue
        for kw in dec.keywords:
            if kw.arg == "static_argnames":
                value = kw.value
                elts = (
                    value.elts
                    if isinstance(value, (ast.Tuple, ast.List))
                    else [value]
                )
                for elt in elts:
                    if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                        static.add(elt.value)
    return static


def _annotation_is_array(node: Optional[ast.AST]) -> bool:
    if node is None:
        return False
    try:
        text = ast.unparse(node)
    except Exception:  # pragma: no cover - unparse is total on parsed trees
        return False
    return any(marker in text for marker in _ARRAY_ANNOTATIONS)


def _traced_params(func) -> Set[str]:
    args = func.args
    all_args = args.posonlyargs + args.args + args.kwonlyargs
    traced = {a.arg for a in all_args if _annotation_is_array(a.annotation)}
    if not traced and any(_decorator_is_jit(d) for d in func.decorator_list):
        # Un-annotated jitted function: every parameter is a tracer.
        traced = {a.arg for a in all_args if a.arg not in ("self", "cls")}
    return traced - _static_argnames(func.decorator_list)


def _static_exempt_names(expr: ast.AST) -> Set[int]:
    """ids of Name nodes under a static-attribute access (``x.shape[0]``)."""
    exempt: Set[int] = set()
    for node in ast.walk(expr):
        if isinstance(node, ast.Attribute) and node.attr in _STATIC_ATTRS:
            for sub in ast.walk(node.value):
                if isinstance(sub, ast.Name):
                    exempt.add(id(sub))
    return exempt


def _traced_names_in(expr: ast.AST, traced: Set[str]) -> List[ast.Name]:
    exempt = _static_exempt_names(expr)
    return [
        node
        for node in ast.walk(expr)
        if isinstance(node, ast.Name)
        and node.id in traced
        and id(node) not in exempt
    ]


class _TracedBodyVisitor(ast.NodeVisitor):
    def __init__(self, traced, imports, src_lines, path):
        self.traced = traced
        self.imports = imports
        self.src_lines = src_lines
        self.path = path
        self.findings: List[Finding] = []

    def _flag(self, node: ast.AST, message: str) -> None:
        self.findings.append(
            Finding(
                RULE, self.path, node.lineno, node.col_offset, message,
                snippet_at(self.src_lines, node.lineno),
            )
        )

    # Nested defs get their own _traced_params treatment at the top level.
    def visit_FunctionDef(self, node):
        pass

    def visit_AsyncFunctionDef(self, node):
        pass

    def _check_branch(self, node, test: ast.AST, kind: str) -> None:
        hits = _traced_names_in(test, self.traced)
        if hits:
            self._flag(
                node,
                f"Python {kind} on traced value `{hits[0].id}`; use "
                "jnp.where / lax.select / lax.cond (shape/dtype branching "
                "is exempt)",
            )

    def visit_If(self, node: ast.If) -> None:
        self._check_branch(node, node.test, "`if`")
        self.generic_visit(node)

    def visit_While(self, node: ast.While) -> None:
        self._check_branch(node, node.test, "`while`")
        self.generic_visit(node)

    def visit_IfExp(self, node: ast.IfExp) -> None:
        self._check_branch(node, node.test, "conditional expression")
        self.generic_visit(node)

    def visit_Assert(self, node: ast.Assert) -> None:
        self._check_branch(node, node.test, "`assert`")
        self.generic_visit(node)

    def visit_For(self, node: ast.For) -> None:
        hits = _traced_names_in(node.iter, self.traced)
        if hits:
            self._flag(
                node,
                f"Python `for` iterates over traced value `{hits[0].id}`; "
                "use lax.fori_loop / lax.scan (range(x.shape[i]) is exempt)",
            )
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        func = node.func
        if isinstance(func, ast.Name) and func.id in _HOST_SYNC_CALLS:
            hits = []
            for arg in node.args:
                hits.extend(_traced_names_in(arg, self.traced))
            if hits:
                self._flag(
                    node,
                    f"`{func.id}(...)` on traced value `{hits[0].id}` forces "
                    "a host sync inside the traced program",
                )
        elif isinstance(func, ast.Attribute) and func.attr in _HOST_SYNC_METHODS:
            if _traced_names_in(func.value, self.traced):
                self._flag(
                    node,
                    f"`.{func.attr}()` forces a blocking device->host "
                    "transfer inside the traced program",
                )
        else:
            qualified = resolve_call(func, self.imports)
            if qualified is not None and (
                qualified.startswith("numpy.") or qualified.startswith("np.")
            ):
                hits = []
                for arg in node.args:
                    hits.extend(_traced_names_in(arg, self.traced))
                if hits:
                    self._flag(
                        node,
                        f"host numpy op `{qualified}` on traced value "
                        f"`{hits[0].id}`; use jnp inside traced code",
                    )
        self.generic_visit(node)


def _in_scope(path: str) -> bool:
    parts = path.split("/")
    return "crypto" in parts or "parallel" in parts


def check(tree: ast.Module, src: str, path: str, scoped: bool = True) -> List[Finding]:
    if scoped and not _in_scope(path):
        return []
    imports = build_import_map(tree)
    src_lines = src.splitlines()
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            traced = _traced_params(node)
            if not traced:
                continue
            visitor = _TracedBodyVisitor(traced, imports, src_lines, path)
            for stmt in node.body:
                visitor.visit(stmt)
            findings.extend(visitor.findings)
    return findings
