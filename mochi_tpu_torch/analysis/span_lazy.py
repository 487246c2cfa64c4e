"""span-lazy-label: no eager string formatting in span-record arguments.

Head-based sampling means a span-record call on the drain hot loop is a
no-op for the overwhelming share of traffic (``Tracer.record`` returns
before touching its arguments when the context is unsampled) — but Python
evaluates ARGUMENTS before the call, so an f-string label or a
``"%s" % sid`` built at the call site is paid for every envelope whether
or not the span records.  That is the classic tracing perf bug: the
instrumentation's cost shows up exactly on the path it was supposed to be
free on, and a tracing overhead bound depends on not writing it.

The rule: a call to a tracer's span-recording surface (``record`` /
``span`` / ``mark_span`` on an object whose dotted path names a tracer)
must not format strings in its arguments — f-strings, ``%``, ``.format``,
or ``str1 + expr`` concatenation.  Pass constants and plain values; let
the tracer build labels after the sampling gate.

Exempt:

* ``force_mark(...)`` — the always-sample upgrade path (errors, sheds,
  convictions): it records unconditionally and fires rarely, so eager
  formatting is paid only when evidence is actually being written;
* call sites syntactically guarded by the sampling verdict — inside an
  ``if`` whose test consults ``.sampled`` or ``.wants(...)`` (the caller
  already established the span records before paying the formatting).

Scope (``scoped=True``): ``obs/``, ``net/``, ``server/`` — the tracing
module itself and the two packages whose code runs inside the drain hot
loop.  The tentpole's acceptance includes this pass running CLEAN over
``mochi_tpu_torch/obs/`` with zero suppressions.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from .core import Finding, dotted_name, snippet_at

RULE = "span-lazy-label"

# Span-recording method names subject to the rule; force_mark is the
# deliberate always-sampled exemption (see module docstring).
_SPAN_METHODS = {"record", "span", "mark_span"}


def _is_tracer_call(func: ast.AST) -> Optional[str]:
    """The method name when ``func`` is ``<something tracer-ish>.<span
    method>``; None otherwise.  "tracer-ish": some dotted segment names a
    tracer (``self.tracer``, ``tracer``, ``self._tracer`` ...) — precise
    enough to skip ``Timer.record`` / ``Metrics`` call sites entirely."""
    if not isinstance(func, ast.Attribute) or func.attr not in _SPAN_METHODS:
        return None
    dn = dotted_name(func.value)
    if dn is None:
        return None
    if any("tracer" in seg.lower() for seg in dn.split(".")):
        return func.attr
    return None


def _formats_string(expr: ast.AST) -> Optional[str]:
    """The kind of eager string formatting inside ``expr``, or None."""
    for node in ast.walk(expr):
        if isinstance(node, ast.JoinedStr):
            return "f-string"
        if isinstance(node, ast.BinOp):
            if isinstance(node.op, ast.Mod) and _is_str(node.left):
                return "%-format"
            if isinstance(node.op, ast.Add) and (
                _is_str(node.left) or _is_str(node.right)
            ):
                return "string concatenation"
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "format"
        ):
            return ".format()"
    return None


def _is_str(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and isinstance(node.value, str)


def _test_gates_sampling(test: ast.AST) -> bool:
    """True when an ``if`` test consults the sampling verdict
    (``ctx.sampled`` / ``tracer.wants(ctx)``): formatting below it only
    runs for spans that actually record."""
    for node in ast.walk(test):
        if isinstance(node, ast.Attribute) and node.attr == "sampled":
            return True
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "wants"
        ):
            return True
    return False


class _Visitor(ast.NodeVisitor):
    def __init__(self, src_lines, path):
        self.src_lines = src_lines
        self.path = path
        self.findings: List[Finding] = []
        self._guard_depth = 0

    def visit_If(self, node: ast.If) -> None:
        if _test_gates_sampling(node.test):
            self._guard_depth += 1
            for child in node.body:
                self.visit(child)
            self._guard_depth -= 1
            for child in node.orelse:
                self.visit(child)
        else:
            self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        method = _is_tracer_call(node.func)
        if method is not None and self._guard_depth == 0:
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                kind = _formats_string(arg)
                if kind is not None:
                    self.findings.append(
                        Finding(
                            RULE, self.path, node.lineno, node.col_offset,
                            f"eager {kind} in `.{method}(...)` argument: "
                            "evaluated per call even when the span is "
                            "unsampled — pass plain values (or guard with "
                            "`tracer.wants(ctx)` / `ctx.sampled`)",
                            snippet_at(self.src_lines, node.lineno),
                        )
                    )
                    break
        self.generic_visit(node)


def _in_scope(path: str) -> bool:
    parts = path.split("/")
    return "obs" in parts or "net" in parts or "server" in parts


def check(tree: ast.Module, src: str, path: str, scoped: bool = True) -> List[Finding]:
    if scoped and not _in_scope(path):
        return []
    visitor = _Visitor(src.splitlines(), path)
    visitor.visit(tree)
    return visitor.findings
