"""cancellation-hygiene: exception handlers that eat task cancellation.

asyncio delivers cancellation by raising ``asyncio.CancelledError`` at the
coroutine's current ``await``.  A handler that catches it and doesn't
re-raise turns ``task.cancel()`` into a no-op: replica ``close()`` hangs on
a worker that "handled" its own cancellation, reconfiguration leaves zombie
resync loops, test teardown deadlocks.  On Python >= 3.8 ``CancelledError``
derives from ``BaseException``, so a plain ``except Exception`` no longer
catches it — but bare ``except:``, ``except BaseException``, and tuples
that *name* ``CancelledError`` next to ``Exception`` still do, and a broad
handler around an ``await`` should make its cancellation story explicit
rather than rely on the reader knowing the 3.8 hierarchy change.

Flags, inside coroutine bodies only and only when the ``try`` body can
actually be cancelled (contains ``await`` / ``async for`` / ``async with``):

1. bare ``except:`` that doesn't re-raise;
2. ``except BaseException`` that doesn't re-raise;
3. a handler naming ``CancelledError`` *in the same tuple as* a broad
   exception class, without re-raise — the "deliberately swallow everything
   including cancellation" anti-pattern;
4. ``except Exception`` without re-raise and with no sibling handler taking
   ``CancelledError`` — fix by adding ``except asyncio.CancelledError:
   raise`` above it (free on >= 3.8, and it states the intent).

A *standalone* ``except asyncio.CancelledError: pass`` is allowed: it is
the canonical idiom for awaiting a task you just ``.cancel()``-ed.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Sequence

from .core import Finding, dotted_name, snippet_at

RULE = "cancellation-hygiene"

_BROAD = {"Exception", "BaseException"}


def _handler_type_names(handler: ast.ExceptHandler) -> List[str]:
    """Terminal identifiers of the caught types ('' list for bare except)."""
    t = handler.type
    if t is None:
        return []
    nodes: Sequence[ast.AST] = t.elts if isinstance(t, ast.Tuple) else [t]
    names = []
    for node in nodes:
        dn = dotted_name(node)
        if dn:
            names.append(dn.split(".")[-1])
    return names


def _reraises(handler: ast.ExceptHandler) -> bool:
    """Any ``raise`` in the handler's own statement tree counts: a bare
    re-raise propagates the cancellation; a typed raise still transfers
    control out.  Raises inside nested function definitions do NOT count —
    ``except BaseException: register(lambda: (_ for _ in ()).throw(x))``
    never raises in the handler itself."""

    class S(ast.NodeVisitor):
        found = False

        def visit_FunctionDef(self, node):
            pass

        def visit_AsyncFunctionDef(self, node):
            pass

        def visit_Lambda(self, node):
            pass

        def visit_Raise(self, node):
            self.found = True

    s = S()
    for stmt in handler.body:
        s.visit(stmt)
    return s.found


class _BodyScanner(ast.NodeVisitor):
    """Find Try/Await/AsyncFor/AsyncWith in ONE function body, without
    descending into nested function definitions."""

    def __init__(self):
        self.tries: List[ast.Try] = []

    def visit_FunctionDef(self, node):  # don't descend
        pass

    def visit_AsyncFunctionDef(self, node):  # visited on its own
        pass

    def visit_Lambda(self, node):
        pass

    def visit_Try(self, node: ast.Try) -> None:
        self.tries.append(node)
        self.generic_visit(node)


def _contains_await(nodes: Sequence[ast.stmt]) -> bool:
    class S(ast.NodeVisitor):
        found = False

        def visit_FunctionDef(self, node):
            pass

        def visit_AsyncFunctionDef(self, node):
            pass

        def visit_Lambda(self, node):
            pass

        def visit_Await(self, node):
            self.found = True

        def visit_AsyncFor(self, node):
            self.found = True
            self.generic_visit(node)

        def visit_AsyncWith(self, node):
            self.found = True
            self.generic_visit(node)

    s = S()
    for n in nodes:
        s.visit(n)
    return s.found


def _check_coroutine(
    func: ast.AsyncFunctionDef, src_lines, path: str
) -> List[Finding]:
    scanner = _BodyScanner()
    for stmt in func.body:
        scanner.visit(stmt)
    findings: List[Finding] = []
    for try_node in scanner.tries:
        if not _contains_await(try_node.body):
            continue  # nothing in this try can raise CancelledError
        sibling_catches_cancel = any(
            "CancelledError" in _handler_type_names(h) for h in try_node.handlers
        )
        for handler in try_node.handlers:
            names = _handler_type_names(handler)
            reraises = _reraises(handler)
            line = handler.lineno
            snippet = snippet_at(src_lines, line)
            if handler.type is None and not reraises:
                findings.append(
                    Finding(
                        RULE, path, line, handler.col_offset,
                        "bare `except:` in coroutine swallows "
                        "asyncio.CancelledError; catch specific exceptions "
                        "or re-raise cancellation",
                        snippet,
                    )
                )
            elif "BaseException" in names and not reraises:
                findings.append(
                    Finding(
                        RULE, path, line, handler.col_offset,
                        "`except BaseException` in coroutine swallows "
                        "asyncio.CancelledError; re-raise it",
                        snippet,
                    )
                )
            elif (
                "CancelledError" in names
                and any(n in _BROAD for n in names)
                and not reraises
            ):
                findings.append(
                    Finding(
                        RULE, path, line, handler.col_offset,
                        "handler catches CancelledError together with a "
                        "broad exception class and never re-raises; split "
                        "the CancelledError case out explicitly",
                        snippet,
                    )
                )
            elif (
                names == ["Exception"]
                and not reraises
                and not sibling_catches_cancel
            ):
                findings.append(
                    Finding(
                        RULE, path, line, handler.col_offset,
                        "broad `except Exception` around an await with no "
                        "explicit cancellation handling; add `except "
                        "asyncio.CancelledError: raise` above it",
                        snippet,
                    )
                )
    return findings


def check(tree: ast.Module, src: str, path: str, scoped: bool = True) -> List[Finding]:
    del scoped  # swallowed cancellation is a defect anywhere in the tree
    src_lines = src.splitlines()
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.AsyncFunctionDef):
            findings.extend(_check_coroutine(node, src_lines, path))
    return findings
