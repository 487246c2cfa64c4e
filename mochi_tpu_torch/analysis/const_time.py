"""constant-time: timing-oracle patterns on signature/digest/MAC bytes.

Python's ``bytes.__eq__`` short-circuits at the first differing byte, so a
``==`` on authenticator bytes leaks how long a forged prefix matched — the
classic HMAC timing oracle.  Everywhere an attacker-supplied authenticator
meets a locally computed one, the comparison must be
``hmac.compare_digest`` (``crypto/session.py::mac_ok`` is the exemplar).

Two sub-rules:

* **compare** (whole tree): ``==`` / ``!=`` where an operand's terminal
  identifier names an authenticator (``signature``/``sig``/``mac``/
  ``digest``/``hmac`` or ``*_signature``/``*_sig``/``*_mac``/``*_digest``).
  ALL-CAPS operands are exempt — ``FailType.BAD_SIGNATURE`` is an enum
  constant, not bytes — as are comparisons against ``None`` (identity
  checks are spelled ``is`` anyway, and ``== None`` has no byte content to
  leak).

* **secret-branch** (``crypto/`` files only): a ``return`` inside an ``if``
  whose condition reads a secret-named parameter (``private*``/``secret*``/
  ``*_seed``).  Early exit keyed on secret material is a timing channel in
  the primitive itself; the JAX data plane is branchless by construction
  (``crypto/field.py`` module docstring), and the host fallback must at
  least not *branch* on key bytes even where big-int timing is
  unavoidable.
"""

from __future__ import annotations

import ast
import re
from typing import List, Optional

from .core import Finding, dotted_name, snippet_at

RULE = "constant-time"

_AUTH_NAME = re.compile(
    r"(?:^|_)(signature|sig|mac|digest|hmac)$"
)
_SECRET_PARAM = re.compile(r"(?:^(?:private|secret)|(?:^|_)seed$)")


def _terminal_identifier(node: ast.AST) -> Optional[str]:
    dn = dotted_name(node)
    if dn is None:
        return None
    parts = dn.split(".")
    # Enum/constant access: any ALL-CAPS segment marks the chain constant.
    if any(p.isupper() and len(p) > 1 for p in parts):
        return None
    return parts[-1]


def _is_auth_operand(node: ast.AST) -> bool:
    ident = _terminal_identifier(node)
    return bool(ident) and bool(_AUTH_NAME.search(ident))


def _compare_findings(tree: ast.Module, src_lines, path: str) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Compare):
            continue
        if not any(isinstance(op, (ast.Eq, ast.NotEq)) for op in node.ops):
            continue
        operands = [node.left, *node.comparators]
        if any(
            isinstance(o, ast.Constant) and o.value is None for o in operands
        ):
            continue
        if any(_is_auth_operand(o) for o in operands):
            findings.append(
                Finding(
                    RULE, path, node.lineno, node.col_offset,
                    "variable-time `==` on authenticator bytes; use "
                    "hmac.compare_digest",
                    snippet_at(src_lines, node.lineno),
                )
            )
    return findings


class _SecretBranchVisitor(ast.NodeVisitor):
    def __init__(self, secrets, src_lines, path):
        self.secrets = secrets
        self.src_lines = src_lines
        self.path = path
        self.findings: List[Finding] = []

    def visit_FunctionDef(self, node):  # nested defs analyzed separately
        pass

    def visit_AsyncFunctionDef(self, node):
        pass

    def visit_If(self, node: ast.If) -> None:
        touches_secret = any(
            isinstance(n, ast.Name) and n.id in self.secrets
            for n in ast.walk(node.test)
        )
        if touches_secret:
            for stmt in ast.walk(node):
                if isinstance(stmt, ast.Return):
                    self.findings.append(
                        Finding(
                            RULE, self.path, node.lineno, node.col_offset,
                            "secret-dependent early return; restructure to "
                            "branch-free (select/arith) form",
                            snippet_at(self.src_lines, node.lineno),
                        )
                    )
                    break
        self.generic_visit(node)


def _secret_branch_findings(tree: ast.Module, src_lines, path: str) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        args = node.args
        secrets = {
            a.arg
            for a in args.posonlyargs + args.args + args.kwonlyargs
            if _SECRET_PARAM.search(a.arg)
        }
        if not secrets:
            continue
        visitor = _SecretBranchVisitor(secrets, src_lines, path)
        for stmt in node.body:
            visitor.visit(stmt)
        findings.extend(visitor.findings)
    return findings


def check(tree: ast.Module, src: str, path: str, scoped: bool = True) -> List[Finding]:
    src_lines = src.splitlines()
    findings = _compare_findings(tree, src_lines, path)
    if not scoped or "crypto" in path.split("/"):
        findings.extend(_secret_branch_findings(tree, src_lines, path))
    return findings
