"""protocol-invariants: structural rules the protocol layer depends on.

Two rules:

* **payload registration** — every message dataclass (``*ToServer`` /
  ``*FromServer``) defined in a module that also defines the
  ``_PAYLOAD_TYPES`` wire-tag tuple must appear in that tuple.  A class
  left out still type-checks, still constructs, and then dies at the first
  ``encode_envelope`` with a ``KeyError`` — at runtime, on a replica, under
  traffic.  Wire tags are positional, so registration is also where
  append-only tag stability is enforced; the checker makes "you added a
  message and forgot the tuple" a lint failure instead of an outage.

* **quorum literal** — arithmetic of the shape ``2 * f + 1`` (in either
  operand order) anywhere outside ``cluster/config.py``.  The quorum
  formula lives in exactly one place (``ClusterConfig.quorum``) because the
  reference got it wrong twice (``ClusterConfiguration.java:260-267``
  overstates f; the strict ``>`` in quorum checks, SURVEY.md §2.6) — an
  inline re-derivation is where the next divergence starts.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set

from .core import Finding, snippet_at

RULE = "protocol-invariants"

_MESSAGE_SUFFIXES = ("ToServer", "FromServer")
_REGISTRY_NAME = "_PAYLOAD_TYPES"


def _registry_names(tree: ast.Module) -> Optional[Set[str]]:
    """Names listed in the module's ``_PAYLOAD_TYPES`` tuple, or None if the
    module defines no such registry (rule does not apply there)."""
    for node in tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
            value = node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
            value = node.value
        else:
            continue
        for target in targets:
            if isinstance(target, ast.Name) and target.id == _REGISTRY_NAME:
                names: Set[str] = set()
                if isinstance(value, (ast.Tuple, ast.List)):
                    for elt in value.elts:
                        if isinstance(elt, ast.Name):
                            names.add(elt.id)
                return names
    return None


def _registration_findings(tree: ast.Module, src_lines, path: str) -> List[Finding]:
    registered = _registry_names(tree)
    if registered is None:
        return []
    findings: List[Finding] = []
    for node in tree.body:
        if not isinstance(node, ast.ClassDef):
            continue
        if not node.name.endswith(_MESSAGE_SUFFIXES):
            continue
        if node.name not in registered:
            findings.append(
                Finding(
                    RULE, path, node.lineno, node.col_offset,
                    f"message class `{node.name}` is not registered in "
                    f"{_REGISTRY_NAME}; it cannot ride an envelope "
                    "(append it — wire tags are positional)",
                    snippet_at(src_lines, node.lineno),
                )
            )
    return findings


def _is_two(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and node.value == 2


def _is_one(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and node.value == 1


def _is_f_ref(node: ast.AST) -> bool:
    if isinstance(node, ast.Name):
        return node.id == "f"
    if isinstance(node, ast.Attribute):
        return node.attr == "f"
    return False


def _is_two_f(node: ast.AST) -> bool:
    return (
        isinstance(node, ast.BinOp)
        and isinstance(node.op, ast.Mult)
        and (
            (_is_two(node.left) and _is_f_ref(node.right))
            or (_is_two(node.right) and _is_f_ref(node.left))
        )
    )


def _quorum_findings(tree: ast.Module, src_lines, path: str) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add)):
            continue
        if (_is_two_f(node.left) and _is_one(node.right)) or (
            _is_two_f(node.right) and _is_one(node.left)
        ):
            findings.append(
                Finding(
                    RULE, path, node.lineno, node.col_offset,
                    "inline quorum arithmetic `2*f + 1`; use "
                    "ClusterConfig.quorum (single source of BFT math)",
                    snippet_at(src_lines, node.lineno),
                )
            )
    return findings


def check(tree: ast.Module, src: str, path: str, scoped: bool = True) -> List[Finding]:
    src_lines = src.splitlines()
    findings = _registration_findings(tree, src_lines, path)
    if not scoped or not path.endswith("cluster/config.py"):
        findings.extend(_quorum_findings(tree, src_lines, path))
    return findings
