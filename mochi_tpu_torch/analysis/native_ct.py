"""native-const-time: secret-dependent control flow across the C seam.

The ``constant-time`` AST rule stops at the Python boundary, but since the
native host engine landed (``native/hbatch.c``: SHA-512, GF(2^255-19),
Straus verify, RFC 8032 sign) the most timing-sensitive code in the tree is
C.  The engine's own discipline is documented at ``ge_mul_base`` ("64
unconditional additions, NO zero-digit skip — the signing scalars are
SECRET"); this pass makes that discipline checkable instead of a comment.

This is a LEXER pass, not a parser: C functions are found by brace
matching, comments/strings are blanked (line structure preserved), and two
patterns are flagged inside functions that handle secrets:

* **secret branch** (severity ``high``) — an ``if``/``while``/``switch``
  condition, or a ``for`` loop's condition clause, whose expression
  contains a secret identifier.  A branch taken per secret bit/nibble is
  the exact channel the zero-digit-skip comment forbids.

* **secret index** (``advice``) — an array subscript whose INDEX
  expression contains a secret identifier (``TAB[d]`` with ``d`` derived
  from key nibbles).  A cache-timing channel, weaker than a branch;
  the comb tables here are small and hot, so known-good sites carry a
  reviewed suppression rather than a restructure.

What counts as secret: parameters/locals matching ``secret``/``priv``/
``nonce``/``seed``/``*_scalar``, any name listed in a
``/* mochi-ct: secret(a, r) */`` annotation within three lines above the
function header, plus ONE level of local taint (``d = ...k...`` makes
``d`` secret when ``k`` is).  The verify path's digit loops (``ns``/
``nh`` from the PUBLIC signature/challenge bytes) stay clean by
construction — that contrast is pinned as the checker's fixture.

Scoped to ``native/`` (the rest of the tree has no C).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Set, Tuple

from .core import Finding

RULE = "native-const-time"
LANG = "c"

_SECRET_NAME = re.compile(r"(?:^|_)(?:secret|priv|private|nonce|seed)|_scalar$")
_ANNOTATION = re.compile(r"mochi-ct:\s*secret\(([^)]*)\)")
_IDENT = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")
# `type name(args) {` at top level.  The return-type class admits newlines
# so the GNU/kernel two-line style (`static void\nname(...)`) still scans —
# a C statement ends in `;`/`)` (excluded), so the match cannot leak across
# statements, and the trailing `{` requirement in _find_functions rejects
# calls and prototypes either way.
_FUNC_HEADER = re.compile(
    r"(?:^|\n)(?:static\s+)?[A-Za-z_][A-Za-z0-9_ *\n]*?\b([A-Za-z_][A-Za-z0-9_]*)\s*\(",
)
_C_KEYWORDS = {
    "if", "for", "while", "switch", "return", "sizeof", "int", "char",
    "void", "const", "static", "uint8_t", "uint64_t", "unsigned", "goto",
    "else", "do", "break", "continue", "case", "default", "struct",
}


def _blank_comments_and_strings(src: str) -> str:
    """Replace comment/string interiors with spaces, preserving newlines so
    every offset keeps its line number."""
    out = list(src)
    i, n = 0, len(src)
    while i < n:
        c = src[i]
        if c == "/" and i + 1 < n and src[i + 1] == "*":
            j = src.find("*/", i + 2)
            j = n if j == -1 else j + 2
            for k in range(i, j):
                if out[k] != "\n":
                    out[k] = " "
            i = j
        elif c == "/" and i + 1 < n and src[i + 1] == "/":
            j = src.find("\n", i)
            j = n if j == -1 else j
            for k in range(i, j):
                out[k] = " "
            i = j
        elif c in "\"'":
            quote = c
            j = i + 1
            while j < n and src[j] != quote:
                j = j + 2 if src[j] == "\\" else j + 1
            j = min(j + 1, n)
            for k in range(i + 1, j - 1):
                if out[k] != "\n":
                    out[k] = " "
            i = j
        else:
            i += 1
    return "".join(out)


def _line_of(src: str, offset: int) -> int:
    return src.count("\n", 0, offset) + 1


def _find_functions(clean: str) -> List[Tuple[str, int, int, int]]:
    """(name, header_offset, body_start, body_end) for every brace-matched
    top-level function body."""
    out: List[Tuple[str, int, int, int]] = []
    for m in _FUNC_HEADER.finditer(clean):
        name = m.group(1)
        if name in _C_KEYWORDS:
            continue
        # find the parameter list's closing paren, then require `{`
        depth = 0
        i = m.end() - 1
        while i < len(clean):
            if clean[i] == "(":
                depth += 1
            elif clean[i] == ")":
                depth -= 1
                if depth == 0:
                    break
            i += 1
        j = i + 1
        while j < len(clean) and clean[j] in " \t\n":
            j += 1
        if j >= len(clean) or clean[j] != "{":
            continue  # prototype / macro call
        depth = 0
        k = j
        while k < len(clean):
            if clean[k] == "{":
                depth += 1
            elif clean[k] == "}":
                depth -= 1
                if depth == 0:
                    break
            k += 1
        out.append((name, m.start(1), j + 1, k))
    return out


def _secret_names(
    src: str, clean: str, header_off: int, body: str
) -> Set[str]:
    """Secret identifiers for one function: name-pattern matches among the
    parameter list + declared locals, ``mochi-ct: secret(...)`` annotations
    above the header, and one level of assignment taint."""
    secrets: Set[str] = set()
    # annotation within 3 raw-source lines above the header
    header_line = _line_of(clean, header_off)
    raw_lines = src.splitlines()
    for ln in range(max(0, header_line - 4), header_line):
        m = _ANNOTATION.search(raw_lines[ln]) if ln < len(raw_lines) else None
        if m:
            secrets.update(
                n.strip() for n in m.group(1).split(",") if n.strip()
            )
    # parameter list
    paren = clean.index("(", header_off)
    depth, i = 0, paren
    while i < len(clean):
        if clean[i] == "(":
            depth += 1
        elif clean[i] == ")":
            depth -= 1
            if depth == 0:
                break
        i += 1
    for ident in _IDENT.findall(clean[paren : i + 1]):
        if ident not in _C_KEYWORDS and _SECRET_NAME.search(ident):
            secrets.add(ident)
    # pattern-named locals + one level of taint.  Compound assignments
    # (|= ^= += &= -= *= /= %= <<= >>=) taint too — accumulate-into-`d`
    # is THE dominant constant-time C idiom, and missing it silently
    # un-flags the secret branch on the accumulator.  `==`/`<=`/`>=`/`!=`
    # cannot match: the operator class excludes bare < > ! and the RHS
    # must not start with `=`.
    for _ in range(2):  # second pass lets taint chain one extra hop
        for m in re.finditer(
            r"([A-Za-z_][A-Za-z0-9_]*)\s*(?:\[[^\]]*\])?\s*"
            r"(?:<<|>>|[|^&+\-*/%])?=([^=][^;]*);",
            body,
        ):
            lhs, rhs = m.group(1), m.group(2)
            if lhs in _C_KEYWORDS:
                continue
            if _SECRET_NAME.search(lhs):
                secrets.add(lhs)
                continue
            rhs_ids = set(_IDENT.findall(rhs))
            if rhs_ids & secrets:
                secrets.add(lhs)
    return secrets


def _branch_spans(body: str) -> List[Tuple[int, str, str]]:
    """(offset, kind, condition_text) for if/while/switch conditions and
    the middle clause of for(;;) loops."""
    out: List[Tuple[int, str, str]] = []
    for m in re.finditer(r"\b(if|while|switch|for)\s*\(", body):
        kind = m.group(1)
        depth, i = 0, m.end() - 1
        while i < len(body):
            if body[i] == "(":
                depth += 1
            elif body[i] == ")":
                depth -= 1
                if depth == 0:
                    break
            i += 1
        inner = body[m.end() : i]
        if kind == "for":
            parts = inner.split(";")
            inner = parts[1] if len(parts) >= 2 else ""
        out.append((m.start(), kind, inner))
    return out


def check(tree, src: str, path: str, scoped: bool = True) -> List[Finding]:
    del tree  # lexical pass; no AST for C
    if scoped and "native" not in path.split("/"):
        return []
    clean = _blank_comments_and_strings(src)
    src_lines = src.splitlines()
    findings: List[Finding] = []
    for name, header_off, body_start, body_end in _find_functions(clean):
        body = clean[body_start:body_end]
        secrets = _secret_names(src, clean, header_off, body)
        if not secrets:
            continue
        for off, kind, cond in _branch_spans(body):
            cond_ids = set(_IDENT.findall(cond))
            hit = sorted(cond_ids & secrets)
            if hit:
                line = _line_of(clean, body_start + off)
                findings.append(
                    Finding(
                        RULE, path, line, 0,
                        f"[secret-branch] `{kind}` in {name}() branches on "
                        f"secret value(s) {', '.join(hit)}: per-secret-bit "
                        "control flow is a timing channel — restructure "
                        "branch-free (ge_mul_base's unconditional-add comb "
                        "is the exemplar)",
                        src_lines[line - 1].strip() if line <= len(src_lines) else "",
                        severity="high",
                    )
                )
        # secret-dependent indexing: IDENT [ ... ][ ... ] — EVERY subscript
        # in a chained lookup is inspected (a secret in a leading dimension
        # is the same cache-line channel as one in the last)
        for m in re.finditer(r"[A-Za-z_][A-Za-z0-9_]*((?:\[[^\[\]]+\])+)", body):
            idx_ids: Set[str] = set()
            for idx in re.findall(r"\[([^\[\]]+)\]", m.group(1)):
                idx_ids.update(_IDENT.findall(idx))
            hit = sorted(idx_ids & secrets)
            if hit:
                line = _line_of(clean, body_start + m.start())
                findings.append(
                    Finding(
                        RULE, path, line, 0,
                        f"[secret-index] table lookup in {name}() indexed by "
                        f"secret-derived value(s) {', '.join(hit)}: a "
                        "cache-timing channel — mask-select across the table "
                        "or carry a reviewed suppression for small hot tables",
                        src_lines[line - 1].strip() if line <= len(src_lines) else "",
                        severity="advice",
                    )
                )
    # dedupe identical (line, message) pairs (regex passes can overlap)
    seen = set()
    unique: List[Finding] = []
    for f in findings:
        key = (f.line, f.message)
        if key not in seen:
            seen.add(key)
            unique.append(f)
    return unique
