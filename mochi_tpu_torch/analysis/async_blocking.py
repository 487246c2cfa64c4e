"""async-blocking: blocking calls inside ``async def`` bodies.

The whole data plane multiplexes on one event loop per process (replica
dispatch, transport framing, the verify batcher).  A single synchronous
stall — ``time.sleep``, unbuffered file IO, a subprocess, a host Ed25519
operation outside the metered fast paths — freezes every connection on that
loop and blows the 1-RT read / 2-RT write latency budget (BASELINE.json:
"<5% replica CPU in crypto" assumes crypto never *blocks* the loop, only
spends cycles on it).

Detection is lexical and conservative: a ``Call`` node whose resolved
dotted target is on the deny list, appearing inside an ``async def`` body —
not inside a nested synchronous ``def`` or ``lambda`` (those are routinely
shipped to ``run_in_executor``, which is exactly the sanctioned escape
hatch and takes *callables*, never call results).
"""

from __future__ import annotations

import ast
from typing import List

from .core import Finding, build_import_map, resolve_call, snippet_at, suffix_match

RULE = "async-blocking"

# Resolved-by-suffix call targets that synchronously block (or monopolize)
# the event loop.  ``time.sleep`` is the classic; the IO entries cover the
# patterns a KV store grows (snapshots, config files, ad-hoc probes); the
# crypto entries are the host Ed25519 primitives — module-level sign/verify
# in a coroutine means an unmetered OpenSSL (or worse, pure-Python fallback)
# operation on the loop.
BLOCKING_CALLS = (
    "time.sleep",
    "os.system",
    "os.popen",
    "os.wait",
    "os.waitpid",
    "subprocess.run",
    "subprocess.call",
    "subprocess.check_call",
    "subprocess.check_output",
    "subprocess.Popen.wait",
    "socket.create_connection",
    "socket.getaddrinfo",
    "urllib.request.urlopen",
    "requests.get",
    "requests.post",
    "requests.put",
    "requests.request",
    "shutil.copyfile",
    "shutil.copytree",
    "shutil.rmtree",
)

CRYPTO_CALLS = (
    "crypto.keys.sign",
    "crypto.keys.verify",
    "keys.sign",
    "keys.verify",
)

# Bare-name builtins that block.  ``open`` alone: ``os.open`` is resolved as
# a dotted call and (being a raw fd syscall) is left to the IO entries above.
BLOCKING_BUILTINS = ("open",)


class _AsyncBodyVisitor(ast.NodeVisitor):
    def __init__(self, imports, src_lines, path):
        self.imports = imports
        self.src_lines = src_lines
        self.path = path
        self.findings: List[Finding] = []
        self._async_depth = 0

    # -- scope management: only direct async bodies count ------------------
    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._async_depth += 1
        for child in node.body:
            self.visit(child)
        self._async_depth -= 1

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        # A nested sync def inside a coroutine is (by idiom) executor fodder
        # or a callback — its body runs off-loop or is someone else's problem.
        saved = self._async_depth
        self._async_depth = 0
        for child in node.body:
            self.visit(child)
        self._async_depth = saved

    def visit_Lambda(self, node: ast.Lambda) -> None:
        saved = self._async_depth
        self._async_depth = 0
        self.visit(node.body)
        self._async_depth = saved

    def visit_Call(self, node: ast.Call) -> None:
        if self._async_depth > 0:
            qualified = resolve_call(node.func, self.imports)
            hit = None
            kind = None
            if qualified is not None:
                if suffix_match(qualified, BLOCKING_CALLS):
                    hit, kind = qualified, "blocking call"
                elif suffix_match(qualified, CRYPTO_CALLS):
                    hit, kind = qualified, "host crypto call"
            if (
                hit is None
                and isinstance(node.func, ast.Name)
                and node.func.id in BLOCKING_BUILTINS
                and node.func.id not in self.imports
            ):
                hit, kind = node.func.id, "blocking builtin"
            if hit is not None:
                self.findings.append(
                    Finding(
                        RULE,
                        self.path,
                        node.lineno,
                        node.col_offset,
                        f"{kind} `{hit}` inside `async def` body blocks the "
                        "event loop; use the async equivalent or "
                        "run_in_executor",
                        snippet_at(self.src_lines, node.lineno),
                    )
                )
        self.generic_visit(node)


def check(tree: ast.Module, src: str, path: str, scoped: bool = True) -> List[Finding]:
    del scoped  # a blocked event loop is a defect anywhere in the tree
    visitor = _AsyncBodyVisitor(build_import_map(tree), src.splitlines(), path)
    visitor.visit(tree)
    return visitor.findings
