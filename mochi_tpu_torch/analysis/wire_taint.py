"""wire-taint: every protocol decision must be anchored to verified bytes.

The system commits to DSig-style fast paths (session-MAC shortcuts,
aggregated certificate attestations, speculative verify-behind-commit) that
deliberately remove per-message signature checks from the hot path.  The
protocol's safety argument is exactly "nothing unverified reaches a quorum
decision" — so before verification is carved out of the critical path, that
property must be machine-checked, not conventional.

This pass is an interprocedural taint analysis over the scanned tree:

* **Sources** — values born at a wire or disk seam are TAINTED: envelope
  decode (``codec.decode_env`` / ``messages.decode_envelope``), transport
  deliveries (``send_and_receive`` / ``fan_out`` responses), WAL records
  read at recovery (``wal.iter_log`` / ``scan_segment``), snapshot docs
  (``read_snapshot_doc``), and generic wire-object decode (``from_obj``).
  Replica batch entry points (``handle_batch`` & friends) are **entry**
  edges: their parameters arrive straight off the transport and start
  tainted too (the transport hands them over via dynamic callbacks the
  call graph cannot see).

* **Sanitizers** — sanctioned verifier edges confer verification *classes*
  on everything derived from the value they checked: the envelope MAC /
  Ed25519 check (``env``), grant/certificate signature verification
  (``cert``), the admin-key gate (``admin``), and WAL reclaim-record
  authentication (``wal``).  The pooled ``verify_batch`` bitmap engine
  confers ``env``+``cert`` (it carries both item kinds in one round trip).

* **Sinks** — protocol-decision points declare which classes must have
  been conferred (CNF: a tuple of any-of groups): store
  ``process_write1/write2`` apply, sync-entry adoption, config install,
  quorum tally acceptance, certificate-subset assembly, grant-ledger /
  ban-book / reclaimed-ledger writes, client eviction.

A tainted value reaching a sink with a required class missing is a finding
— including *across function boundaries*: per-function summaries record
which parameters flow to which sinks unverified, which classes a callee
confers on its arguments, and whether a return value is wire-tainted; a
bounded fixpoint propagates them over the (best-effort) call graph, so the
conviction lands at the call site where the unverified value actually
crossed into the decision path.

Precision posture (documented in docs/ANALYSIS.md): statement walks are
linear (a verifier call dominates everything textually after it — same
approximation as the await-races pass), derivation is root-coarse (checking
``env.signing_bytes()`` vindicates everything reached through ``env``), and
values assembled from several roots take the UNION of their roots' conferred
classes (sinks re-check structural binding — txn-hash match, quorum count —
internally).  Each choice trades soundness-in-the-limit for a clean,
actionable pass; the non-vacuity fixtures in tests/ prove every sanctioned
edge is still load-bearing (deleting it convicts the downstream sink).

Fast paths MUST register their new verifier edges here (see
:func:`register_verifier_edge`) instead of silently bypassing the lattice;
``expect_live`` edges double as harness-rot tripwires — a full-tree scan
that no longer observes a sanctioned edge at any call site reports
``registry-rot`` (the edge was renamed/bypassed without updating the
registry, exactly the drift the fast-path work could introduce).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from .core import Finding, build_import_map, resolve_call, suffix_match

RULE = "wire-taint"

# Verification classes (the lattice's labels).  ``env`` = envelope
# authenticity (MAC or Ed25519 over the signed prefix); ``cert`` =
# grant/certificate signature + 2f+1 subset machinery; ``admin`` = admin-key
# signature; ``wal`` = WAL record authentication at recovery.
CLS_ENV = "env"
CLS_CERT = "cert"
CLS_ADMIN = "admin"
CLS_WAL = "wal"


@dataclass(frozen=True)
class Edge:
    """One declarative registry entry.

    ``kind``: "source" | "sanitizer" | "sink" | "entry".
    ``pattern``: dotted-suffix call pattern ("codec.decode_env",
    "_grant_ok"); for ``match="attr-store"`` sinks, the attribute name whose
    subscript/attribute assignment is the decision ("reclaimed").
    ``confers``: classes a sanitizer confers on its arguments' roots.
    ``requires``: sink CNF — every group must intersect the conferred set.
    ``expect_live``: full-tree scans must observe this edge at >= 1 site,
    else ``registry-rot`` fires (see module docstring).
    """

    name: str
    kind: str
    pattern: str
    confers: FrozenSet[str] = frozenset()
    requires: Tuple[FrozenSet[str], ...] = ()
    match: str = "call"
    note: str = ""
    expect_live: bool = False


def _grp(*alternatives: str) -> FrozenSet[str]:
    return frozenset(alternatives)


BUILTIN_EDGES: Tuple[Edge, ...] = (
    # ------------------------------------------------------------- sources
    Edge("env-decode", "source", "codec.decode_env",
         note="wire bytes -> Envelope (mcode codec)", expect_live=True),
    Edge("env-decode-fn", "source", "decode_env"),
    Edge("envelope-decode", "source", "decode_envelope"),
    Edge("wire-obj-decode", "source", "from_obj",
         note="wire/WAL object graph -> typed message"),
    Edge("wal-scan", "source", "scan_segment",
         note="CRC-framed WAL records (CRC is torn-tail detection, not "
              "authentication)", expect_live=True),
    Edge("wal-iter", "source", "iter_log"),
    Edge("snapshot-read", "source", "read_snapshot_doc"),
    Edge("rpc-response", "source", "send_and_receive",
         note="peer/server response envelope", expect_live=True),
    Edge("rpc-fanout", "source", "fan_out",
         note="fan-out response map (client quorum paths)"),
    # ------------------------------------------------------- entry points
    Edge("replica-batch-entry", "entry", "handle_batch",
         note="transport hands decoded envelopes in via callback"),
    Edge("replica-inline-entry", "entry", "handle_inline_batch"),
    Edge("replica-envelope-entry", "entry", "handle_envelope"),
    # ---------------------------------------------------------- sanitizers
    Edge("session-mac", "sanitizer", "_auth_mac", confers=_grp(CLS_ENV),
         note="replica session-MAC envelope check", expect_live=True),
    Edge("session-mac-fn", "sanitizer", "mac_ok", confers=_grp(CLS_ENV),
         note="session_crypto.mac_ok (MAC-session fast path registers "
              "through this edge)"),
    Edge("client-envelope-auth", "sanitizer", "_authentic",
         confers=_grp(CLS_ENV), note="client-side response MAC/signature "
         "gate", expect_live=True),
    Edge("server-signature", "sanitizer", "_server_signed",
         confers=_grp(CLS_ENV)),
    Edge("admin-signature", "sanitizer", "_admin_sig_ok",
         confers=_grp(CLS_ENV, CLS_ADMIN)),
    Edge("ed25519-verify", "sanitizer", "cpu_verify",
         confers=_grp(CLS_ENV, CLS_CERT),
         note="raw Ed25519 verify (host fallback)"),
    Edge("ed25519-verify-keys", "sanitizer", "keys.verify",
         confers=_grp(CLS_ENV, CLS_CERT)),
    Edge("batch-verify", "sanitizer", "verify_batch",
         confers=_grp(CLS_ENV, CLS_CERT),
         note="pooled bitmap engine: envelope + grant items share the "
              "round trip", expect_live=True),
    Edge("grant-verify", "sanitizer", "_grant_ok", confers=_grp(CLS_CERT),
         note="client per-grant Ed25519 + txn-hash content check",
         expect_live=True),
    Edge("certificate-finish", "sanitizer", "_finish_certificate",
         confers=_grp(CLS_CERT),
         note="bitmap consumption: drops unproven grants, re-checks "
              "quorum", expect_live=True),
    Edge("certificate-recheck", "sanitizer", "_check_certificate",
         confers=_grp(CLS_CERT),
         note="resync/anti-entropy certificate re-verification",
         expect_live=True),
    Edge("wal-reclaim-auth", "sanitizer", "_reclaim_auth_ok",
         confers=_grp(CLS_WAL),
         note="reclaim-record MAC re-verification at recovery",
         expect_live=True),
    # --------------------------------------------------------------- sinks
    Edge("write1-apply", "sink", "process_write1",
         requires=(_grp(CLS_ENV, CLS_ADMIN),)),
    Edge("write1-batch-apply", "sink", "process_write1_batch",
         requires=(_grp(CLS_ENV, CLS_ADMIN),), expect_live=True),
    Edge("write2-apply", "sink", "process_write2",
         requires=(_grp(CLS_ENV, CLS_ADMIN), _grp(CLS_CERT))),
    Edge("write2-batch-apply", "sink", "process_write2_batch",
         requires=(_grp(CLS_ENV, CLS_ADMIN), _grp(CLS_CERT)),
         expect_live=True),
    Edge("read-apply", "sink", "process_read",
         requires=(_grp(CLS_ENV, CLS_ADMIN),)),
    Edge("sync-adopt", "sink", "apply_sync_entry",
         requires=(_grp(CLS_CERT),),
         note="resync/recovery adoption: certificate-anchored, envelope "
              "auth deliberately not required (certs are self-certifying)",
         expect_live=True),
    Edge("config-install", "sink", "_install_config",
         requires=(_grp(CLS_CERT),)),
    Edge("write2-tally", "sink", "_tally_write2",
         requires=(_grp(CLS_ENV),),
         note="client commit acceptance: only authenticated responses may "
              "vote"),
    Edge("grant-subset", "sink", "_quorum_grant_subset",
         requires=(_grp(CLS_ENV), _grp(CLS_CERT)),
         note="certificate assembly: grants must be envelope-authenticated "
              "AND signature/content-checked before they vote"),
    Edge("client-evict", "sink", "evict_client",
         requires=(_grp(CLS_ENV, CLS_ADMIN, CLS_CERT),)),
    Edge("admission", "sink", "admit",
         requires=(_grp(CLS_ENV, CLS_ADMIN),),
         note="admission decisions may key on sizes/counts (len() is "
              "clean) but never on unverified payload content"),
    Edge("reclaimed-ledger", "sink", "reclaimed", match="attr-store",
         requires=(_grp(CLS_WAL),),
         note="InvariantChecker audit ledger: direct writes only happen at "
              "WAL replay and need authenticated reclaim records "
              "(operational reclaims route through the process_write2 sink, "
              "which shields its internals and demands env+cert itself)"),
    Edge("ban-book", "sink", "_client_bans", match="attr-store",
         requires=(_grp(CLS_ENV, CLS_ADMIN, CLS_CERT),)),
    Edge("grant-ledger", "sink", "_grant_ledger", match="attr-store",
         requires=(_grp(CLS_CERT),),
         note="equivocation evidence: only validly-signed grants may enter"),
    Edge("config-adopt", "sink", "config", match="attr-store",
         requires=(_grp(CLS_ENV, CLS_CERT, CLS_ADMIN),),
         note="cluster-config adoption from a wire value"),
)

# Fast-path edges registered at runtime (MAC-session,
# aggregated-attestation).  Additive only — the builtin lattice cannot be
# weakened from here.
_RUNTIME_EDGES: List[Edge] = []


def register_verifier_edge(
    name: str,
    pattern: str,
    confers: Sequence[str],
    note: str = "",
    expect_live: bool = False,
) -> Edge:
    """Register a new sanctioned verifier edge (a fast path's check).

    The fast-path contract: removing per-message verification is only
    legitimate if its replacement check is registered here, so the lattice
    knows the new edge confers verification — otherwise every decision
    downstream of the fast path becomes a finding (by design)."""
    edge = Edge(name, "sanitizer", pattern, confers=frozenset(confers),
                note=note, expect_live=expect_live)
    _RUNTIME_EDGES.append(edge)
    return edge


def register_edge(edge: Edge) -> Edge:
    """Register a full edge (source/sink/entry included) — the general
    form of :func:`register_verifier_edge` for new seams and decisions."""
    _RUNTIME_EDGES.append(edge)
    return edge


# Modules that register runtime edges at import time.  The analysis runs
# in whatever process invoked it (CLI, bench preflight, tests) — without
# loading these, a fast-path module's registered edges would be invisible
# to any scan that didn't happen to import the module first, and its
# sanctioned sanitizer would read as an unregistered check (a false
# finding) or, worse, its expect_live pin would silently not apply.
_EDGE_PROVIDERS = (
    "mochi_tpu_torch.storage.paged", "mochi_tpu_torch.server.replica",
)
_providers_loaded = False


def _load_edge_providers() -> None:
    global _providers_loaded
    if _providers_loaded:
        return
    _providers_loaded = True
    import importlib

    for mod in _EDGE_PROVIDERS:
        importlib.import_module(mod)


def registered_edges() -> Tuple[Edge, ...]:
    _load_edge_providers()
    return BUILTIN_EDGES + tuple(_RUNTIME_EDGES)


def _edges_by_kind() -> Dict[str, List[Edge]]:
    out: Dict[str, List[Edge]] = {"source": [], "sanitizer": [], "sink": [],
                                  "entry": []}
    for e in registered_edges():
        out.setdefault(e.kind, []).append(e)
    return out


# Calls whose result carries no taint even from tainted arguments: sizes,
# type predicates, identifiers.  Admission control legitimately sheds on
# len(batch) BEFORE auth — a size is not payload content.
_CLEAN_CALLS = {
    "len", "bool", "int", "float", "str", "repr", "hash", "id", "ord",
    "isinstance", "issubclass", "hasattr", "callable", "type", "range",
    "time.time", "time.monotonic", "time.perf_counter", "new_msg_id",
}

# Mutating container methods: taint flows from argument into the receiver.
_MUTATORS = {"append", "add", "extend", "insert", "update", "setdefault",
             "appendleft", "push"}

# --------------------------------------------------------------- extraction
#
# The per-file phase lowers every function to a picklable, registry-
# independent event IR (so analysis/core.py can cache it per file by mtime):
#
#   fn record: {module, path, cls, name, qual, params, line, events,
#               local_funcs}
#   event:  ("assign", targets, expr) | ("expr", expr) | ("ret", expr)
#   target: ("n", name) | ("store", attr_name, line, col, snippet)
#   expr:   ("name", id) | ("many", (expr, ...))
#         | ("call", dotted, (arg_exprs...), base_name, line, col, snippet)
#
# Control flow is linearized (if/else, loops, try arms concatenated in
# source order) — the same dominance-by-text-order approximation the
# await-races pass uses, which matches how verification code is actually
# written (check first, decide after).


def _module_name(path: str) -> str:
    p = path[:-3] if path.endswith(".py") else path
    return p.replace("/", ".")


class _ExprLower:
    def __init__(self, imports: Dict[str, str], src_lines: Sequence[str]):
        self.imports = imports
        self.src_lines = src_lines

    def snippet(self, node: ast.AST) -> str:
        line = getattr(node, "lineno", 0)
        if 1 <= line <= len(self.src_lines):
            return self.src_lines[line - 1].strip()
        return ""

    def lower(self, node: Optional[ast.AST]):
        if node is None or isinstance(node, ast.Constant):
            return None
        if isinstance(node, ast.Name):
            return ("name", node.id)
        if isinstance(node, ast.Await):
            return self.lower(node.value)
        if isinstance(node, ast.Call):
            dotted = resolve_call(node.func, self.imports)
            base = None
            recv = None
            if isinstance(node.func, ast.Attribute):
                # a method call reads its receiver: `results.items()` /
                # `rec.decode()` carry the receiver's taint into the result
                recv = self.lower(node.func.value)
                if isinstance(node.func.value, ast.Name):
                    base = node.func.value.id
            args = []
            for a in node.args:
                args.append(self.lower(a.value if isinstance(a, ast.Starred)
                                       else a))
            for kw in node.keywords:
                args.append(self.lower(kw.value))
            return (
                "call", dotted, tuple(args), base,
                node.lineno, node.col_offset, self.snippet(node), recv,
            )
        if isinstance(node, (ast.Attribute, ast.Subscript, ast.Starred)):
            # derivation is root-coarse: attribute/subscript access keeps
            # the base's roots (plus any index expression's)
            parts = [self.lower(node.value)]
            if isinstance(node, ast.Subscript):
                parts.append(self.lower(node.slice))
            return self._many(parts)
        if isinstance(node, ast.Lambda):
            # evaluate the body at the definition site: `run_in_executor(
            # None, lambda: list(iter_log(...)))` returns the body's value,
            # and a deferred wire read is still a wire read.  The lambda's
            # own params stay unbound (they carry the *caller's* data).
            return self.lower(node.body)
        # generic: union over child expressions (tuples, dicts, binops,
        # comparisons, comprehensions, f-strings, conditionals, ...)
        parts = [self.lower(c) for c in ast.iter_child_nodes(node)
                 if isinstance(c, ast.expr)]
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                             ast.GeneratorExp)):
            parts = [self.lower(node.elt) if hasattr(node, "elt") else None]
            if isinstance(node, ast.DictComp):
                parts = [self.lower(node.key), self.lower(node.value)]
            for gen in node.generators:
                parts.append(self.lower(gen.iter))
                for cond in gen.ifs:
                    parts.append(self.lower(cond))
        return self._many(parts)

    @staticmethod
    def _many(parts):
        flat = tuple(p for p in parts if p is not None)
        if not flat:
            return None
        if len(flat) == 1:
            return flat[0]
        return ("many", flat)

    def lower_target(self, node: ast.AST):
        """Assignment targets: plain names bind roots; attribute /
        subscript stores surface as ("store", attr) events the attr-store
        sinks match on."""
        out: List = []
        if isinstance(node, ast.Name):
            out.append(("n", node.id))
        elif isinstance(node, (ast.Tuple, ast.List)):
            for elt in node.elts:
                out.extend(self.lower_target(elt))
        elif isinstance(node, ast.Starred):
            out.extend(self.lower_target(node.value))
        elif isinstance(node, ast.Attribute):
            out.append(("store", node.attr, node.lineno, node.col_offset,
                        self.snippet(node)))
        elif isinstance(node, ast.Subscript):
            if isinstance(node.value, ast.Attribute):
                out.append(("store", node.value.attr, node.lineno,
                            node.col_offset, self.snippet(node)))
            elif isinstance(node.value, ast.Name):
                # d[k] = v on a local: taint flows into the local
                out.append(("n", node.value.id))
        return out


class _FnLower:
    def __init__(self, lower: _ExprLower):
        self.lower = lower
        self.events: List = []
        self.nested: List = []  # defs buried in loops/with/try arms

    def stmt(self, node: ast.stmt) -> None:
        lw = self.lower
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self.nested.append(node)
            return  # extracted as a separate function by the caller
        if isinstance(node, ast.ClassDef):
            return
        if isinstance(node, ast.Assign):
            targets: List = []
            for t in node.targets:
                targets.extend(lw.lower_target(t))
            self.events.append(("assign", tuple(targets),
                                lw.lower(node.value)))
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = tuple(lw.lower_target(node.target))
            value = lw.lower(node.value) if node.value is not None else None
            if isinstance(node, ast.AugAssign):
                # x += y keeps x's roots and gains y's
                value = lw._many([value, lw.lower(node.target)])
            self.events.append(("assign", targets, value))
        elif isinstance(node, ast.Return):
            self.events.append(("ret", lw.lower(node.value)))
        elif isinstance(node, ast.Expr):
            self.events.append(("expr", lw.lower(node.value)))
        elif isinstance(node, (ast.If, ast.While)):
            self.events.append(("expr", lw.lower(node.test)))
            for child in node.body:
                self.stmt(child)
            for child in node.orelse:
                self.stmt(child)
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            self.events.append(
                ("assign", tuple(lw.lower_target(node.target)),
                 lw.lower(node.iter))
            )
            for child in node.body:
                self.stmt(child)
            for child in node.orelse:
                self.stmt(child)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                value = lw.lower(item.context_expr)
                if item.optional_vars is not None:
                    self.events.append(
                        ("assign", tuple(lw.lower_target(item.optional_vars)),
                         value)
                    )
                else:
                    self.events.append(("expr", value))
            for child in node.body:
                self.stmt(child)
        elif isinstance(node, ast.Try):
            for child in node.body:
                self.stmt(child)
            for handler in node.handlers:
                for child in handler.body:
                    self.stmt(child)
            for child in node.orelse:
                self.stmt(child)
            for child in node.finalbody:
                self.stmt(child)
        elif isinstance(node, (ast.Raise, ast.Assert)):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.expr):
                    self.events.append(("expr", lw.lower(child)))
        elif isinstance(node, ast.Match):
            self.events.append(("expr", lw.lower(node.subject)))
            for case in node.cases:
                for child in case.body:
                    self.stmt(child)
        # Pass/Import/Global/Nonlocal/Delete/Break/Continue: no dataflow


# Production packages the pass scopes to: the layers where wire bytes meet
# protocol decisions.  testing/ (byzantine harnesses bypass verification BY
# DESIGN), tools/, obs/, utils/, parallel/, native/ and the analysis
# package itself are out of scope.
_SCOPE_PREFIXES = (
    "mochi_tpu_torch/client/", "mochi_tpu_torch/server/",
    "mochi_tpu_torch/storage/", "mochi_tpu_torch/protocol/",
    "mochi_tpu_torch/net/", "mochi_tpu_torch/crypto/",
    "mochi_tpu_torch/cluster/", "mochi_tpu_torch/verifier/",
    "mochi_tpu_torch/netsim/", "mochi_tpu_torch/admin/",
)

# Full-tree anchor: registry-rot (expect_live) is only judged when the scan
# covered the replica — a single-file or fixture scan proves nothing about
# which edges are live.
_ANCHOR_PATH = "mochi_tpu_torch/server/replica.py"


def in_scope(path: str, scoped: bool = True) -> bool:
    if not scoped:
        return True
    return any(path.startswith(p) or p.rstrip("/") + ".py" == path
               for p in _SCOPE_PREFIXES)


def extract(tree: ast.Module, src: str, path: str, scoped: bool = True):
    """Per-file phase: lower every function to the event IR.  Registry-
    independent and picklable — analysis/core.py caches it per file."""
    if not in_scope(path, scoped):
        return None
    imports = build_import_map(tree)
    src_lines = src.splitlines()
    lower = _ExprLower(imports, src_lines)
    module = _module_name(path)
    functions: List[Dict] = []
    classes: List[Dict] = []

    def visit_fn(node, cls_name: Optional[str], prefix: str) -> None:
        qual = f"{prefix}{node.name}"
        params = [a.arg for a in (
            node.args.posonlyargs + node.args.args + node.args.kwonlyargs
        )]
        fl = _FnLower(lower)
        local_funcs: Dict[str, str] = {}
        for child in node.body:
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                local_funcs[child.name] = f"{qual}.{child.name}"
                visit_fn(child, cls_name, f"{qual}.")
            else:
                fl.stmt(child)
        for nested in fl.nested:
            local_funcs[nested.name] = f"{qual}.{nested.name}"
            visit_fn(nested, cls_name, f"{qual}.")
        functions.append({
            "module": module, "path": path, "cls": cls_name,
            "name": node.name, "qual": qual, "params": params,
            "line": node.lineno, "events": fl.events,
            "local_funcs": local_funcs,
        })

    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            visit_fn(node, None, "")
        elif isinstance(node, ast.ClassDef):
            classes.append({
                "module": module, "name": node.name,
                "bases": [b for b in map(lambda x: resolve_call(x, imports),
                                         node.bases) if b],
            })
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    visit_fn(item, node.name, f"{node.name}.")
    return {"path": path, "module": module, "functions": functions,
            "classes": classes}


# ------------------------------------------------------------------ linking


class _Root:
    """One taint origin flowing through a function body.  ``applied`` is
    the set of verification classes sanctioned edges have conferred on any
    value derived from this root (root-coarse, see module docstring)."""

    __slots__ = ("origin", "applied")

    def __init__(self, origin: Tuple, applied: Optional[Set[str]] = None):
        self.origin = origin  # ("src", edge_name) | ("param", idx)
        self.applied: Set[str] = set(applied or ())


@dataclass
class _Summary:
    # ("param", idx, frozenset) passthroughs and ("taint", frozenset)
    # wire-taint returns, with the classes conferred by return time
    returns: Set[Tuple] = field(default_factory=set)
    # (param_idx, missing_groups, sink_name): param reaches a sink with
    # these CNF groups still unsatisfied inside the callee
    param_sink: Set[Tuple] = field(default_factory=set)
    # param_idx -> classes conferred on that argument by calling this fn
    sanitizes: Dict[int, FrozenSet[str]] = field(default_factory=dict)

    def key(self) -> Tuple:
        return (
            frozenset(self.returns), frozenset(self.param_sink),
            frozenset(self.sanitizes.items()),
        )


class _Linker:
    def __init__(self, facts: Sequence[Dict], scoped: bool = True):
        self.files = [f for f in facts if f]
        self.scoped = scoped
        edges = _edges_by_kind()
        self.sources = {e.pattern: e for e in edges["source"]}
        self.sanitizers = {e.pattern: e for e in edges["sanitizer"]}
        self.entries = {e.pattern: e for e in edges["entry"]}
        self.call_sinks = {e.pattern: e for e in edges["sink"]
                           if e.match == "call"}
        self.store_sinks = {e.pattern: e for e in edges["sink"]
                            if e.match == "attr-store"}
        self.fns: List[Dict] = []
        self.by_qual: Dict[Tuple[str, str], Dict] = {}
        self.methods: Dict[Tuple[str, str, str], Dict] = {}
        self.mod_fns: Dict[Tuple[str, str], Dict] = {}
        for f in self.files:
            for fn in f["functions"]:
                self.fns.append(fn)
                self.by_qual[(fn["module"], fn["qual"])] = fn
                if fn["cls"]:
                    self.methods[(fn["module"], fn["cls"], fn["name"])] = fn
                elif fn["qual"] == fn["name"]:
                    self.mod_fns[(fn["module"], fn["name"])] = fn
        self.summaries: Dict[Tuple[str, str], _Summary] = {
            (fn["module"], fn["qual"]): _Summary() for fn in self.fns
        }
        self.findings: List[Finding] = []
        self.live_edges: Set[str] = set()
        self._report_sites: Set[Tuple] = set()

    # ---------------------------------------------------------- resolution

    def _resolve_summary(self, fn: Dict, dotted: Optional[str]
                         ) -> Optional[Dict]:
        """Best-effort call-graph edge: self-methods (own class), local
        nested functions, module-level functions (same module or imported
        by dotted suffix).  Cross-object method calls resolve through the
        registry instead — that asymmetry is deliberate (a wrong summary
        is worse than no summary)."""
        if not dotted:
            return None
        parts = dotted.split(".")
        if parts[0] in ("self", "cls") and len(parts) == 2 and fn["cls"]:
            hit = self.methods.get((fn["module"], fn["cls"], parts[1]))
            if hit is not None:
                return hit
            # single-definition fallback: unique method name tree-wide
            cands = [f for (m, c, n), f in self.methods.items()
                     if n == parts[1]]
            return cands[0] if len(cands) == 1 else None
        if len(parts) == 1:
            local = fn["local_funcs"].get(parts[0])
            if local:
                return self.by_qual.get((fn["module"], local))
            return self.mod_fns.get((fn["module"], parts[0]))
        # imported module function: match by dotted suffix against known
        # (module, name) pairs
        name = parts[-1]
        want = ".".join(parts[:-1])
        cands = [f for (m, n), f in self.mod_fns.items()
                 if n == name and (m.endswith(want) or want.endswith(m))]
        return cands[0] if len(cands) == 1 else None

    @staticmethod
    def _callable_names(fn: Dict, dotted: str) -> List[str]:
        return [dotted]

    # -------------------------------------------------------- registry hits

    def _match(self, table: Dict[str, Edge], dotted: Optional[str]
               ) -> Optional[Edge]:
        if not dotted:
            return None
        pat = suffix_match(dotted, table.keys())
        return table[pat] if pat else None

    def _fn_matches(self, fn: Dict, table: Dict[str, Edge]
                    ) -> Optional[Edge]:
        qual = f"{fn['cls']}.{fn['name']}" if fn["cls"] else fn["name"]
        pat = suffix_match(qual, table.keys())
        return table[pat] if pat else None

    # --------------------------------------------------------- interpretation

    def _interp(self, fn: Dict, report: bool) -> None:
        key = (fn["module"], fn["qual"])
        summary = _Summary()
        san_edge = self._fn_matches(fn, self.sanitizers)
        if san_edge is not None:
            # Sanctioned verifier edge: its body IS the verification
            # implementation — trusted, not analyzed.  It confers its
            # classes on every argument and returns them verified.
            params = fn["params"]
            for idx, p in enumerate(params):
                if p in ("self", "cls"):
                    continue
                summary.sanitizes[idx] = san_edge.confers
                summary.returns.add(("param", idx, san_edge.confers))
            if self.summaries[key].key() != summary.key():
                self.summaries[key] = summary
                self.changed = True
            return

    # ------------------------------------------------------------------
        env: Dict[str, Set[_Root]] = {}
        param_roots: Dict[int, _Root] = {}
        entry_edge = self._fn_matches(fn, self.entries)
        for idx, p in enumerate(fn["params"]):
            if p in ("self", "cls"):
                continue
            if entry_edge is not None:
                root = _Root(("src", entry_edge.name))
            else:
                root = _Root(("param", idx))
            param_roots[idx] = root
            env[p] = {root}

        def eval_expr(expr) -> Set[_Root]:
            if expr is None:
                return set()
            kind = expr[0]
            if kind == "name":
                return set(env.get(expr[1], ()))
            if kind == "many":
                out: Set[_Root] = set()
                for part in expr[1]:
                    out |= eval_expr(part)
                return out
            if kind == "call":
                return eval_call(expr)
            return set()

        def check_sink(edge: Edge, roots: Set[_Root], line: int, col: int,
                       snippet: str, via: str) -> None:
            if edge.expect_live:
                self.live_edges.add(edge.name)
            if not roots:
                return
            applied: Set[str] = set()
            for r in roots:
                applied |= r.applied
            missing = tuple(g for g in edge.requires if not (g & applied))
            if not missing:
                return
            src_roots = [r for r in roots if r.origin[0] == "src"]
            if src_roots and report:
                site = (fn["path"], line, col, edge.name)
                if site not in self._report_sites:
                    self._report_sites.add(site)
                    origin = sorted({r.origin[1] for r in src_roots})
                    need = " AND ".join(
                        "|".join(sorted(g)) for g in missing
                    )
                    self.findings.append(Finding(
                        RULE, fn["path"], line, col,
                        f"wire-tainted value (from {', '.join(origin)}) "
                        f"reaches protocol decision '{edge.name}'{via} "
                        f"without a sanctioned verifier edge conferring "
                        f"[{need}] — route it through the registry's "
                        "sanitizers (docs/ANALYSIS.md §wire-taint) or "
                        "register the fast path's new verifier edge",
                        snippet=snippet, severity="high",
                    ))
            for r in roots:
                if r.origin[0] == "param":
                    still = tuple(g for g in edge.requires
                                  if not (g & (applied | r.applied)))
                    if still:
                        summary.param_sink.add(
                            (r.origin[1], still, edge.name)
                        )

        def eval_call(expr) -> Set[_Root]:
            _, dotted, args, base, line, col, snippet, recv = expr
            arg_roots = [eval_expr(a) for a in args]
            recv_roots = eval_expr(recv)
            all_roots: Set[_Root] = set(recv_roots)
            for rs in arg_roots:
                all_roots |= rs
            # 1. sanctioned sanitizer: confer classes on every arg root
            san = self._match(self.sanitizers, dotted)
            if san is not None:
                if san.expect_live:
                    self.live_edges.add(san.name)
                for r in all_roots:
                    r.applied |= san.confers
                return set(all_roots)
            # 2. source: fresh taint
            src = self._match(self.sources, dotted)
            if src is not None:
                if src.expect_live:
                    self.live_edges.add(src.name)
                return {_Root(("src", src.name))}
            # 3. sink
            sink = self._match(self.call_sinks, dotted)
            if sink is not None:
                check_sink(sink, all_roots, line, col, snippet, "")
                return set(all_roots)
            # 4. summarized callee
            callee = self._resolve_summary(fn, dotted)
            if callee is not None:
                ckey = (callee["module"], callee["qual"])
                csum = self.summaries.get(ckey)
                if csum is not None:
                    # parameter offset: method calls via self skip "self"
                    for pidx, classes in csum.sanitizes.items():
                        rs = self._args_for(callee, pidx, arg_roots)
                        for r in rs:
                            r.applied |= classes
                    for pidx, missing, sink_name in csum.param_sink:
                        rs = self._args_for(callee, pidx, arg_roots)
                        if rs:
                            pseudo = Edge(sink_name, "sink", sink_name,
                                          requires=missing)
                            check_sink(
                                pseudo, rs, line, col, snippet,
                                f" via {callee['qual']}()",
                            )
                    out: Set[_Root] = set()
                    for ret in csum.returns:
                        if ret[0] == "param":
                            rs = self._args_for(callee, ret[1], arg_roots)
                            for r in rs:
                                r.applied |= ret[2]
                            out |= rs
                        else:
                            out.add(_Root(("src", f"{callee['qual']}()"),
                                          ret[1]))
                    return out
            # 5. clean builtins
            if dotted in _CLEAN_CALLS or (
                dotted and suffix_match(dotted, _CLEAN_CALLS)
            ):
                return set()
            # 6. mutating container method: taint the receiver
            if base is not None and dotted and "." in dotted:
                method = dotted.rsplit(".", 1)[1]
                if method in _MUTATORS and all_roots:
                    env.setdefault(base, set()).update(all_roots)
            # unknown call: taint passes through
            return set(all_roots)

        for event in fn["events"]:
            kind = event[0]
            if kind == "expr":
                eval_expr(event[1])
            elif kind == "assign":
                targets, value = event[1], event[2]
                roots = eval_expr(value)
                for t in targets:
                    if t[0] == "n":
                        env[t[1]] = set(roots)
                    else:  # ("store", attr, line, col, snippet)
                        edge = self.store_sinks.get(
                            suffix_match(t[1], self.store_sinks.keys()) or ""
                        )
                        if edge is not None:
                            check_sink(edge, roots, t[2], t[3], t[4], "")
            elif kind == "ret":
                for r in eval_expr(event[1]):
                    if r.origin[0] == "param":
                        summary.returns.add(
                            ("param", r.origin[1], frozenset(r.applied))
                        )
                    else:
                        summary.returns.add(
                            ("taint", frozenset(r.applied))
                        )
        # classes conferred on parameters by this function's body
        if entry_edge is None:
            for idx, root in param_roots.items():
                if root.applied:
                    summary.sanitizes[idx] = frozenset(root.applied)
        if self.summaries[key].key() != summary.key():
            self.summaries[key] = summary
            self.changed = True

    @staticmethod
    def _args_for(callee: Dict, pidx: int, arg_roots: List[Set[_Root]]
                  ) -> Set[_Root]:
        """Map a callee parameter index onto the call's argument roots.
        Self/cls offset is handled by comparing positions past the
        receiver; keyword reordering degrades to the positional guess
        (root-coarse unions make this safe: worst case a class lands on a
        sibling argument's root of the same call)."""
        params = callee["params"]
        skip = 1 if params and params[0] in ("self", "cls") else 0
        pos = pidx - skip
        if 0 <= pos < len(arg_roots):
            return set(arg_roots[pos])
        out: Set[_Root] = set()
        for rs in arg_roots:
            out |= rs
        return out

    # -------------------------------------------------------------- driver

    def run(self) -> List[Finding]:
        self.changed = True
        rounds = 0
        order = sorted(self.fns, key=lambda f: (f["path"], f["line"]))
        while self.changed and rounds < 8:
            self.changed = False
            rounds += 1
            for fn in order:
                self._interp(fn, report=False)
        self._report_sites.clear()
        self.live_edges.clear()
        for fn in order:
            self._interp(fn, report=True)
        scanned = {f["path"] for f in self.files}
        if _ANCHOR_PATH in scanned:
            for e in registered_edges():
                if e.expect_live and e.name not in self.live_edges:
                    self.findings.append(Finding(
                        RULE, _ANCHOR_PATH, 1, 0,
                        f"registry-rot: sanctioned edge '{e.name}' "
                        f"(pattern '{e.pattern}') matched no call site in "
                        "a full-tree scan — the edge was renamed, removed "
                        "or bypassed without updating the wire-taint "
                        "registry (mochi_tpu_torch/analysis/wire_taint.py)",
                        snippet=f"registry-rot:{e.name}", severity="medium",
                    ))
        return self.findings


def link(facts: Sequence[Optional[Dict]], scoped: bool = True
         ) -> List[Finding]:
    """Whole-tree phase: fixpoint the summaries, then report."""
    real = [f for f in facts if f]
    if not real:
        return []
    return _Linker(real, scoped=scoped).run()


def check(tree: ast.Module, src: str, path: str, scoped: bool = True
          ) -> List[Finding]:
    """Single-file convenience wrapper (fixtures, ad-hoc use).  Full runs
    go through extract()+link() so summaries cross file boundaries —
    analysis/core.py drives that path."""
    facts = extract(tree, src, path, scoped=scoped)
    return link([facts], scoped=scoped)
