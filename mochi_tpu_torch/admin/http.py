"""Minimal asyncio HTTP admin server (no external web framework).

Endpoints (reference analog in parens — SURVEY.md §2.8):

* ``GET /json``    — hello record, like the demo REST controller
  (``controller/MainController.java:15-21``)
* ``GET /status``  — replica identity, cluster shape, store counters
* ``GET /metrics`` — ``mochi_tpu_torch.utils.metrics`` snapshot (the reference had
  client-side Dropwizard timers via JMX only, ``MochiDBClient.java:52-70``;
  here every replica serves its own)
* ``GET /``        — static status page (``resources/static/index.html``)

Deliberately HTTP/1.1-subset: GET only, no keep-alive pipelining guarantees,
JSON bodies.  This is an operator surface, not a data path.
"""

from __future__ import annotations

import asyncio
import json
import os
from typing import Optional

from ..verifier.spi import verifier_stats

_PAGE = """<!doctype html>
<html><head><title>mochi-tpu replica {server_id}</title>
<meta http-equiv="refresh" content="3">
<style>
 body {{ font-family: system-ui, sans-serif; margin: 2rem auto; max-width: 46rem;
         color: #1a1a2e; }}
 code {{ background: #f0f0f0; padding: 0.1rem 0.3rem; border-radius: 4px; }}
 table {{ border-collapse: collapse; margin: 0.6rem 0 1.2rem; }}
 th, td {{ text-align: left; padding: 0.25rem 0.9rem 0.25rem 0; }}
 th {{ border-bottom: 1px solid #ccc; font-weight: 600; }}
 .me {{ font-weight: 700; }}
 .muted {{ color: #667; }}
 li {{ margin: 0.3rem 0; }}
</style></head>
<body>
<h1>mochi-tpu replica <code>{server_id}</code></h1>
<p class="muted">BFT transactional KV store, GPU-batched signature
verification &middot; configstamp {configstamp} &middot; rf={rf} f={f}
quorum={quorum} &middot; {member}</p>
<h2>Membership</h2>
<table><tr><th>server</th><th>endpoint</th></tr>{member_rows}</table>
<h2>Store</h2>
<table>{store_rows}</table>
<h2>Storage</h2>
<table>{storage_rows}</table>
<h2>Shard</h2>
<table>{shard_rows}</table>
<h2>Verifier</h2>
<table>{verifier_rows}</table>
<h2>Batching</h2>
<table>{batching_rows}</table>
<h2>Overload</h2>
<table>{overload_rows}</table>
<h2>Fan-out</h2>
<table>{fanout_rows}</table>
<h2>Byzantine evidence</h2>
<table>{byzantine_rows}</table>
<h2>Clients</h2>
<table>{clients_rows}</table>
<p class="muted">{sessions} live client sessions &middot;
admin-gated: {admin_gated} &middot; page auto-refreshes</p>
<ul>
<li><a href="/status"><code>/status</code></a> — this view as JSON</li>
<li><a href="/metrics"><code>/metrics</code></a> — timers and counters</li>
<li><a href="/json"><code>/json</code></a> — hello record</li>
</ul>
</body></html>
"""


def _esc(s) -> str:
    return (
        str(s).replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")
    )


def _walk_numeric(prefix: str, obj: dict, out: list) -> None:
    """Flatten a stats dict's numeric leaves into (dotted_name, value) —
    bools as 0/1, lists skipped (bucket lists are not scalar gauges)."""
    for k, v in obj.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            _walk_numeric(key, v, out)
        elif isinstance(v, bool):
            out.append((key, int(v)))
        elif isinstance(v, (int, float)):
            out.append((key, v))


def _prom_esc(v) -> str:
    """Prometheus label-value escaping — ONE definition for every
    hand-rolled exposition block in this module.  Peer/client identity
    strings are attacker-influenced (a client names itself), so EVERY
    label value in every family goes through here; the roundtrip contract
    is pinned by tests/test_metrics_prom.py against a real parser."""
    return (
        str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


# ---------------------------------------------------- exposition hygiene
#
# Every hand-rolled ``mochi_*`` family carries ``# HELP`` + ``# TYPE``
# headers (exposition-format parsers and registries key metadata off
# them), and per-identity label cardinality is BOUNDED: ``mochi_fanout``,
# ``mochi_client`` and ``mochi_byzantine`` grow one series per peer or
# client identity, which makes a Sybil flood a memory attack on every
# scraper downstream of this surface.  Identities past the cap aggregate
# into a single ``other`` series (top spots go to the highest-activity
# identities — the rows an operator is hunting — so a flood of one-shot
# identities lands in ``other`` instead of evicting the evidence).

# Default series cap per identity-labeled family; the env knob is read at
# CALL time (every other MOCHI_* knob in this round resolves at use, and
# an operator exporting MOCHI_PROM_MAX_SERIES after import must not be
# silently ignored).
PROM_MAX_SERIES = 64


def _prom_max_series() -> int:
    try:
        return max(2, int(os.environ.get("MOCHI_PROM_MAX_SERIES",
                                         str(PROM_MAX_SERIES))))
    except ValueError:
        return PROM_MAX_SERIES


def _family_header(name: str, ftype: str, help_text: str) -> str:
    return f"# HELP {name} {help_text}\n# TYPE {name} {ftype}\n"


def _cap_identities(table: dict, activity) -> dict:
    """Bound an identity-keyed dict at the series cap: the highest-
    ``activity`` identities keep their rows (ties broken by name for
    determinism), the rest fold into ``other`` via ``sum``-merging of
    numeric leaves.  A literal identity named "other" merges in too —
    collision-safe by construction, if unattributable."""
    cap = _prom_max_series()
    if len(table) <= cap:
        return table
    ranked = sorted(table.items(), key=lambda kv: (-activity(kv[1]), kv[0]))
    kept = dict(ranked[: cap - 1])
    overflow: dict = {}
    for _, stats in ranked[cap - 1:]:
        if isinstance(stats, dict):
            for k, v in stats.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    overflow[k] = overflow.get(k, 0) + v
        else:
            overflow["total"] = overflow.get("total", 0) + stats
    prev = kept.pop("other", None)
    if isinstance(prev, dict):
        for k, v in prev.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                overflow[k] = overflow.get(k, 0) + v
    elif isinstance(prev, (int, float)):
        overflow["total"] = overflow.get("total", 0) + prev
    kept["other"] = overflow
    return kept


def _num_activity(stats) -> float:
    """Activity rank for the cardinality cap: sum of numeric leaves (a
    histogram snapshot contributes its count)."""
    if isinstance(stats, (int, float)):
        return float(stats)
    total = 0.0
    for v in stats.values():
        if isinstance(v, bool):
            continue
        if isinstance(v, (int, float)):
            total += v
        elif isinstance(v, dict) and isinstance(v.get("count"), (int, float)):
            total += v["count"]
    return total


def _live_netsim(replica):
    """The replica's NetSim iff it actually conditions traffic: an
    enabled=False sim (the passthrough A/B leg) must leave every admin
    surface byte-identical to a replica with no netsim at all."""
    sim = getattr(replica, "netsim", None)
    return sim if sim is not None and sim.enabled else None


def _rows(d: dict) -> str:
    return "".join(
        f"<tr><td>{_esc(k)}</td><td>{_esc(v)}</td></tr>" for k, v in d.items()
    )


# ------------------------------------------------- fan-out observability
#
# Early-quorum fan-outs (net/transport.fan_out) record per-TARGET-replica
# straggler evidence into the INITIATOR's metrics registry:
#   fanout-straggler-ms.<sid>   histogram: lateness past the quorum point
#   fanout.late-response.<sid>  counter: answered after the early return
#   fanout.straggler-error.<sid>  counter: leg failed while draining
#   fanout.straggler-timeout.<sid> counter: never answered in budget
#   fanout.early-return         counter: fan-outs that returned at quorum
# The extractors below are registry-generic, so every admin surface — the
# replica shell, the client shell, any future initiator — renders the same
# shape (docs/OPERATIONS.md §4d "Write-path latency").

_FANOUT_COUNTER_STATS = (
    "late-response",
    "straggler-error",
    "straggler-timeout",
    "straggler-drain-cancelled",
)


def _fanout_stats(metrics) -> dict:
    """``{"early_returns": n, "peers": {sid: {...}}}`` from a registry's
    ``fanout*`` entries; empty peers dict when the process never fanned
    out (the surface then stays compact rather than vanishing).

    Per-peer SUSPICION rides the same rows (``suspect.<kind>.<sid>``
    counters from the client's tally paths — MochiDBClient.SUSPECT_KINDS —
    rendered as ``suspect_<kind>``): the initiator's fan-out table is
    where an operator asks "which replica is misbehaving?", so straggler
    evidence and tally evidence about one peer belong on one row."""
    peers: dict = {}
    for name, h in metrics.histograms.items():
        if name.startswith("fanout-straggler-ms."):
            peers.setdefault(name[len("fanout-straggler-ms."):], {})[
                "straggler_ms"
            ] = h.snapshot()
    for stat in _FANOUT_COUNTER_STATS:
        prefix = f"fanout.{stat}."
        for name, n in metrics.counters.items():
            if name.startswith(prefix):
                peers.setdefault(name[len(prefix):], {})[
                    stat.replace("-", "_")
                ] = n
    for name, n in metrics.counters.items():
        if name.startswith("suspect."):
            kind, sep, sid = name[len("suspect."):].partition(".")
            if sep and sid:
                peers.setdefault(sid, {})[
                    "suspect_" + kind.replace("-", "_")
                ] = n
    return {
        "early_returns": metrics.counters.get("fanout.early-return", 0),
        "peers": peers,
    }


def _fanout_prom(metrics, label_key: str, label_val: str) -> str:
    """``mochi_fanout{peer=...,stat=...}`` exposition block ('' when the
    registry holds no fan-out evidence).  Counters plus straggler-lateness
    count/mean; the full lateness HISTOGRAM already rides the standard
    ``mochi_histogram`` family under name="fanout-straggler-ms.<sid>"."""
    st = _fanout_stats(metrics)
    if not st["peers"] and not st["early_returns"]:
        return ""
    base = f'{label_key}="{_prom_esc(label_val)}"'
    lines = [
        _family_header(
            "mochi_fanout", "gauge",
            "Per-peer early-quorum fan-out evidence (stragglers, suspicion); "
            "identities past the cap aggregate under peer=\"other\"",
        ),
        f'mochi_fanout{{peer="",stat="early_returns",{base}}} '
        f'{st["early_returns"]}\n',
    ]
    peers = _cap_identities(st["peers"], _num_activity)
    for peer, stats in sorted(peers.items()):
        pn = _prom_esc(peer)
        for stat, v in sorted(stats.items()):
            if isinstance(v, dict):  # histogram snapshot -> count + mean
                lines.append(
                    f'mochi_fanout{{peer="{pn}",stat="straggler_ms_count",'
                    f"{base}}} {v['count']}\n"
                )
                if v["mean"] is not None:
                    lines.append(
                        f'mochi_fanout{{peer="{pn}",stat="straggler_ms_mean",'
                        f"{base}}} {v['mean']}\n"
                    )
            else:
                lines.append(
                    f'mochi_fanout{{peer="{pn}",stat="{_prom_esc(stat)}",'
                    f"{base}}} {v}\n"
                )
    return "".join(lines)


def _fanout_rows(metrics) -> str:
    """The "/" page Fan-out table: one row per target replica."""
    st = _fanout_stats(metrics)
    if not st["peers"]:
        return (
            "<tr><td>(no early-quorum fan-out traffic from this process)"
            "</td><td></td></tr>"
        )
    rows = [
        f"<tr><td>early returns</td><td>{st['early_returns']}</td></tr>"
    ]
    for peer, stats in sorted(st["peers"].items()):
        h = stats.get("straggler_ms")
        parts = []
        if h:
            parts.append(f"late n={h['count']} mean={h['mean']} ms")
        for stat in ("late_response", "straggler_error", "straggler_timeout",
                     "straggler_drain_cancelled"):
            if stat in stats:
                parts.append(f"{stat}={stats[stat]}")
        # the per-peer suspicion row: tally-path evidence next to the
        # transport evidence (docs/OPERATIONS.md §4f)
        for stat in sorted(s for s in stats if s.startswith("suspect_")):
            parts.append(f"{stat}={stats[stat]}")
        rows.append(
            f"<tr><td>{_esc(peer)}</td><td>{_esc(' '.join(parts))}</td></tr>"
        )
    return "".join(rows)


def _byzantine_rows(replica) -> str:
    """The "/" page Byzantine-evidence table: proven equivocations and
    bad-grant attribution per peer (replica.byzantine_stats)."""
    bz = replica.byzantine_stats()
    rows = []
    for sid, n in sorted(bz["equivocations"].items()):
        rows.append(f"<tr><td>{_esc(sid)}</td><td>equivocations={n}</td></tr>")
    for sid, n in sorted(bz["bad_grants"].items()):
        rows.append(f"<tr><td>{_esc(sid)}</td><td>bad_grants={n}</td></tr>")
    if bz["resync_bad_certificates"]:
        rows.append(
            "<tr><td>(resync)</td><td>bad_certificates="
            f"{bz['resync_bad_certificates']}</td></tr>"
        )
    if not rows:
        return "<tr><td>(no equivocation or bad-grant evidence)</td><td></td></tr>"
    return "".join(rows)


def _byzantine_prom(replica) -> str:
    """``mochi_byzantine{peer,stat}`` exposition ('' when no evidence):
    the PromQL answer to "has any replica been caught misbehaving?"."""
    bz = replica.byzantine_stats()
    sid = _prom_esc(replica.server_id)
    lines = []
    for stat, per_peer in (("equivocations", bz["equivocations"]),
                           ("bad_grants", bz["bad_grants"])):
        capped = _cap_identities(dict(per_peer), _num_activity)
        for peer, n in sorted(capped.items()):
            if isinstance(n, dict):  # the "other" overflow bucket
                n = n.get("total", 0)
            lines.append(
                f'mochi_byzantine{{peer="{_prom_esc(peer)}",stat="{stat}",'
                f'server="{sid}"}} {n}\n'
            )
    if bz["resync_bad_certificates"]:
        lines.append(
            f'mochi_byzantine{{peer="",stat="resync_bad_certificates",'
            f'server="{sid}"}} {bz["resync_bad_certificates"]}\n'
        )
    if not lines:
        return ""
    return _family_header(
        "mochi_byzantine", "gauge",
        "Per-peer misbehavior convictions (equivocations, bad grants); "
        "identities past the cap aggregate under peer=\"other\"",
    ) + "".join(lines)


def _clients_rows(replica) -> str:
    """The "/" page Clients table: grant/quota/reclaim accounting — the
    aggregate knobs and wedge liveness metric first, then one row per
    tracked client identity (replica.client_grant_stats; docs/OPERATIONS.md
    §4h)."""
    st = replica.client_grant_stats()
    rows = []
    for k in (
        "quota", "ttl_ms", "reclaims", "quota_refused", "outstanding_total",
        "max_wedge_ms", "open_wedges",
    ):
        rows.append(f"<tr><td>{_esc(k)}</td><td>{_esc(st[k])}</td></tr>")
    per_client = st.get("per_client", {})
    if not per_client:
        rows.append(
            "<tr><td>(no per-client grant traffic yet)</td><td></td></tr>"
        )
    for cid, cst in sorted(per_client.items()):
        parts = " ".join(f"{k}={v}" for k, v in sorted(cst.items()))
        rows.append(f"<tr><td>{_esc(cid)}</td><td>{_esc(parts)}</td></tr>")
    return "".join(rows)


def _clients_prom(replica) -> str:
    """``mochi_client{client,stat}`` exposition: aggregate rows carry
    ``client=""``; per-identity rows track the store's client-stats
    table — FIFO-capped at CLIENT_STATS_MAX, with live grant holders
    admitted over cap until their grants age out (so an identity flood's
    series count is bounded by cap + flood-rate x TTL, not by cap alone;
    see DataStore._client_entry)."""
    st = replica.client_grant_stats()
    sid = _prom_esc(replica.server_id)
    lines = [
        _family_header(
            "mochi_client", "gauge",
            "Per-client grant/quota/reclaim accounting (client=\"\" rows "
            "are aggregates); identities past the cap aggregate under "
            "client=\"other\"",
        )
    ]
    flat: list = []
    _walk_numeric("", {k: v for k, v in st.items() if k != "per_client"}, flat)
    for k, v in flat:
        lines.append(
            f'mochi_client{{client="",stat="{_prom_esc(k)}",server="{sid}"}} {v}\n'
        )
    per_client = _cap_identities(dict(st.get("per_client", {})), _num_activity)
    for cid, cst in sorted(per_client.items()):
        cn = _prom_esc(cid)
        for k, v in sorted(cst.items()):
            if isinstance(v, bool):
                v = int(v)
            elif not isinstance(v, (int, float)):
                continue
            lines.append(
                f'mochi_client{{client="{cn}",stat="{_prom_esc(k)}",'
                f'server="{sid}"}} {v}\n'
            )
    return "".join(lines)


def _storage_rows(replica) -> str:
    """The "/" page Storage table (docs/OPERATIONS.md §4i): durable-engine
    counters — WAL bytes/entries/segments, fsync policy + count, snapshot
    age, replay report — plus the anti-entropy delta-vs-full transfer
    accounting, one row per leaf.  The in-memory default renders just the
    engine posture row."""
    st = replica.storage_stats()
    rows = {k: st[k] for k in ("engine", "fsync", "dir") if k in st}
    leaves: list = []
    _walk_numeric("", st, leaves)
    rows.update(dict(leaves))
    return _rows(rows)


def _storage_prom(replica) -> str:
    """``mochi_storage{stat,server}`` exposition: every numeric leaf of
    storage_stats (wal bytes/entries, fsyncs, snapshot age/seq, replay
    progress + convictions, anti-entropy delta counters).  The fsync
    latency histogram rides the registry's own exposition as
    ``storage-fsync-ms``."""
    samples: list = []
    _walk_numeric("", replica.storage_stats(), samples)
    if not samples:
        return ""
    sid = _prom_esc(replica.server_id)
    return _family_header(
        "mochi_storage", "gauge",
        "Durable-engine counters (WAL, fsync, snapshots, anti-entropy)",
    ) + "".join(
        f'mochi_storage{{stat="{_prom_esc(k)}",server="{sid}"}} {v}\n'
        for k, v in samples
    )


def _overload_rows(replica) -> str:
    """The "/" page Overload table: admission-control state and bounded-
    table sizes, flattened to one row per numeric leaf."""
    flat: list = []
    _walk_numeric("", replica.overload_stats(), flat)
    return "".join(
        f"<tr><td>{_esc(k)}</td><td>{_esc(v)}</td></tr>" for k, v in flat
    )


def _batching_rows(metrics) -> str:
    """Occupancy/latency histograms of the batched hot path, one row per
    histogram: count, mean, and the non-empty buckets — the at-a-glance
    answer to "is the drain actually batching under this traffic?"
    (docs/OPERATIONS.md "Batched hot path")."""
    rows = {}
    for name, h in sorted(metrics.histograms.items()):
        snap = h.snapshot()
        buckets = " ".join(f"&le;{b}:{n}" for b, n in snap["buckets"].items())
        rows[name] = f"n={snap['count']} mean={snap['mean']} [{buckets}]"
    if not rows:
        return "<tr><td>(no batched traffic yet)</td><td></td></tr>"
    return "".join(
        f"<tr><td>{_esc(k)}</td><td>{v}</td></tr>" for k, v in rows.items()
    )


class HttpJsonServer:
    """Transport loop for tiny operator HTTP surfaces: GET-only,
    timeout-guarded reads, header drain, Content-Length responses.
    Subclasses implement ``_route(path) -> (status, content_type, body)``.
    (Shared by the replica admin shell below and the verifier service's
    ``--admin-port`` — one robust loop instead of per-surface copies.)"""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host = host
        self.port = port
        self._server: Optional[asyncio.base_events.Server] = None

    async def start(self) -> None:
        self._server = await asyncio.start_server(self._serve, self.host, self.port)

    @property
    def bound_port(self) -> int:
        assert self._server is not None
        return self._server.sockets[0].getsockname()[1]

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    def _route(self, path: str):
        raise NotImplementedError

    async def _serve(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            request_line = await asyncio.wait_for(reader.readline(), 10.0)
            parts = request_line.decode("latin-1").split()
            if len(parts) < 2 or parts[0] != "GET":
                status, ctype, body = 405, "application/json", '{"error": "GET only"}'
            else:
                # drain headers
                while True:
                    line = await asyncio.wait_for(reader.readline(), 10.0)
                    if line in (b"\r\n", b"\n", b""):
                        break
                status, ctype, body = self._route(parts[1].split("?")[0])
            payload = body.encode()
            reason = {200: "OK", 404: "Not Found", 405: "Method Not Allowed"}[status]
            writer.write(
                f"HTTP/1.1 {status} {reason}\r\n"
                f"Content-Type: {ctype}\r\n"
                f"Content-Length: {len(payload)}\r\n"
                "Connection: close\r\n\r\n".encode() + payload
            )
            await writer.drain()
        except (asyncio.TimeoutError, ConnectionResetError, UnicodeDecodeError):
            pass
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except asyncio.CancelledError:
                raise
            except Exception:
                pass


class AdminServer(HttpJsonServer):
    """Serves replica status over HTTP; start()/close() lifecycle."""

    def __init__(self, replica, host: str = "127.0.0.1", port: int = 0):
        super().__init__(host, port)
        self.replica = replica

    # ------------------------------------------------------------ handlers

    def _route(self, path: str):
        r = self.replica
        if path == "/json":
            return 200, "application/json", json.dumps(
                {"hello": "mochi-tpu", "serverId": r.server_id}
            )
        if path == "/status":
            cfg = r.config
            return 200, "application/json", json.dumps(
                {
                    "server_id": r.server_id,
                    "port": r.bound_port,
                    "cluster": {
                        "n_servers": cfg.n_servers,
                        "rf": cfg.rf,
                        "f": cfg.f,
                        "quorum": cfg.quorum,
                        "configstamp": cfg.configstamp,
                        "servers": {s.server_id: s.url for s in cfg.servers.values()},
                    },
                    "store": r.store.stats(),
                    # durable-storage engine counters + replay report +
                    # anti-entropy transfer accounting (engine "memory"
                    # when running the reference's in-memory posture —
                    # docs/OPERATIONS.md §4i)
                    "storage": r.storage_stats(),
                    # Token-ring ownership + per-phase owned/foreign traffic
                    # (the shard-per-core scale-out observable: foreign
                    # counters at ~0 mean client routing matches the ring —
                    # docs/OPERATIONS.md §4e)
                    "shard": r.store.shard_stats(),
                    "verifier": verifier_stats(r.verifier),
                    "batching": {
                        name: h.snapshot()
                        for name, h in sorted(r.metrics.histograms.items())
                    },
                    "sessions": len(getattr(r, "_sessions", {})),
                    # round-18 fast path: checkpoint ledgers, peer-session
                    # windows, aggregate-verify effectiveness
                    "fastpath": r.fastpath_stats(),
                    # admission control + bounded-state surface: shed
                    # probability, deterministic load components, session-
                    # table size/evictions (docs/OPERATIONS.md §4g)
                    "overload": r.overload_stats(),
                    # early-quorum fan-out evidence from THIS process's
                    # registry (peers empty on a pure responder — the
                    # key stays so dashboards need no existence probe)
                    "fanout": _fanout_stats(r.metrics),
                    # per-peer misbehavior evidence: proven equivocations
                    # (conflicting validly-signed grants for one slot) and
                    # bad-grant attribution (docs/OPERATIONS.md §4f)
                    "byzantine": r.byzantine_stats(),
                    # per-client grant/quota/reclaim accounting + the wedge
                    # liveness metric (docs/OPERATIONS.md §4h): who holds
                    # outstanding grants, who keeps getting reclaimed
                    # (withholders), who bounces off the quota (hoarders)
                    "clients": r.client_grant_stats(),
                    # span-ring posture + counters (round 15; the ring
                    # itself exports at /trace)
                    "trace": r.tracer.summary(),
                    "config_history_stamps": sorted(r.store.config_history),
                    "member": r.server_id in cfg.servers,
                    "admin_gated": bool(cfg.admin_keys),
                    # per-link conditioning counters when the replica runs
                    # under netsim (docs/OPERATIONS.md "Network
                    # conditioning"); absent key = unconditioned — which
                    # includes enabled=False (the passthrough A/B leg must
                    # be indistinguishable from no netsim at all)
                    **(
                        {"netsim": r.netsim.stats(endpoint=r.server_id)}
                        if _live_netsim(r) is not None
                        else {}
                    ),
                }
            )
        if path == "/metrics":
            snap = r.metrics.snapshot()
            if _live_netsim(r) is not None:
                # the sim's own registry (per-link counters + queue-depth
                # gauges) rides the same snapshot machinery
                snap["netsim"] = r.netsim.metrics.snapshot()
            return 200, "application/json", json.dumps(snap)
        if path == "/metrics.prom":
            # Prometheus text exposition for a standard scrape stack (the
            # reference exposed Dropwizard timers via a JMX reporter,
            # MochiDBClient.java:52-70; this is the modern equivalent).
            body = r.metrics.to_prometheus({"server": r.server_id})
            # Verifier-composition gauges (numeric leaves of verifier_stats,
            # flattened) — includes the comb routing/dispatch counters, so
            # "is the known-signer fast path carrying this replica's cert
            # traffic?" is answerable from a scrape (docs/OPERATIONS.md
            # §"Comb-first verification").
            samples: list = []
            _walk_numeric("", verifier_stats(r.verifier), samples)
            if samples:
                sid = _prom_esc(r.server_id)
                body += _family_header(
                    "mochi_verifier", "gauge",
                    "Verifier-composition counters (batching, caching, comb "
                    "routing)",
                ) + "".join(
                    f'mochi_verifier{{name="{_prom_esc(k)}",server="{sid}"}} {v}\n'
                    for k, v in samples
                )
            body += _fanout_prom(r.metrics, "server", r.server_id)
            body += _byzantine_prom(r)
            # Durable-storage gauges: mochi_storage{stat} — WAL growth,
            # fsync count, snapshot age, replay progress/convictions and
            # the anti-entropy delta counters in one stat-labeled family
            # (docs/OPERATIONS.md §4i).
            body += _storage_prom(r)
            # Per-client grant accounting: mochi_client{client,stat} —
            # "is any client hoarding or being reclaimed?" is one query.
            body += _clients_prom(r)
            # Overload/admission gauges as one stat-labeled family:
            # mochi_shed{stat="shed_p"|"load"|"sendq_out_bytes"|
            # "sessions.size"|...} — "is any replica shedding, and why?"
            # is a single PromQL query (docs/OPERATIONS.md §4g).
            shed_samples: list = []
            _walk_numeric("", r.overload_stats(), shed_samples)
            sid = _prom_esc(r.server_id)
            body += _family_header(
                "mochi_shed", "gauge",
                "Admission-control state and deterministic load signal",
            ) + "".join(
                f'mochi_shed{{stat="{_prom_esc(k)}",server="{sid}"}} {v}\n'
                for k, v in shed_samples
            )
            # Per-shard ownership/traffic gauges: one family, stat-labeled,
            # so "is any replica serving foreign-shard traffic?" is a single
            # PromQL query across the fleet.
            sid = _prom_esc(r.server_id)
            body += _family_header(
                "mochi_shard", "gauge",
                "Token-ring ownership and owned/foreign traffic counters",
            ) + "".join(
                f'mochi_shard{{stat="{_prom_esc(k)}",server="{sid}"}} {v}\n'
                for k, v in sorted(r.store.shard_stats().items())
            )
            netsim = _live_netsim(r)
            if netsim is not None:
                # Per-directed-link conditioning stats as one gauge family:
                # mochi_netsim{link="a->b",stat="dropped"} — the acceptance
                # observable for "is the WAN shape actually applied?"
                # Scoped to links THIS replica terminates: several replicas
                # share one cluster-global sim in the in-process posture,
                # and exporting the full table from each would make a
                # multi-replica scrape over-count every link.
                sid = _prom_esc(r.server_id)
                lines = [
                    _family_header(
                        "mochi_netsim", "gauge",
                        "Per-directed-link network-conditioning counters",
                    )
                ]
                link_stats = netsim.stats(endpoint=r.server_id)["links"]
                for link, stats in sorted(link_stats.items()):
                    ln = _prom_esc(link)
                    for stat, v in stats.items():
                        lines.append(
                            f'mochi_netsim{{link="{ln}",stat="{_prom_esc(stat)}",'
                            f'server="{sid}"}} {int(v)}\n'
                        )
                body += "".join(lines)
            return (200, "text/plain; version=0.0.4", body)
        if path == "/trace":
            # Chrome trace-event export of the replica's span ring (round
            # 15, obs/trace.py): load directly in chrome://tracing or
            # Perfetto, or merge multi-process dumps with
            # ``python -m mochi_tpu_torch.tools.trace``.
            return 200, "application/json", json.dumps(
                r.tracer.export_chrome()
            )
        if path == "/" or path == "/index.html":
            cfg = r.config
            member_rows = "".join(
                f'<tr class="{"me" if s.server_id == r.server_id else ""}">'
                f"<td>{_esc(s.server_id)}</td><td><code>{_esc(s.url)}</code></td></tr>"
                for s in cfg.servers.values()
            )
            return 200, "text/html", _PAGE.format(
                server_id=_esc(r.server_id),
                configstamp=cfg.configstamp,
                rf=cfg.rf,
                f=cfg.f,
                quorum=cfg.quorum,
                member="member" if r.server_id in cfg.servers else "NOT A MEMBER",
                member_rows=member_rows,
                store_rows=_rows(r.store.stats()),
                storage_rows=_storage_rows(r),
                shard_rows=_rows(r.store.shard_stats()),
                verifier_rows=_rows(verifier_stats(r.verifier)),
                batching_rows=_batching_rows(r.metrics),
                overload_rows=_overload_rows(r),
                fanout_rows=_fanout_rows(r.metrics),
                byzantine_rows=_byzantine_rows(r),
                clients_rows=_clients_rows(r),
                sessions=len(getattr(r, "_sessions", {})),
                admin_gated=bool(cfg.admin_keys),
            )
        return 404, "application/json", json.dumps({"error": "not found"})


_CLIENT_PAGE = """<!doctype html>
<html><head><title>mochi-tpu client {client_id}</title>
<meta http-equiv="refresh" content="3">
<style>
 body {{ font-family: system-ui, sans-serif; margin: 2rem auto; max-width: 46rem;
         color: #1a1a2e; }}
 table {{ border-collapse: collapse; margin: 0.6rem 0 1.2rem; }}
 th, td {{ text-align: left; padding: 0.25rem 0.9rem 0.25rem 0; }}
 th {{ border-bottom: 1px solid #ccc; font-weight: 600; }}
 .muted {{ color: #667; }}
</style></head>
<body>
<h1>mochi-tpu client <code>{client_id}</code></h1>
<p class="muted">SDK coordinator shell &middot; early-quorum
{early_quorum} &middot; {sessions} live sessions</p>
<h2>Fan-out</h2>
<table>{fanout_rows}</table>
<h2>Clients</h2>
<table>{clients_rows}</table>
<h2>Timers</h2>
<table>{timer_rows}</table>
</body></html>
"""


def _client_grant_view(client) -> dict:
    """The INITIATOR's own grant/quota view (the client-shell half of the
    round-13 Clients surface): how often THIS identity bounced off each
    replica's grant quota — the self-diagnosis row an operator reads when
    a client's writes start backing off ("am I the hoarder?")."""
    prefix = "client.quota-refused."
    per_replica = {
        name[len(prefix):]: n
        for name, n in client.metrics.counters.items()
        if name.startswith(prefix)
    }
    return {
        "quota_refusals": client.metrics.counters.get("client.write1-quota", 0),
        "shed_rounds": client.metrics.counters.get("client.write1-shed", 0),
        "per_replica_quota_refused": per_replica,
    }


def _client_grant_rows(client) -> str:
    st = _client_grant_view(client)
    rows = [
        f"<tr><td>quota_refusals</td><td>{st['quota_refusals']}</td></tr>",
        f"<tr><td>shed_rounds</td><td>{st['shed_rounds']}</td></tr>",
    ]
    for sid, n in sorted(st["per_replica_quota_refused"].items()):
        rows.append(
            f"<tr><td>{_esc(sid)}</td><td>quota_refused={n}</td></tr>"
        )
    if len(rows) == 2 and not st["per_replica_quota_refused"]:
        rows.append(
            "<tr><td>(no quota refusals seen)</td><td></td></tr>"
        )
    return "".join(rows)


class ClientAdminServer(HttpJsonServer):
    """Operator shell for a long-lived SDK client process — the INITIATOR
    side of every fan-out, which is where the early-quorum straggler
    evidence accrues (a replica's shell only shows fan-outs it initiates).
    Same endpoints as the replica shell where they make sense: ``/status``
    (identity + fanout + timers JSON), ``/metrics`` (full snapshot),
    ``/metrics.prom`` (standard families + ``mochi_fanout``), ``/``."""

    def __init__(self, client, host: str = "127.0.0.1", port: int = 0):
        super().__init__(host, port)
        self.client = client

    def _route(self, path: str):
        c = self.client
        m = c.metrics
        if path == "/status":
            return 200, "application/json", json.dumps(
                {
                    "client_id": c.client_id,
                    "early_quorum": bool(c.early_quorum),
                    "sessions": len(c._sessions),
                    # round-18 fast path: checkpoint windows + deferred-
                    # grant/audit counters (the initiator-side half of the
                    # replica /status "fastpath" object)
                    "fastpath": c.fastpath_stats(),
                    "fanout": _fanout_stats(m),
                    # per-peer tally-path suspicion breakdown (the fanout
                    # peers table carries the same data as suspect_* rows)
                    "suspicion": c.suspicion_stats(),
                    # this identity's own grant-quota view (round 13)
                    "clients": _client_grant_view(c),
                    # span-ring posture (round 15; ring exports at /trace)
                    "trace": c.tracer.summary(),
                    "timers": {
                        name: t.snapshot() for name, t in sorted(m.timers.items())
                    },
                }
            )
        if path == "/metrics":
            return 200, "application/json", json.dumps(m.snapshot())
        if path == "/metrics.prom":
            body = m.to_prometheus({"client": c.client_id})
            body += _fanout_prom(m, "client", c.client_id)
            return 200, "text/plain; version=0.0.4", body
        if path == "/trace":
            # The initiator-side half of a transaction's causal record:
            # merge with the replicas' /trace dumps by trace_id
            # (tools/trace.py) for the end-to-end span tree.
            return 200, "application/json", json.dumps(
                c.tracer.export_chrome()
            )
        if path == "/" or path == "/index.html":
            timer_rows = "".join(
                f"<tr><td>{_esc(name)}</td><td>n={t.count} "
                f"p50={t.percentile(50) * 1e3:.2f} ms</td></tr>"
                for name, t in sorted(m.timers.items())
            )
            return 200, "text/html", _CLIENT_PAGE.format(
                client_id=_esc(c.client_id),
                early_quorum="on" if c.early_quorum else "off",
                sessions=len(c._sessions),
                fanout_rows=_fanout_rows(m),
                clients_rows=_client_grant_rows(c),
                timer_rows=timer_rows or "<tr><td>(no traffic)</td><td></td></tr>",
            )
        return 404, "application/json", json.dumps({"error": "not found"})
