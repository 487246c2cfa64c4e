"""Replica server entrypoint.

Ops-layer equivalent of the reference's boot path (``start_mochi.sh:4-8`` →
``Application.main`` → ``MochiServerInitializator`` → ``MochiServer.start()``),
as a plain asyncio process instead of a Spring Boot shell.

Usage:
    python -m mochi_tpu_torch.server --config cluster/cluster_config.json \
        --server-id server-0 --seed-file cluster/server-0.seed \
        [--verifier cuda|cpu|remote:<host>:<port>]

``--verifier cuda`` (the default) verifies certificates on the card with the
hand-written CUDA kernels (:class:`~mochi_tpu_torch.verifier.cuda.CudaBatchVerifier`),
and registers the cluster's replica identities as known signers, so their
grant signatures take the comb kernel.  Without a CUDA device it exits
non-zero and says so; it never quietly verifies on the CPU.  ``cpu`` is the
inline host path; ``remote:`` ships batches to a verifier service
(``python -m mochi_tpu_torch.verifier.service``) that owns the card.

Repeating ``--server-id``/``--seed-file`` (pairwise, in order) hosts SEVERAL
replicas on this process's one event loop; with ``--verifier cuda`` they
share the process's one card-owning verifier.

Lifecycle: each replica prints ``READY <server-id> <port>`` on stdout once
it serves (the machine-readable readiness probe), and SIGTERM/SIGINT runs a
bounded graceful drain — stop accepting, finish admitted work, flush
coalesced response writes (``MochiReplica.drain``) — before the close path,
so a supervisor's TERM is deterministic instead of a mid-batch abort.

Durable state: ``--storage-dir <root>`` gives each hosted replica a
durable engine under ``<root>/<server-id>`` (``--storage-engine wal``, the
default: WAL + whole-store snapshots; ``paged``: WAL tail + immutable value
pages + a bounded resident cache), whose boot recovery re-verifies every
stored grant signature through the replica's verifier before READY is
printed; ``--wal-fsync`` sets its durability policy.  ``--data-dir`` keeps
the older whole-store snapshot file per replica, every
``--snapshot-interval`` seconds.

Operator surface: ``--admin-port P`` serves the HTTP admin shell
(``/status``, ``/metrics``, ``/metrics.prom``, ``/trace``; hosted replica i
on port P + i), bound to loopback unless ``--admin-host`` widens it.

Fault injection (testing only): ``--byzantine <server-id>=<strategy>`` hosts
that replica as a ``ByzantineReplica`` (``testing/byzantine.py``); the
strategy is validated before the replica binds a port.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
from pathlib import Path

from ..cluster.config import ClusterConfig
from ..crypto.keys import keypair_from_seed
from ..server.replica import MochiReplica


def load_config(path: str) -> ClusterConfig:
    text = Path(path).read_text()
    if text.lstrip().startswith("{"):
        return ClusterConfig.from_json(text)
    return ClusterConfig.from_properties(text)


def _build_verifier(args, config: ClusterConfig, shared: dict):
    """The verifier for one hosted replica.  ``cuda`` builds ONE
    CudaBatchVerifier per process (kept in ``shared``) for every hosted
    replica: the card has one owner."""
    if args.verifier == "cuda":
        if "cuda" not in shared:
            import torch

            if not torch.cuda.is_available():
                raise SystemExit(
                    "--verifier cuda: no CUDA device is available (use "
                    "--verifier cpu, or remote:<host>:<port> for a verifier "
                    "service on a machine with a card)"
                )
            from ..verifier.cuda import CudaBatchVerifier

            # Builds and loads both kernels and launches each once at 16
            # lanes before READY, so the first client's commit pays no
            # first launch; the cluster's replica identities are known
            # signers, so their grant signatures take the comb kernel.
            shared["cuda"] = CudaBatchVerifier(
                device="cuda", signers=list(config.public_keys.values()), warmup_buckets=(16,)
            )
        return shared["cuda"]
    if args.verifier.startswith("remote:"):
        # Shared verifier service: one mochi_tpu_torch.verifier.service
        # process owns the card; every replica ships its signature batches
        # there.
        from ..verifier.service import RemoteVerifier

        target = args.verifier[len("remote:"):]
        host, _, port = target.rpartition(":")
        if not host or not port.isdigit():
            raise SystemExit(f"--verifier remote:<host>:<port> (got {args.verifier!r})")
        secret = None
        if args.verifier_secret_file:
            from ..verifier.service import load_secret

            secret = load_secret(args.verifier_secret_file)
        from ..verifier.spi import CoalescingVerifier

        # Coalescer: concurrent Write2 certificate checks share one RPC
        # round trip to the service instead of paying one each.
        return CoalescingVerifier(RemoteVerifier(host, int(port), secret=secret))
    if args.verifier != "cpu":
        # No silent fallback: a typo'd --verifier must not quietly run the
        # inline CPU path.
        raise SystemExit(
            f"unknown --verifier {args.verifier!r}: use cuda | cpu | remote:<host>:<port>"
        )
    return None  # replica defaults to the inline CpuVerifier


async def amain(args) -> None:
    config = load_config(args.config)
    if args.require_client_auth and not config.admin_keys:
        # Unrecoverable lockout otherwise: every client is unknown, and
        # registering one requires an authenticated write, which requires
        # being registered — only an admin key breaks the cycle.
        raise SystemExit(
            "--require-client-auth needs config.admin_keys to bootstrap the "
            "client registry (generate with gen_cluster --with-admin)"
        )
    server_ids = args.server_id
    seed_files = args.seed_file
    if len(server_ids) != len(seed_files):
        raise SystemExit(
            f"{len(server_ids)} --server-id but {len(seed_files)} --seed-file "
            "(repeat them pairwise, in order)"
        )
    if len(set(server_ids)) != len(server_ids):
        raise SystemExit(f"duplicate --server-id in {server_ids}")
    byzantine = {}
    for spec in args.byzantine or ():
        sid, sep, strategy = spec.partition("=")
        if not sep or not strategy:
            raise SystemExit(f"--byzantine wants <server-id>=<strategy>, got {spec!r}")
        if sid not in server_ids:
            raise SystemExit(f"--byzantine {spec!r}: {sid} is not hosted here")
        byzantine[sid] = strategy
    if byzantine:
        # validate every strategy before any hosted replica binds a port
        from ..testing.byzantine import make_strategy

        for strategy in byzantine.values():
            try:
                make_strategy(strategy)
            except ValueError as exc:
                raise SystemExit(f"--byzantine: {exc}") from None
    # Graceful SIGTERM/SIGINT: drain first — stop accepting, finish admitted
    # work, flush coalesced writes (bounded by --drain-timeout) — then the
    # close path: peer/RPC teardown and the UDS socket unlink.  Installed
    # before the first READY line, so a supervisor's TERM right after
    # READY still drains.
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    import signal as _signal

    for sig in (_signal.SIGTERM, _signal.SIGINT):
        try:
            loop.add_signal_handler(sig, stop.set)
        except (NotImplementedError, RuntimeError):
            pass  # non-unix / nested-loop environments
    replicas = []
    admins = []
    shared: dict = {}
    for i, (sid, seed_file) in enumerate(zip(server_ids, seed_files)):
        keypair = keypair_from_seed(bytes.fromhex(Path(seed_file).read_text().strip()))
        if keypair.public_key != config.public_keys.get(sid):
            raise SystemExit(
                f"seed file does not match configured public key for {sid}"
            )
        info = config.servers[sid]
        snapshot_path = None
        if args.data_dir:
            snapshot_path = str(Path(args.data_dir) / f"{sid}.snapshot")
        storage = None
        if args.storage_dir:
            # Log-structured durable engine: WAL + snapshots (or pages)
            # under <storage-dir>/<sid>; boot recovery replays through the
            # verified path before READY is printed.
            from ..storage import build_storage

            storage = build_storage(
                args.storage_dir, sid, fsync=args.wal_fsync,
                engine=args.storage_engine,
            )
        replica_cls = MochiReplica
        replica_kwargs = {}
        if sid in byzantine:
            # Fault-injection posture (testing/process_cluster drives this
            # for cross-process adversarial scenarios).
            from ..testing.byzantine import ByzantineReplica

            replica_cls = ByzantineReplica
            replica_kwargs = dict(
                strategy=byzantine[sid], strategy_seed=sum(sid.encode())
            )
        replica = replica_cls(
            server_id=sid,
            config=config,
            keypair=keypair,
            verifier=_build_verifier(args, config, shared),
            require_client_auth=args.require_client_auth,
            host=args.host or info.host,
            port=info.port,
            snapshot_path=snapshot_path,
            snapshot_interval_s=args.snapshot_interval,
            storage=storage,
            # explicit --admission wins; the deprecated --shed-lag-ms alias
            # only applies when the new flag was not passed; default on
            admission=(
                args.admission == "on"
                if args.admission is not None
                else (args.shed_lag_ms is None or args.shed_lag_ms > 0)
            ),
            **replica_kwargs,
        )
        await replica.start()
        replicas.append(replica)
        if args.resync_on_boot:
            # Without durable storage replica state is in-memory (like the
            # reference): after a restart, pull committed state from peers
            # before serving (paper's UptoSpeed); with it, only the delta.
            advanced = await replica.resync()
            logging.info("boot resync: %d objects recovered", advanced)
        if args.admin_port is not None:
            from ..admin import AdminServer

            # Deliberately NOT args.host: --host 0.0.0.0 opens the replica
            # protocol port, but the unauthenticated admin endpoints stay on
            # loopback unless --admin-host explicitly widens them.  Hosted
            # replica i serves its shell on --admin-port + i.
            admin = AdminServer(replica, host=args.admin_host, port=args.admin_port + i)
            await admin.start()
            admins.append(admin)
            logging.info("admin shell for %s on port %s", sid, admin.bound_port)
        logging.info("replica %s serving on %s:%s", sid, replica.rpc.host, replica.bound_port)
        # Machine-readable readiness probe (one line per hosted replica).
        print(f"READY {sid} {replica.bound_port}", flush=True)
    try:
        await stop.wait()
        logging.info("shutdown signal received; draining %s", server_ids)
    finally:
        await asyncio.gather(
            *(r.drain(args.drain_timeout) for r in replicas),
            return_exceptions=True,
        )
        for admin in admins:
            await admin.close()
        closed = []
        for replica in replicas:
            await replica.close()
            v = replica.verifier
            if v is not None and not any(v is c for c in closed):
                closed.append(v)
                await v.close()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter
    )
    parser.add_argument("--config", required=True)
    parser.add_argument(
        "--server-id",
        action="append",
        required=True,
        help="replica identity to host; repeat (with a pairwise --seed-file) "
        "to host several replicas on this process's event loop",
    )
    parser.add_argument(
        "--seed-file",
        action="append",
        required=True,
        help="hex Ed25519 seed for the matching --server-id (same order)",
    )
    parser.add_argument("--host", default=None, help="bind host override (e.g. 0.0.0.0)")
    parser.add_argument(
        "--verifier",
        default="cuda",
        help="cuda (default: the CUDA kernels on the card; exits when there "
        "is none) | cpu (inline host verify) | remote:<host>:<port> (shared "
        "verifier service)",
    )
    parser.add_argument(
        "--verifier-secret-file",
        default=None,
        help="hex shared secret MAC-authenticating the remote verifier RPC "
        "(must match the service's --secret-file)",
    )
    parser.add_argument(
        "--admin-port",
        type=int,
        default=None,
        help="serve the HTTP admin shell (/status, /metrics, /metrics.prom, "
        "/trace) on this port (hosted replica i gets port+i)",
    )
    parser.add_argument(
        "--admin-host",
        default="127.0.0.1",
        help="bind host for the admin shell (kept separate from --host so a "
        "wide replica bind does not expose the unauthenticated admin API)",
    )
    parser.add_argument(
        "--resync-on-boot",
        action="store_true",
        help="pull committed state from peers before serving (UptoSpeed)",
    )
    parser.add_argument(
        "--require-client-auth",
        action="store_true",
        help="reject envelopes from clients with no registered key "
        "(register via the _CONFIG_CLIENT_<id> keyspace, "
        "MochiDBClient.register_client_key; admin-gated when "
        "config.admin_keys is set)",
    )
    parser.add_argument(
        "--data-dir",
        default=None,
        help="persist whole-store state snapshots here (<dir>/<server-id>.snapshot)",
    )
    parser.add_argument(
        "--snapshot-interval",
        type=float,
        default=30.0,
        help="seconds between periodic snapshots (with --data-dir or "
        "--storage-dir)",
    )
    parser.add_argument(
        "--storage-dir",
        default=None,
        help="durable log-structured storage root (WAL + snapshots + "
        "verified crash recovery under <dir>/<server-id>).  Orthogonal to "
        "--data-dir's whole-store snapshots",
    )
    parser.add_argument(
        "--storage-engine",
        choices=("wal", "paged"),
        default=None,
        help="durable engine under --storage-dir (default: "
        "MOCHI_STORAGE_ENGINE or 'wal'): wal = whole-store snapshots, "
        "everything resident; paged = immutable self-certifying value pages "
        "+ bounded resident cache, the keyspace can exceed RAM",
    )
    parser.add_argument(
        "--wal-fsync",
        choices=("always", "group", "off"),
        default=None,
        help="WAL durability policy (default: MOCHI_WAL_FSYNC or 'group'): "
        "always = fsync before every ack (group-committed); group = ack "
        "after the OS write (SIGKILL-safe), fsync on a background tick; "
        "off = no fsync outside snapshot/close",
    )
    parser.add_argument(
        "--admission",
        choices=("on", "off"),
        default=None,  # unset: the deprecated --shed-lag-ms alias may apply
        help="overload admission control (deterministic load signal: "
        "dispatch pressure + verify occupancy + send-queue pressure — "
        "server/admission.py): shed new Write1s with typed OVERLOADED + "
        "retry-after once load exceeds the MOCHI_SHED_* high-water marks "
        "(default on)",
    )
    parser.add_argument(
        "--shed-lag-ms",
        type=float,
        default=None,
        help="DEPRECATED alias for --admission (the wall-clock lag signal "
        "is retired): 0 maps to off, any positive value to on",
    )
    parser.add_argument(
        "--byzantine",
        action="append",
        default=None,
        metavar="SID=STRATEGY",
        help="FAULT INJECTION (testing only): host the named replica as a "
        "ByzantineReplica running the given attack strategy (equivocate | "
        "forge-cert | stale-replay | silent | storm | session-attack) — see "
        "mochi_tpu_torch/testing/byzantine.py",
    )
    parser.add_argument(
        "--drain-timeout",
        type=float,
        default=5.0,
        help="max seconds the SIGTERM/SIGINT drain waits for in-flight "
        "work before the close path cancels the remainder",
    )
    parser.add_argument("--log-level", default="INFO")
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=args.log_level, format="%(asctime)s %(name)s %(levelname)s %(message)s"
    )
    from ..utils.runtime import tune_gc_for_server

    tune_gc_for_server()
    try:
        asyncio.run(amain(args))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
