"""Admin CLI: live cluster reconfiguration (add/remove servers).

Implements the operator side of the paper's configuration-change protocol
(``mochiDB.tex:184-199`` — declared, never built in the reference): evolve
the committed membership document and write it through the normal 2-phase
protocol; every replica installs it on apply.

    # add a server (its seed/pubkey from gen_cluster-style seed file)
    python -m mochi_tpu_torch.tools.reconfigure --config cluster/cluster_config.json \
        --add server-5=127.0.0.1:18106 --pubkey server-5=<hex> --out cluster/cluster_config_v2.json

    # remove one
    python -m mochi_tpu_torch.tools.reconfigure --config cluster/cluster_config.json \
        --remove server-2 --out cluster/cluster_config_v2.json

The new document is committed to the live cluster unless --dry-run.  Boot
the added server with the NEW config file (it resyncs its keys from peers);
removed servers keep answering WRONG_SHARD until decommissioned.
"""

from __future__ import annotations

import argparse
import asyncio
from pathlib import Path

from ..client.client import MochiDBClient
from ..cluster.config import ClusterConfig


async def amain(args) -> None:
    text = Path(args.config).read_text()
    cfg = (
        ClusterConfig.from_json(text)
        if text.lstrip().startswith("{")
        else ClusterConfig.from_properties(text)
    )
    servers = {sid: info.url for sid, info in cfg.servers.items()}
    pubkeys = {}
    added = []
    for spec in args.add or []:
        sid, _, url = spec.partition("=")
        if not url:
            raise SystemExit(f"--add wants server-id=host:port, got {spec!r}")
        servers[sid] = url
        added.append(sid)
    for spec in args.pubkey or []:
        sid, _, hexkey = spec.partition("=")
        pubkeys[sid] = bytes.fromhex(hexkey)
    missing = [sid for sid in added if sid not in pubkeys]
    if missing:
        # A member without a public key could never sign a verifiable grant:
        # its shards would silently run with zero slack over quorum.
        raise SystemExit(
            f"--add requires --pubkey {missing[0]}=<hex> for: {', '.join(missing)}"
        )
    for sid in args.remove or []:
        if sid not in servers:
            raise SystemExit(f"--remove {sid}: not a member")
        del servers[sid]
    new_cfg = cfg.evolve(servers, public_keys=pubkeys, rf=args.rf)
    print(
        f"cs {cfg.configstamp} -> {new_cfg.configstamp}: "
        f"{sorted(cfg.servers)} -> {sorted(new_cfg.servers)}"
    )
    if args.out:
        Path(args.out).write_text(new_cfg.to_json())
        print(f"wrote {args.out}")
    if args.dry_run:
        return
    if args.seed_file:
        from ..crypto.keys import keypair_from_seed

        kp = keypair_from_seed(bytes.fromhex(Path(args.seed_file).read_text().strip()))
        client = MochiDBClient(config=cfg, keypair=kp)
    else:
        if cfg.admin_keys:
            raise SystemExit(
                "this cluster gates reconfiguration on admin keys; pass "
                "--seed-file with an admin seed"
            )
        client = MochiDBClient(config=cfg)
    try:
        await client.reconfigure_cluster(new_cfg)
        print("committed to cluster")
    finally:
        await client.close()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", required=True, help="current cluster config file")
    parser.add_argument("--add", action="append", help="server-id=host:port")
    parser.add_argument("--remove", action="append", help="server-id")
    parser.add_argument("--pubkey", action="append", help="server-id=<hex ed25519 pubkey>")
    parser.add_argument("--rf", type=int, default=None, help="new replication factor")
    parser.add_argument("--out", default=None, help="write the new config file here")
    parser.add_argument(
        "--seed-file",
        default=None,
        help="hex Ed25519 seed of an admin key (required when the cluster "
        "sets config.admin_keys)",
    )
    parser.add_argument("--dry-run", action="store_true")
    args = parser.parse_args(argv)
    asyncio.run(amain(args))


if __name__ == "__main__":
    main()
