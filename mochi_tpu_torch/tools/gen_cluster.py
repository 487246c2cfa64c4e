"""Generate a cluster config + per-server Ed25519 key seeds.

Ops-layer equivalent of the reference's bootstrap path (``start_mochi.sh`` +
``putTokensAroundRingProps``, ``ClusterConfiguration.java:85-116``), extended
with the key material the reference never had.

Usage:
    python -m mochi_tpu_torch.tools.gen_cluster --out-dir cluster/ \
        --servers 5 --rf 4 --base-port 8001 [--host 127.0.0.1] [--format json]

Writes ``<out-dir>/cluster_config.{json,properties}`` and one
``<out-dir>/<server-id>.seed`` (hex, 0600) per server.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

from ..cluster.config import ClusterConfig
from ..crypto.keys import generate_keypair


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--out-dir", required=True)
    parser.add_argument("--servers", type=int, default=5)
    parser.add_argument("--rf", type=int, default=4)
    parser.add_argument("--base-port", type=int, default=8001)
    parser.add_argument(
        "--host",
        default="127.0.0.1",
        help="bind host for every server, OR a comma-separated host list "
        "assigned round-robin for a cross-host cluster (the reference's "
        "5-EC2-host shape) — e.g. "
        "--host host-a,host-b,host-c,host-d,host-e",
    )
    parser.add_argument("--format", choices=("json", "properties"), default="json")
    parser.add_argument(
        "--uds",
        action="store_true",
        help="address servers by Unix-domain socket (<out-dir>/<sid>.sock) "
        "instead of TCP — single-host clusters skip the loopback TCP/IP "
        "stack on the kernel send path (mutually exclusive with a "
        "multi-host --host list)",
    )
    parser.add_argument(
        "--with-admin",
        action="store_true",
        help="also generate an admin keypair (admin.seed) and pin its public "
        "key in config.admin_keys — required for the secure posture "
        "(reconfiguration + client-registry writes become admin-gated; "
        "pairs with the server's --require-client-auth)",
    )
    args = parser.parse_args(argv)

    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)

    server_ids = [f"server-{i}" for i in range(args.servers)]
    keypairs = {sid: generate_keypair() for sid in server_ids}
    hosts = args.host.split(",")
    if args.uds:
        if args.host != parser.get_default("host"):
            raise SystemExit(
                "--uds is single-host via socket paths; drop --host "
                f"(got {args.host!r})"
            )
        paths = {sid: (out / (sid + ".sock")).resolve() for sid in server_ids}
        too_long = [p for p in paths.values() if len(str(p)) > 100]
        if too_long:
            # AF_UNIX sun_path caps at ~108 bytes; failing here beats every
            # server dying at bind with a raw OSError
            raise SystemExit(
                f"--out-dir too deep for AF_UNIX socket paths (>100 chars): "
                f"{too_long[0]}"
            )
        urls = {sid: f"unix:{p}:0" for sid, p in paths.items()}
    else:
        urls = {
            # round-robin across hosts; ports advance only when a host wraps,
            # so every host runs the same well-known port where possible
            sid: f"{hosts[i % len(hosts)]}:{args.base_port + i // len(hosts)}"
            if len(hosts) > 1
            else f"{hosts[0]}:{args.base_port + i}"
            for i, sid in enumerate(server_ids)
        }
    config = ClusterConfig.build(
        urls,
        rf=args.rf,
        public_keys={sid: kp.public_key for sid, kp in keypairs.items()},
    )
    if args.with_admin:
        admin = generate_keypair()
        config.admin_keys.append(admin.public_key)
        admin_path = out / "admin.seed"
        admin_path.write_text(admin.private_seed.hex())
        os.chmod(admin_path, 0o600)

    if args.format == "json":
        path = out / "cluster_config.json"
        path.write_text(config.to_json())
    else:
        path = out / "cluster_config.properties"
        path.write_text(config.to_properties())
    for sid, kp in keypairs.items():
        seed_path = out / f"{sid}.seed"
        seed_path.write_text(kp.private_seed.hex())
        os.chmod(seed_path, 0o600)
    print(f"wrote {path} and {len(server_ids)} key seeds to {out}/")


if __name__ == "__main__":
    main()
