"""Write a cluster's signers file: one hex Ed25519 public key a line.

Usage: python scripts/write_signers_torch.py OUT_DIR

Reads ``OUT_DIR/cluster_config.json`` (``python -m
mochi_tpu_torch.tools.gen_cluster``) and writes ``OUT_DIR/signers.txt``, the
replica identities in server-id order, each with its id as a comment: the
``--signers-file`` of ``python -m mochi_tpu_torch.verifier.service``, whose
comb kernel then carries the replicas' grant signatures.
"""

import json
import sys
from pathlib import Path


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    out = Path(argv[0])
    doc = json.loads((out / "cluster_config.json").read_text())
    lines = [f"{hexkey}  # {sid}\n" for sid, hexkey in sorted(doc.get("public_keys", {}).items())]
    (out / "signers.txt").write_text("".join(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
