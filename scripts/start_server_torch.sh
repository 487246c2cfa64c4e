#!/usr/bin/env bash
# Start a single replica of the PyTorch/CUDA port (mochi_tpu_torch).
#
# Usage: scripts/start_server_torch.sh CONFIG SERVER_ID SEED_FILE [extra args...]
#
# The replica verifies on the card by default (--verifier cuda) and exits
# non-zero without one; pass --verifier cpu or remote:<host>:<port> to
# choose otherwise.
set -euo pipefail
REPO_DIR=$(cd "$(dirname "$0")/.." && pwd)
export PYTHONPATH="${REPO_DIR}${PYTHONPATH:+:$PYTHONPATH}"
CONFIG=$1; SERVER_ID=$2; SEED=$3; shift 3
exec python -m mochi_tpu_torch.server \
  --config "$CONFIG" --server-id "$SERVER_ID" --seed-file "$SEED" "$@"
