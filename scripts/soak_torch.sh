#!/usr/bin/env bash
# Long-running scenario soak of the PyTorch/CUDA port (mochi_tpu_torch).
#
# Drives the deterministic scenario engine over a wide seed range: each
# seed draws a full scenario (topology incl. durable-WAL posture, netsim
# mesh, ordered fault legs, workload mix) and runs it on the seeded
# ExplorerLoop with the InvariantChecker sampling.  Zero violations is the
# pass verdict; any failing seed is a complete reproduction:
#
#   python -m mochi_tpu_torch.testing.scenario repro --seed N --minimize out.json
#
# Usage:
#   scripts/soak_torch.sh [COUNT] [START] [WORKERS]
#
#   COUNT    seeds to run             (default 1000)
#   START    first seed               (default 0)
#   WORKERS  parallel worker procs    (default: cores, capped at 4)
#
# MOCHI_SOAK_VERIFIER (cuda by default: one CudaBatchVerifier a run, which
# needs the card; cpu when asked) chooses the runs' verifier.  Writes the
# summary JSON to build/soak_torch_<START>_<COUNT>.json.

set -euo pipefail
cd "$(dirname "$0")/.."

COUNT="${1:-1000}"
START="${2:-0}"
CORES="$(nproc 2>/dev/null || echo 2)"
WORKERS="${3:-$(( CORES < 4 ? CORES : 4 ))}"
VERIFIER="${MOCHI_SOAK_VERIFIER:-cuda}"
mkdir -p build
OUT="build/soak_torch_${START}_${COUNT}.json"

echo "scenario soak: seeds ${START}..$(( START + COUNT - 1 )), ${WORKERS} workers, verifier ${VERIFIER} -> ${OUT}" >&2
exec python -m mochi_tpu_torch.testing.scenario soak \
    --count "${COUNT}" --start "${START}" --workers "${WORKERS}" \
    --verifier "${VERIFIER}" --out "${OUT}"
