#!/usr/bin/env bash
# Launch a local cluster of the PyTorch/CUDA port (mochi_tpu_torch).
#
# Usage: scripts/start_cluster_torch.sh [N_SERVERS] [RF] [BASE_PORT] [OUT_DIR]
#
# MOCHI_VERIFIER chooses how each replica verifies certificates:
#   cuda (default)  every replica runs --verifier cuda: the card, with the
#                   cluster's identities on the comb kernel.  Without a card
#                   each replica exits non-zero at boot, and so does this
#                   script.
#   remote          boot ONE python -m mochi_tpu_torch.verifier.service
#                   (--backend ${MOCHI_VERIFIER_BACKEND:-cuda}) that owns the
#                   card, with a shared secret, the identities as its signers
#                   and an admin port, and point every replica at it.
#   cpu             host verification in each replica; only when asked.
#   remote:<host>:<port>  an existing service.
#
# Stop the cluster with SIGINT or SIGTERM to this script (or its process
# group): it stops every child it started and exits 0.
set -euo pipefail

N=${1:-5}
RF=${2:-4}
BASE_PORT=${3:-8101}
OUT=${4:-./cluster}
REPO_DIR=$(cd "$(dirname "$0")/.." && pwd)

export PYTHONPATH="${REPO_DIR}${PYTHONPATH:+:$PYTHONPATH}"

if [ ! -f "$OUT/cluster_config.json" ]; then
  python -m mochi_tpu_torch.tools.gen_cluster \
    --out-dir "$OUT" --servers "$N" --rf "$RF" --base-port "$BASE_PORT"
fi

mkdir -p "$OUT/log"
PIDS=()
LOGS=()
stop() {
  kill "${PIDS[@]}" 2>/dev/null || true
  wait 2>/dev/null || true
}
trap 'stop; exit 130' INT
trap 'stop; exit 143' TERM

VERIFIER="${MOCHI_VERIFIER:-cuda}"
SECRET_ARGS=()
if [ "$VERIFIER" = "remote" ]; then
  VPORT=$((BASE_PORT + 2000))
  # Shared secret authenticating the verify RPC both ways (the responses
  # are verdicts; see verifier/service.py's trust model).
  if [ ! -f "$OUT/verifier.secret" ]; then
    (umask 077 && python -c "import os; print(os.urandom(32).hex())" > "$OUT/verifier.secret")
  fi
  chmod 600 "$OUT/verifier.secret"
  # The replica identities are the service's known signers: their grant
  # signatures take the comb kernel.
  python "$REPO_DIR/scripts/write_signers_torch.py" "$OUT"
  python -m mochi_tpu_torch.verifier.service --port "$VPORT" \
    --backend "${MOCHI_VERIFIER_BACKEND:-cuda}" \
    --secret-file "$OUT/verifier.secret" \
    --signers-file "$OUT/signers.txt" \
    --admin-port $((VPORT + 1)) \
    >"$OUT/log/verifier.log" 2>&1 &
  VPID=$!
  PIDS+=("$VPID")
  LOGS+=("$OUT/log/verifier.log")
  for _ in $(seq 1 300); do
    grep -q READY "$OUT/log/verifier.log" 2>/dev/null && break
    if ! kill -0 "$VPID" 2>/dev/null; then
      echo "verifier service exited before READY:" >&2
      tail -n 20 "$OUT/log/verifier.log" >&2
      stop
      exit 1
    fi
    sleep 1
  done
  if ! grep -q READY "$OUT/log/verifier.log" 2>/dev/null; then
    echo "verifier service not READY after 300 s" >&2
    stop
    exit 1
  fi
  VERIFIER="remote:127.0.0.1:$VPORT"
  SECRET_ARGS=(--verifier-secret-file "$OUT/verifier.secret")
fi

for i in $(seq 0 $((N - 1))); do
  python -m mochi_tpu_torch.server \
    --config "$OUT/cluster_config.json" \
    --server-id "server-$i" \
    --seed-file "$OUT/server-$i.seed" \
    --admin-port $((BASE_PORT + 1000 + i)) \
    --verifier "$VERIFIER" \
    ${SECRET_ARGS[@]+"${SECRET_ARGS[@]}"} \
    >"$OUT/log/server-$i.log" 2>&1 &
  PIDS+=($!)
  LOGS+=("$OUT/log/server-$i.log")
done

echo "cluster of $N replicas starting (rf=$RF, verifier $VERIFIER); logs in $OUT/log/"
echo "stop with: kill -INT $$"
# SIGINT or SIGTERM stops every child and exits 0.  Any child that exits
# on its own (a replica refused to boot, the service died) stops the
# cluster and fails the script with that child's code, after the end of
# the log of every child that had exited.
STOPPED=0
trap 'STOPPED=1' INT TERM
set +e
wait -n
rc=$?
if [ "$STOPPED" = 1 ]; then
  stop
  echo "cluster stopped" >&2
  exit 0
fi
for i in "${!PIDS[@]}"; do
  if ! kill -0 "${PIDS[$i]}" 2>/dev/null; then
    echo "== ${LOGS[$i]} (exited):" >&2
    tail -n 5 "${LOGS[$i]}" >&2
  fi
done
stop
[ "$rc" -eq 0 ] && rc=1
echo "a child of the cluster exited (code $rc); stopped the others" >&2
exit "$rc"
