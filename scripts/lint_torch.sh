#!/usr/bin/env bash
# The port's static analysis (python -m mochi_tpu_torch.analysis) over its
# tree (mochi_tpu_torch/, chip_smoke.py) and the Python of its operator
# scripts (scripts/*_torch.py), against config/analysis_baseline_torch.json.
#
# Usage: scripts/lint_torch.sh [GIT_REF]
#   no ref -> full-strict: any finding not in the baseline exits 1 (fix it
#             or add a justified `# mochi-lint: disable=<rule> -- why`
#             suppression; do not re-baseline).
#   REF    -> diff-aware strict: findings in files changed vs REF exit 1;
#             findings in untouched files print as warnings and exit 0.
set -euo pipefail
cd "$(dirname "$0")/.."
PATHS=(mochi_tpu_torch/ chip_smoke.py scripts/*_torch.py)
BASELINE=(--baseline config/analysis_baseline_torch.json)
if [ $# -ge 1 ]; then
  exec python -m mochi_tpu_torch.analysis "${PATHS[@]}" "${BASELINE[@]}" --changed-only "$1"
fi
exec python -m mochi_tpu_torch.analysis "${PATHS[@]}" "${BASELINE[@]}"
