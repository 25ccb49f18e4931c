#!/usr/bin/env bash
# The port's dlcfn-lint entry: the repo-native static-analysis pass over
# deeplearning_cfn_tpu_torch/ and chip_smoke.py (the port's rules, its
# ratchet in deeplearning_cfn_tpu_torch/analysis/lint_baseline.json).
# Exit 1 on any finding, including broker-contract drift (DLC100/101).
# Opt-in passes: --concurrency (DLC2xx), --protocol (DLC3xx),
# --sharding (DLC4xx capture safety), --comms (DLC5xx),
# --determinism (DLC6xx), --baseline [PATH].
# --json is shorthand for --format json (machine-readable findings).
set -euo pipefail
cd "$(dirname "$0")/../.."
args=()
for a in "$@"; do
  if [[ "$a" == "--json" ]]; then
    args+=(--format json)
  else
    args+=("$a")
  fi
done
exec "${PYTHON:-python3}" -m deeplearning_cfn_tpu_torch.cli lint "${args[@]+"${args[@]}"}"
