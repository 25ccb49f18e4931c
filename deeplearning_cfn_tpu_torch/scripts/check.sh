#!/usr/bin/env bash
# The port's gate: the counterpart of scripts/check.sh, stage for stage,
# over deeplearning_cfn_tpu_torch.  One gate, two halves: the repo-native
# lint pass (dlcfn lint with every gated pass on, ratcheted against the
# port's baseline, deeplearning_cfn_tpu_torch/analysis/lint_baseline.json)
# then the dynamic gates (chaos, the gauntlet, the SLO rule schema,
# perf-smoke, the compile, comms and replay audits) and the port's tier-1
# tests.  Everything runs on the CPU (--device cpu where a command takes
# one), as scripts/check.sh runs on virtual CPU devices.
#
# Left out: scripts/check.sh's warn-only "bench trajectory" stage
# (scripts/bench_compare.py over the BENCH_*.json rounds), which belongs
# to the port's benchmark, not yet built.
#
#   bash deeplearning_cfn_tpu_torch/scripts/check.sh
#
# Reports go to a fresh directory under $TMPDIR, named on stdout.
set -uo pipefail
cd "$(dirname "$0")/../.."
PY="${PYTHON:-python3}"
DLCFN="$PY -m deeplearning_cfn_tpu_torch.cli"
OUT="$(mktemp -d "${TMPDIR:-/tmp}/dlcfn-torch-check.XXXXXX")"
echo "reports: $OUT"
stage_start=$SECONDS
took() { echo "   ($1: $((SECONDS - stage_start)) s)"; stage_start=$SECONDS; }

echo "== dlcfn lint (full: --concurrency --protocol --sharding --comms --determinism, baselined) =="
$DLCFN lint --concurrency --protocol --sharding --comms --determinism --baseline || exit 1
took lint

echo "== chaos scenarios (seeded, virtual-clock — docs/RESILIENCE.md) =="
# --all includes the training scenarios (slice-loss-live, data-reshard-live,
# sched-flash-crowd, the gauntlet), which run four gloo rank processes on
# the CPU, and serve-replica-loss, which kills a serving replica
# mid-traffic and asserts zero lost accepted requests plus the p99 latency
# SLO.  broker-failover runs the 1k-agent warm-standby soak and
# split-brain proves epoch fencing rejects every stale-primary write.
$DLCFN chaos --all --seed 0 --device cpu > "$OUT/chaos.json" || { cat "$OUT/chaos.json"; exit 1; }
"$PY" - "$OUT/chaos.json" <<'EOF' || exit 1
# --all is dynamic, so pin the gates scripts/check.sh pins: the serving SLO
# scenario, the control-plane failover pair, the sharded fleet's failover
# and its re-provision ladder, the telemetry/alerting gate, the data-plane
# gate, the multi-tenancy gate and the composed incident.
import json
import sys

reports = json.load(open(sys.argv[1]))
names = {r["scenario"] for r in reports}
for required in ("serve-replica-loss", "broker-failover", "split-brain",
                 "shard-failover", "degraded-pair-heal",
                 "alert-storm", "data-reshard-live", "sched-flash-crowd",
                 "gauntlet"):
    assert required in names, f"{required} missing from {sorted(names)}"
EOF
echo "chaos: all scenarios held their invariants (report: $OUT/chaos.json)"
took chaos

echo "== chaos gauntlet (composed multi-fault incident + seeded sweep) =="
# The pinned 3-fault schedule (slice loss mid-epoch, broker shard failover
# in the same reshard pause, writer crash mid-manifest) must hold every
# cross-subsystem invariant, then a small seeded sweep perturbs fault
# timing and ordering and shrinks any failure to a minimal reproducer.
timeout -k 10 420 $DLCFN gauntlet --seed 0 --device cpu \
  > "$OUT/gauntlet.json" || { cat "$OUT/gauntlet.json"; exit 1; }
timeout -k 10 420 $DLCFN gauntlet --sweep 4 --seed 100 --device cpu \
  > "$OUT/gauntlet_sweep.json" || { cat "$OUT/gauntlet_sweep.json"; exit 1; }
echo "gauntlet: pinned incident + 4-seed sweep held every cross-subsystem invariant (reports: $OUT/gauntlet.json, $OUT/gauntlet_sweep.json)"
took gauntlet

echo "== SLO rule schema (obs/slo.py DEFAULT_RULES vs METRIC_REGISTRY) =="
# Every shipped alert rule must parse and reference a registered exporter
# family: a rule over a typo'd metric would silently never fire.
"$PY" - <<'EOF' || exit 1
from deeplearning_cfn_tpu_torch.obs.slo import validate_rules

errors = validate_rules()
for e in errors:
    print(f"slo-schema: {e}")
assert not errors, f"{len(errors)} invalid SLO rule(s)"
EOF
echo "slo-schema: all default rules valid against the metric registry"
took slo-schema

echo "== perf-smoke (twelve structural stages) =="
# The comms stages run the comms audit's two gloo ranks against the
# committed budget (deeplearning_cfn_tpu_torch/analysis/comms_budget.json).
"$PY" -m deeplearning_cfn_tpu_torch.scripts.perf_smoke --device cpu \
  > "$OUT/perf_smoke.json" || exit 1
echo "perf-smoke: every stage held (report: $OUT/perf_smoke.json)"
took perf-smoke

echo "== compile-audit sentinel (steady-state zero-recapture + donation) =="
# The real Trainer.fit() and multi-step path on the CPU: any capture or
# build after warmup (DLC410) or a step donating zero bytes (DLC411) fails
# here unless baselined.
"$PY" -m deeplearning_cfn_tpu_torch.analysis.compile_audit --device cpu \
  > "$OUT/compile_audit.json" || { cat "$OUT/compile_audit.json"; exit 1; }
echo "compile-audit: steady state builds nothing, donation effective (report: $OUT/compile_audit.json)"
took compile-audit

echo "== comms-audit sentinel (collective + memory budget + overlap ratchet) =="
# The real fsdp train step, the multi-step call, serve decode and the dp
# comms-overlap pair on two gloo ranks: collective bytes/count over the
# committed budget (DLC510), an all-gather fsdp doesn't predict (DLC511),
# or an overlap_score below the committed number / a *_overlap program not
# strictly beating its monolithic baseline (DLC512) fails here unless
# baselined.
"$PY" -m deeplearning_cfn_tpu_torch.analysis.comms_audit --device cpu \
  > "$OUT/comms_audit.json" || { cat "$OUT/comms_audit.json"; exit 1; }
echo "comms-audit: collective/memory budgets within ratchet (report: $OUT/comms_audit.json)"
took comms-audit

echo "== replay-audit sentinel (double-run byte-determinism per seed) =="
# Every registered chaos scenario plus soak_failover/soak_fleet runs twice
# per seed in-process; canonical report bytes must match exactly.  A
# divergence is DLC610 with the first-divergence path and fails here
# unless baselined.
"$PY" -m deeplearning_cfn_tpu_torch.analysis.replay_audit --device cpu \
  > "$OUT/replay_audit.json" || { cat "$OUT/replay_audit.json"; exit 1; }
echo "replay-audit: every scenario and soak byte-identical across double runs (report: $OUT/replay_audit.json)"
took replay-audit

echo "== tier-1 tests (the port's: tests/test_torch_*.py) =="
# The port's tests hold it to the JAX package on the CPU; xdist's six
# workers take a file each.
timeout -k 10 1470 env JAX_PLATFORMS=cpu "$PY" -m pytest tests/test_torch_*.py -q \
  -m 'not slow' --continue-on-collection-errors -p no:cacheprovider \
  -p xdist -n 6 --dist loadfile -p no:randomly 2>&1 \
  | tee "$OUT/tier1.log"
rc=${PIPESTATUS[0]}
echo "DOTS_PASSED=$(grep -aE '^[.FEsx]+( *\[ *[0-9]+%\])?$' "$OUT/tier1.log" | tr -cd . | wc -c)"
took tier-1
exit "$rc"
