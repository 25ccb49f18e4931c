"""The dynamic replay sentinel: byte-determinism, proven by running twice.

The DLC6xx static rules (analysis/determinism.py) catch the *source
patterns* that tend to break per-seed determinism; this module measures
the property itself.  It runs every registered chaos scenario and both
fleet soaks (``soak_failover``, ``soak_fleet``) **twice per seed,
in-process**, canonicalizes each report to sorted-key compact JSON, and
diffs the bytes.  Any mismatch becomes a DLC610 violation carrying the
first-divergence path (``$.details.rounds[3].detected`` style), flowing
through the same suppression-baseline ratchet as the DLC41x compile
audit and DLC51x comms audit (analysis/lint_baseline.json, namespace-
scoped via ``runner.apply_audit_baseline``), and results are journaled
to the flight recorder as ``replay_audit`` events.

The port's catalog runs some scenarios' trainers and engines on a
device: ``default_cases(device=...)`` hands it to them (``"cuda"`` by
default, as every entry point of the port), and ``spawns_ranks`` names
the four that start rank processes.

Double-running in one process is deliberately the *weakest* replay (same
PYTHONHASHSEED, same import order, same allocator state): anything that
diverges here is unconditionally broken, with no environmental excuse —
the cheapest-to-debug form of the failure.  Cross-process and
cross-machine stability layer on top of this gate, not instead of it.

Canonicalization never sorts *data* — only dict keys, which Python
already guarantees an order for.  Sorting lists here would hide exactly
the enumeration-order bugs DLC600/DLC602 exist to catch; a list whose
order flips between runs must surface as a divergence.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Iterable, Sequence

from deeplearning_cfn_tpu_torch.analysis.core import Violation
from deeplearning_cfn_tpu_torch.analysis.determinism import AUDIT_RULE_REPLAY

REPO_ROOT = Path(__file__).resolve().parents[2]
# Findings anchor on the file that owns the replayed program (baseline
# key is (rule, repo-relative path, message) — same contract as DLC41x).
SCENARIO_AUDITED_FILE = (
    REPO_ROOT / "deeplearning_cfn_tpu_torch" / "chaos" / "scenarios.py"
)
SOAK_AUDITED_FILE = (
    REPO_ROOT / "deeplearning_cfn_tpu_torch" / "analysis" / "schedules.py"
)

DEFAULT_SEEDS = (0,)


def _jsonable(obj: Any) -> Any:
    """Canonical fallback for non-JSON leaves (numpy scalars, Paths).

    ``str()`` — not a sort, not a normalization: if a leaf's repr is
    unstable (a set, an object with a default repr carrying ``id()``),
    the instability must reach the byte diff, not be papered over.
    """
    item = getattr(obj, "item", None)
    if callable(item):
        return item()
    return str(obj)


def canonicalize(report: Any) -> bytes:
    """One report -> canonical bytes: sorted keys, compact separators.

    Two calls on equal structures always agree, so every byte of
    difference between two runs is a difference in the *data*.
    """
    return json.dumps(
        report,
        sort_keys=True,
        separators=(",", ":"),
        default=_jsonable,
    ).encode()


def first_divergence(a: Any, b: Any, path: str = "$") -> str | None:
    """JSONPath-ish pointer to the first leaf where two structures differ.

    Dicts are walked in sorted-key order (matching :func:`canonicalize`),
    lists positionally; a missing key or a length mismatch is itself the
    divergence.  Returns None when the structures are equal.
    """
    if type(a) is not type(b) and not (
        isinstance(a, (int, float)) and isinstance(b, (int, float))
    ):
        return path
    if isinstance(a, dict):
        for k in sorted(set(a) | set(b)):
            sub = f"{path}.{k}"
            if k not in a or k not in b:
                return sub
            hit = first_divergence(a[k], b[k], sub)
            if hit is not None:
                return hit
        return None
    if isinstance(a, list):
        for i, (x, y) in enumerate(zip(a, b)):
            hit = first_divergence(x, y, f"{path}[{i}]")
            if hit is not None:
                return hit
        if len(a) != len(b):
            return f"{path}[{min(len(a), len(b))}]"
        return None
    return None if a == b else path


@dataclass(frozen=True)
class ReplayCase:
    """One replayable program: a name, a kind, and seed -> report."""

    name: str
    kind: str  # "scenario" | "soak"
    run: Callable[[int], Any]
    audited_file: str


# The scenarios whose runs start rank processes (a replay of those is a
# rank-process run twice; chip_smoke phase 22 replays the gauntlet).
SPAWNING_SCENARIOS = ("data-reshard-live", "gauntlet", "sched-flash-crowd", "slice-loss-live")


def spawns_ranks(name: str) -> bool:
    return name in SPAWNING_SCENARIOS


def default_cases(
    scenarios: Iterable[str] | None = None, soaks: bool = True, device: str = "cuda"
) -> list[ReplayCase]:
    """Every registered chaos scenario (sorted) plus both fleet soaks;
    trainers and engines of a scenario run on ``device``."""
    from deeplearning_cfn_tpu_torch.chaos.scenarios import SCENARIOS, run_scenario

    names = sorted(SCENARIOS) if scenarios is None else list(scenarios)

    def _scenario_case(name: str) -> ReplayCase:
        return ReplayCase(
            name=name,
            kind="scenario",
            run=lambda seed: run_scenario(name, seed, device).to_dict(),
            audited_file=str(SCENARIO_AUDITED_FILE),
        )

    cases = [_scenario_case(n) for n in names]
    if soaks:
        from deeplearning_cfn_tpu_torch.analysis.schedules import (
            soak_failover,
            soak_fleet,
        )

        cases.append(
            ReplayCase(
                name="soak_failover",
                kind="soak",
                run=lambda seed: soak_failover(seed=seed),
                audited_file=str(SOAK_AUDITED_FILE),
            )
        )
        cases.append(
            ReplayCase(
                name="soak_fleet",
                kind="soak",
                run=lambda seed: soak_fleet(seed=seed),
                audited_file=str(SOAK_AUDITED_FILE),
            )
        )
    return cases


@dataclass(frozen=True)
class CaseReplay:
    """One (case, seed) double-run outcome."""

    name: str
    kind: str
    seed: int
    identical: bool
    nbytes: int
    divergence: str | None

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "kind": self.kind,
            "seed": self.seed,
            "identical": self.identical,
            "nbytes": self.nbytes,
            "divergence": self.divergence,
        }


@dataclass
class ReplayAuditReport:
    replays: list[CaseReplay]
    violations: list[Violation]
    seeds: tuple[int, ...]

    def to_dict(self) -> dict:
        return {
            "replays": [r.to_dict() for r in self.replays],
            "violations": [v.to_dict() for v in self.violations],
            "seeds": list(self.seeds),
            "cases": len({r.name for r in self.replays}),
            "divergent": sorted(
                {r.name for r in self.replays if not r.identical}
            ),
            "clean": not self.violations,
        }


def _violation_for(case: ReplayCase, replay: CaseReplay) -> Violation:
    return Violation(
        rule=AUDIT_RULE_REPLAY,
        path=case.audited_file,
        line=1,
        col=1,
        message=(
            f"replay divergence: {case.kind} '{case.name}' at seed "
            f"{replay.seed} produced different report bytes across two "
            "in-process runs (first divergence at "
            f"{replay.divergence}) — the per-seed determinism contract "
            "every chaos gate and soak asserts is broken (replay-audit "
            "sentinel; see docs/STATIC_ANALYSIS.md replay runbook)"
        ),
    )


def run_replay_audit(
    cases: Sequence[ReplayCase] | None = None,
    seeds: Sequence[int] = DEFAULT_SEEDS,
    journal: bool = True,
) -> ReplayAuditReport:
    """Double-run every case at every seed and diff canonical bytes.

    Pure in-process re-execution — the scenarios and soaks all run on
    virtual clocks and seeded RNGs, so the audit's wall time is just two
    passes of the programs themselves.
    """
    case_list = default_cases() if cases is None else list(cases)
    replays: list[CaseReplay] = []
    violations: list[Violation] = []
    for case in case_list:
        for seed in seeds:
            first = canonicalize(case.run(seed))
            second = canonicalize(case.run(seed))
            identical = first == second
            divergence = None
            if not identical:
                divergence = (
                    first_divergence(json.loads(first), json.loads(second))
                    or "$"
                )
            replay = CaseReplay(
                name=case.name,
                kind=case.kind,
                seed=int(seed),
                identical=identical,
                nbytes=len(first),
                divergence=divergence,
            )
            replays.append(replay)
            if not identical:
                violations.append(_violation_for(case, replay))
    report = ReplayAuditReport(
        replays=replays, violations=violations, seeds=tuple(seeds)
    )
    if journal:
        from deeplearning_cfn_tpu_torch.obs.recorder import get_recorder

        get_recorder().record(
            "replay_audit",
            clean=not violations,
            cases=len(case_list),
            seeds=[int(s) for s in seeds],
            divergent=sorted({r.name for r in replays if not r.identical}),
        )
    return report


def main(argv: list[str] | None = None) -> int:
    """``python -m deeplearning_cfn_tpu_torch.analysis.replay_audit
    [--device cpu] [--no-ranks] [--no-soaks | --soaks-only]``: double-run
    the catalog and both soaks (``--no-ranks``: not the scenarios that
    start rank processes; the soaks or the scenarios alone, so two
    processes can share the work); print the report, exit 1 on findings
    the baseline does not hold."""
    import argparse

    from deeplearning_cfn_tpu_torch.analysis.determinism import AUDIT_RULE_IDS
    from deeplearning_cfn_tpu_torch.analysis.runner import apply_audit_baseline

    ap = argparse.ArgumentParser(prog="replay_audit")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-ranks", action="store_true", dest="no_ranks")
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--no-soaks", action="store_true", dest="no_soaks")
    which.add_argument("--soaks-only", action="store_true", dest="soaks_only")
    args = ap.parse_args(argv)
    cases = [c for c in default_cases(device=args.device, soaks=not args.no_soaks)
             if not (args.no_ranks and spawns_ranks(c.name))
             and not (args.soaks_only and c.kind != "soak")]
    report = run_replay_audit(cases=cases)
    fresh, stale = apply_audit_baseline(report.violations, None, AUDIT_RULE_IDS)
    print(json.dumps({**report.to_dict(), "fresh": [v.to_dict() for v in fresh],
                      "stale": [list(e) for e in stale]}, indent=2))
    return 1 if fresh else 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
