"""File discovery + orchestration for ``python -m deeplearning_cfn_tpu_torch.cli lint``."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterable, Iterator

# Importing rule modules registers them in core.FILE_RULES.
import deeplearning_cfn_tpu_torch.analysis.collectives as collectives_rules
import deeplearning_cfn_tpu_torch.analysis.concurrency as concurrency_rules
import deeplearning_cfn_tpu_torch.analysis.determinism as determinism_rules
import deeplearning_cfn_tpu_torch.analysis.rules  # noqa: F401
import deeplearning_cfn_tpu_torch.analysis.sharding as sharding_rules
from deeplearning_cfn_tpu_torch.analysis import contract_check, protocol
from deeplearning_cfn_tpu_torch.analysis.core import FILE_RULES, Violation, lint_source

REPO_ROOT = Path(__file__).resolve().parents[2]
DEFAULT_TARGETS = ("deeplearning_cfn_tpu_torch", "chip_smoke.py")
DEFAULT_BASELINE = Path(__file__).resolve().parent / "lint_baseline.json"
_SKIP_DIRS = {"__pycache__", ".git", ".pytest_cache", "build", "dist"}

PROTOCOL_RULE_IDS = (
    protocol.RULE_REQUEST,
    protocol.RULE_REPLY,
    protocol.RULE_FRAME,
    protocol.RULE_LIFECYCLE,
)

# Rules only the dynamic sentinels (analysis/compile_audit.py,
# comms_audit.py, replay_audit.py) can produce.  Their baseline entries
# share analysis/lint_baseline.json with the static pass, so static lint
# must never call them stale — it cannot observe their findings at all.
DYNAMIC_AUDIT_RULE_IDS = (
    tuple(sharding_rules.AUDIT_RULE_IDS)
    + tuple(collectives_rules.AUDIT_RULE_IDS)
    + tuple(determinism_rules.AUDIT_RULE_IDS)
)


def discover(targets: Iterable[str | Path], root: Path = REPO_ROOT) -> Iterator[Path]:
    for target in targets:
        p = Path(target)
        if not p.is_absolute():
            p = root / p
        if p.is_file() and p.suffix == ".py":
            yield p
        elif p.is_dir():
            # Skip build trees inside the target, not a target that itself
            # lies under a directory named build (a checkout unpacked there).
            yield from sorted(
                f
                for f in p.rglob("*.py")
                if not any(part in _SKIP_DIRS for part in f.relative_to(p).parts)
            )


def run_lint(
    targets: Iterable[str | Path] | None = None,
    select: set[str] | None = None,
    root: Path = REPO_ROOT,
    contract: bool = True,
    concurrency: bool = False,
    protocol_pass: bool = False,
    sharding: bool = False,
    comms: bool = False,
    determinism: bool = False,
) -> list[Violation]:
    """Lint the given targets (repo defaults when None).

    ``select`` limits per-file rules to specific ids; the DLC1xx contract
    checker runs unless ``contract=False`` or a ``select`` set excludes
    both DLC100 and DLC101.

    The DLC2xx concurrency rules are gated: they run when
    ``concurrency=True`` or a ``select`` names them, never implicitly.
    Likewise the DLC3xx protocol/lifecycle checkers run when
    ``protocol_pass=True`` or selected, the DLC4xx trace-safety rules
    when ``sharding=True`` or selected, the DLC5xx comms/memory rules
    when ``comms=True`` or selected, and the DLC6xx determinism rules
    when ``determinism=True`` or selected.
    """
    effective_select = select
    gated_ids: set[str] = set()
    if concurrency:
        gated_ids |= set(concurrency_rules.RULE_IDS)
    if sharding:
        gated_ids |= set(sharding_rules.RULE_IDS)
    if comms:
        gated_ids |= set(collectives_rules.RULE_IDS)
    if determinism:
        gated_ids |= set(determinism_rules.RULE_IDS)
    if select is None and gated_ids:
        # Widen the per-file selection to "every ungated rule plus the
        # requested gated passes" — an explicit select is what lets gated
        # rules through core.lint_source.
        effective_select = {
            rule.id for rule in FILE_RULES.values() if rule.gate is None
        } | gated_ids

    out: list[Violation] = []
    for path in discover(targets if targets is not None else DEFAULT_TARGETS, root):
        out.extend(lint_source(path, select=effective_select))

    run_contract = contract and (
        select is None or select & {contract_check.RULE_VERBS, contract_check.RULE_FIELDS}
    )
    if run_contract:
        contract_violations = contract_check.check_contract()
        if select is not None:
            contract_violations = [v for v in contract_violations if v.rule in select]
        out.extend(contract_violations)

    run_protocol = protocol_pass or (
        select is not None and bool(select & set(PROTOCOL_RULE_IDS))
    )
    if run_protocol:
        protocol_violations = protocol.check_protocol() + protocol.check_lifecycle()
        if select is not None:
            protocol_violations = [
                v for v in protocol_violations if v.rule in select
            ]
        out.extend(protocol_violations)

    out.sort(key=lambda v: (v.path, v.line, v.col, v.rule))
    return out


# --- suppression baseline (ratchet) ------------------------------------------
#
# The baseline (analysis/lint_baseline.json, the port's own) is a
# committed JSON file of (rule, repo-relative path,
# message) triples.  Findings matching an entry are suppressed; anything
# NEW fails the build; entries that no longer match anything are reported
# as stale so the file only ever shrinks (a ratchet, not a flag-flood).
# Keys deliberately omit line numbers: unrelated edits above a finding
# must not churn the baseline.


def baseline_key(violation: Violation, root: Path = REPO_ROOT) -> tuple[str, str, str]:
    p = Path(violation.path)
    try:
        rel = p.resolve().relative_to(root.resolve()).as_posix()
    except ValueError:
        rel = p.as_posix()
    return (violation.rule, rel, violation.message)


def load_baseline(path: Path) -> set[tuple[str, str, str]]:
    data = json.loads(Path(path).read_text())
    entries = data.get("entries", data) if isinstance(data, dict) else data
    out: set[tuple[str, str, str]] = set()
    for entry in entries:
        out.add((entry["rule"], entry["path"], entry["message"]))
    return out


def apply_baseline(
    violations: list[Violation],
    baseline: set[tuple[str, str, str]],
    root: Path = REPO_ROOT,
) -> tuple[list[Violation], list[tuple[str, str, str]]]:
    """Split into (new findings, stale baseline entries)."""
    matched: set[tuple[str, str, str]] = set()
    fresh: list[Violation] = []
    for v in violations:
        key = baseline_key(v, root)
        if key in baseline:
            matched.add(key)
        else:
            fresh.append(v)
    stale = sorted(baseline - matched)
    return fresh, stale


def write_baseline(
    violations: list[Violation],
    path: Path,
    root: Path = REPO_ROOT,
) -> None:
    entries = sorted({baseline_key(v, root) for v in violations})
    payload = {
        "entries": [
            {"rule": rule, "path": rel, "message": message}
            for rule, rel, message in entries
        ],
    }
    Path(path).write_text(json.dumps(payload, indent=2) + "\n")


def apply_audit_baseline(
    violations: list[Violation],
    baseline_path: Path | str | None,
    rule_ids: Iterable[str],
    root: Path = REPO_ROOT,
) -> tuple[list[Violation], list[tuple[str, str, str]]]:
    """Namespace-scoped ratchet for the dynamic sentinels.

    A sentinel stage (compile-audit's DLC41x, comms-audit's DLC51x) owns
    only its own rule namespace inside the shared baseline file: entries
    for other rules belong to ``dlcfn lint`` and must be invisible here
    — otherwise every sentinel would nag about every other pass's
    suppressions as "stale".  Filters the baseline down to ``rule_ids``
    and returns the usual (fresh findings, stale entries) split.
    """
    ids = set(rule_ids)
    path = Path(baseline_path) if baseline_path is not None else DEFAULT_BASELINE
    baseline = load_baseline(path) if path.exists() else set()
    scoped = {entry for entry in baseline if entry[0] in ids}
    return apply_baseline(violations, scoped, root)


def render_text(violations: list[Violation]) -> str:
    lines = [v.format() for v in violations]
    lines.append(
        f"{len(violations)} violation(s)" if violations else "dlcfn-lint: clean"
    )
    return "\n".join(lines)


def render_json(violations: list[Violation]) -> str:
    return json.dumps(
        {"violations": [v.to_dict() for v in violations], "count": len(violations)},
        indent=2,
        allow_nan=False,
    )
