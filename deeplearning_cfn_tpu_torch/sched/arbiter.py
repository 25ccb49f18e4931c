"""The fleet arbiter: one cluster, many jobs, a journaled ledger —
counterpart of ``deeplearning_cfn_tpu/sched/arbiter.py``, copied.

:class:`FleetArbiter` owns the slice inventory (derived from the cluster
contract) and the job table, and closes the loop the SLO engine opened
(``obs/slo.py``): serve pages (``EventKind.ALERT`` on the cluster bus) become
capacity decisions instead of log lines.

Control flow keeps the repo's detection/recovery split (cluster/
recovery.py): alert *arrival* happens inside synchronous bus dispatch
and only records intent; ``reconcile()`` — the decision step — is
pulled at a safe point (the elasticity controller's safe-point hooks
fire it from the trainer's step boundary), so a preemption can never
re-enter the event bus mid-step.

The preemption ladder, in full:

1. a serve rule fires -> the page is queued;
2. ``reconcile()`` picks the lowest-priority job holding slices above
   its quota floor (never ``prod-serve``, never below ``min_slices``,
   never a job's anchor slice — the coordinator lives there);
3. the driver shrinks the victim's mesh via live reshard (grad-accum
   rescale preserves the global batch) and lends the freed slice to the
   serve pool as a fresh replica;
4. the rule resolving queues the restore; the next ``reconcile()``
   reclaims the replica (in-flight requests replay — zero loss) and
   arms the mesh re-grow, returning grad accumulation to exactly its
   pre-preempt value.

Every decision is journaled (``sched_decision`` / ``sched_preempt`` /
``sched_restore``) and the whole ledger — jobs, assignments, loans,
pending intents, counters — is persisted through the (sharded) broker
KV after every mutation, so an arbiter crash resumes from
:meth:`FleetArbiter.resume` without repeating a preemption: an
outstanding loan for a rule absorbs any replayed page for it.
"""

from __future__ import annotations

import json
from typing import Any, Iterable, Mapping

from deeplearning_cfn_tpu_torch.obs.recorder import get_recorder
from deeplearning_cfn_tpu_torch.sched.placer import Placement, place
from deeplearning_cfn_tpu_torch.sched.preempt import PreemptionDriver
from deeplearning_cfn_tpu_torch.sched.specs import JobSpec
from deeplearning_cfn_tpu_torch.utils.logging import get_logger

log = get_logger("dlcfn.sched")

#: Broker KV key the ledger persists under (the router shards by key,
#: so a sharded fleet stores this on whichever pair owns "sched/").
LEDGER_KEY = "sched/ledger"

#: SLO rules the arbiter treats as serve-capacity pages by default —
#: the two serve rules obs/slo.DEFAULT_RULES ships.
DEFAULT_SERVE_RULES = ("serve-ttft-p99", "serve-queue-depth")


class SchedError(ValueError):
    """A spec or decision the arbiter refuses (invalid spec, duplicate
    job, unknown slice) — raised at submit, never mid-reconcile."""


class FleetArbiter:
    """Places jobs on the slice inventory and arbitrates under alerts."""

    def __init__(
        self,
        inventory: Mapping[str, int],
        slice_ips: Mapping[str, Iterable[str]] | None = None,
        store: Any = None,  # duck-typed broker KV: set(key, str) / get(key)
        driver: PreemptionDriver | None = None,
        serve_rules: Iterable[str] = DEFAULT_SERVE_RULES,
    ):
        self.inventory: dict[str, int] = dict(inventory)
        self.slice_ips: dict[str, list[str]] = {
            s: list(ips) for s, ips in (slice_ips or {}).items()
        }
        self.store = store
        self.driver = driver
        self.serve_rules = tuple(serve_rules)
        self.jobs: dict[str, JobSpec] = {}
        self.assignments: dict[str, list[str]] = {}
        self.unplaced: dict[str, str] = {}
        self.loans: list[dict] = []
        self.pending_pages: list[dict] = []
        self.pending_resolves: list[dict] = []
        self.alert_counts: dict[str, dict[str, int]] = {}
        self.counters = {"decisions": 0, "preemptions": 0, "restores": 0}
        self.seq = 0

    # --- construction -----------------------------------------------------
    @classmethod
    def from_contract(cls, contract: Any, **kwargs: Any) -> "FleetArbiter":
        """Derive the inventory (and the slice -> hosts map the driver
        needs for synthetic terminates) from a ClusterContract."""
        return cls(
            inventory=contract.slice_inventory(),
            slice_ips={g: list(ips) for g, ips in (contract.slices or {}).items()},
            **kwargs,
        )

    @classmethod
    def resume(cls, store: Any, **kwargs: Any) -> "FleetArbiter":
        """Rebuild a crashed arbiter from its persisted ledger.  The
        resumed instance holds the same loans, so replayed pages for an
        already-healed rule are absorbed, never re-preempted."""
        raw = store.get(LEDGER_KEY)
        if not raw:
            raise SchedError(f"no ledger at broker key {LEDGER_KEY!r}")
        body = json.loads(raw)
        arbiter = cls(
            inventory=body["inventory"],
            slice_ips=body["slice_ips"],
            store=store,
            serve_rules=tuple(body.get("serve_rules", DEFAULT_SERVE_RULES)),
            **kwargs,
        )
        arbiter.jobs = {
            name: JobSpec.from_dict(spec) for name, spec in body["jobs"].items()
        }
        arbiter.assignments = {j: list(s) for j, s in body["assignments"].items()}
        arbiter.unplaced = dict(body.get("unplaced", {}))
        arbiter.loans = [dict(l) for l in body.get("loans", [])]
        arbiter.pending_pages = [dict(p) for p in body.get("pending_pages", [])]
        arbiter.pending_resolves = [
            dict(r) for r in body.get("pending_resolves", [])
        ]
        arbiter.alert_counts = {
            r: dict(c) for r, c in body.get("alert_counts", {}).items()
        }
        arbiter.counters.update(body.get("counters", {}))
        arbiter.seq = int(body.get("seq", 0))
        return arbiter

    # --- ledger persistence ----------------------------------------------
    def ledger(self) -> dict:
        return {
            "v": 1,
            "inventory": dict(sorted(self.inventory.items())),
            "slice_ips": {s: list(i) for s, i in sorted(self.slice_ips.items())},
            "serve_rules": list(self.serve_rules),
            "jobs": {n: s.to_dict() for n, s in sorted(self.jobs.items())},
            "assignments": {
                j: list(s) for j, s in sorted(self.assignments.items())
            },
            "unplaced": dict(sorted(self.unplaced.items())),
            "loans": [dict(l) for l in self.loans],
            "pending_pages": [dict(p) for p in self.pending_pages],
            "pending_resolves": [dict(r) for r in self.pending_resolves],
            "alert_counts": {
                r: dict(c) for r, c in sorted(self.alert_counts.items())
            },
            "counters": dict(self.counters),
            "seq": self.seq,
        }

    def persist(self) -> None:
        if self.store is not None:
            self.store.set(LEDGER_KEY, json.dumps(self.ledger(), sort_keys=True))

    # --- derived views ----------------------------------------------------
    def free_slices(self) -> list[str]:
        assigned = {s for slices in self.assignments.values() for s in slices}
        return sorted(s for s in self.inventory if s not in assigned)

    def status(self) -> dict:
        return {
            "jobs": {n: s.to_dict() for n, s in sorted(self.jobs.items())},
            "assignments": {
                j: list(s) for j, s in sorted(self.assignments.items())
            },
            "unplaced": dict(sorted(self.unplaced.items())),
            "free_slices": self.free_slices(),
            "loans": [dict(l) for l in self.loans],
            "pending_pages": len(self.pending_pages),
            "pending_resolves": len(self.pending_resolves),
            "alert_counts": {
                r: dict(c) for r, c in sorted(self.alert_counts.items())
            },
            "counters": dict(self.counters),
        }

    def _journal_decision(self, action: str, **fields: Any) -> None:
        self.counters["decisions"] += 1
        get_recorder().record(
            "sched_decision",
            action=action,
            jobs=len(self.jobs),
            free_slices=len(self.free_slices()),
            loans_outstanding=len(self.loans),
            **fields,
        )

    # --- job admission ----------------------------------------------------
    def submit(self, spec: JobSpec) -> tuple[str, ...]:
        """Admit a job and place it on free slices (running jobs are
        sticky — admission never migrates them).  Returns the assigned
        slices; an empty tuple means admitted-but-unplaced (the reason
        lands in ``status()['unplaced']`` and the journal)."""
        errors = spec.validate()
        if errors:
            raise SchedError("; ".join(errors))
        if spec.name in self.jobs:
            raise SchedError(f"job {spec.name!r} already submitted")
        self.jobs[spec.name] = spec
        free = {s: self.inventory[s] for s in self.free_slices()}
        verdict: Placement = place([spec], free)
        slices = verdict.assignments.get(spec.name, ())
        if slices:
            self.assignments[spec.name] = list(slices)
            self.unplaced.pop(spec.name, None)
        else:
            self.unplaced[spec.name] = verdict.unplaced[spec.name]
        self._journal_decision(
            "submit",
            job=spec.name,
            priority=spec.priority,
            placed=list(slices),
            reason=self.unplaced.get(spec.name),
        )
        self.persist()
        log.info(
            "job %s (%s) submitted: placed on %s",
            spec.name, spec.priority, list(slices) or "nothing (unplaced)",
        )
        return tuple(slices)

    # --- alert intake (inside bus dispatch: record intent, decide later) --
    def attach(self, bus: Any) -> None:
        bus.subscribe(self.on_event)

    def detach(self, bus: Any) -> None:
        bus.unsubscribe(self.on_event)

    def on_event(self, event: Any) -> None:
        from deeplearning_cfn_tpu_torch.provision.events import EventKind

        if event.kind is not EventKind.ALERT:
            return
        rule = event.detail.get("rule")
        state = event.detail.get("state")
        if rule not in self.serve_rules or state not in ("firing", "resolved"):
            return
        counts = self.alert_counts.setdefault(rule, {"firing": 0, "resolved": 0})
        counts[state] += 1
        intent = {
            "rule": rule,
            "value": event.detail.get("value"),
            "severity": event.detail.get("severity"),
            "deferred": False,
        }
        if state == "firing":
            self.pending_pages.append(intent)
        else:
            self.pending_resolves.append(intent)
        self.persist()

    # --- the decision step (pulled at a safe point) -----------------------
    def _serve_target(self) -> str | None:
        serves = [j for j in self.jobs.values() if j.kind == "serve"]
        if not serves:
            return None
        return min(serves, key=lambda j: (j.rank, j.name)).name

    def _pick_victim(self) -> tuple[str, str] | None:
        """(job, slice) to preempt: lowest class first, name as tiebreak;
        only above-floor donors; never a job's anchor (first) slice."""
        donors = sorted(
            (
                j
                for j in self.jobs.values()
                if j.preemptible
                and len(self.assignments.get(j.name, [])) > j.min_slices
                and len(self.assignments.get(j.name, [])) > 1
            ),
            key=lambda j: (-j.rank, j.name),
        )
        for job in donors:
            slices = self.assignments[job.name]
            return job.name, slices[-1]
        return None

    def reconcile(self) -> list[dict]:
        """Act on queued intents; returns the actions taken.  Safe to
        call every step boundary — quiet rounds are free."""
        actions: list[dict] = []
        # Pages first: healing the page is why the resolve will come.
        remaining_pages: list[dict] = []
        for page in self.pending_pages:
            rule = page["rule"]
            if any(l["rule"] == rule for l in self.loans):
                # Crash-replayed or duplicate page for a rule a loan
                # already heals: absorb it — preempting again would be
                # the double-preemption the ledger exists to prevent.
                self._journal_decision("page-absorbed", rule=rule)
                continue
            target = self._serve_target()
            victim = self._pick_victim()
            if target is None or victim is None:
                if not page["deferred"]:
                    page["deferred"] = True
                    self._journal_decision(
                        "preempt-deferred",
                        rule=rule,
                        reason="no serve target" if target is None else "no donor",
                    )
                remaining_pages.append(page)
                continue
            job, slice_name = victim
            ips = self.slice_ips.get(slice_name, [])
            if self.driver is not None:
                self.driver.shrink(job, slice_name, ips)
                self.driver.lend(target, slice_name)
            self.assignments[job].remove(slice_name)
            self.assignments.setdefault(target, []).append(slice_name)
            self.seq += 1
            loan = {
                "seq": self.seq,
                "slice": slice_name,
                "from_job": job,
                "to_job": target,
                "rule": rule,
            }
            self.loans.append(loan)
            self.counters["preemptions"] += 1
            get_recorder().record(
                "sched_preempt",
                seq=self.seq,
                rule=rule,
                slice=slice_name,
                from_job=job,
                to_job=target,
                loans_outstanding=len(self.loans),
            )
            log.warning(
                "preempted slice %s from %s -> %s (rule %s, seq %d)",
                slice_name, job, target, rule, self.seq,
            )
            actions.append({"action": "preempt", **loan})
        self.pending_pages = remaining_pages
        # Resolves: return every loan the resolved rule took out.
        for resolve in self.pending_resolves:
            rule = resolve["rule"]
            settled = [l for l in self.loans if l["rule"] == rule]
            for loan in settled:
                slice_name = loan["slice"]
                ips = self.slice_ips.get(slice_name, [])
                if self.driver is not None:
                    self.driver.reclaim(loan["to_job"], slice_name)
                    self.driver.grow(loan["from_job"], slice_name, ips)
                self.assignments[loan["to_job"]].remove(slice_name)
                self.assignments.setdefault(loan["from_job"], []).append(
                    slice_name
                )
                self.loans.remove(loan)
                self.counters["restores"] += 1
                get_recorder().record(
                    "sched_restore",
                    seq=loan["seq"],
                    rule=rule,
                    slice=slice_name,
                    from_job=loan["from_job"],
                    to_job=loan["to_job"],
                    loans_outstanding=len(self.loans),
                )
                log.warning(
                    "restored slice %s to %s after %s resolved (seq %d)",
                    slice_name, loan["from_job"], rule, loan["seq"],
                )
                actions.append({"action": "restore", **loan})
        self.pending_resolves = []
        self.persist()
        return actions
