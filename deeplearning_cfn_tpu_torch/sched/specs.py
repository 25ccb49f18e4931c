"""Job specs and the slice inventory — the arbiter's placement currency.

Counterpart of ``deeplearning_cfn_tpu/sched/specs.py``, copied.

The reference stack sizes ONE workload per cluster (the ASG desired
capacity IS the job's worker count); everything here exists because this
repo now runs several.  A :class:`JobSpec` is what an operator submits:
a named workload with a priority class and a slice quota.  The classes
form a strict ladder — ``prod-serve`` outranks ``prod-train`` outranks
``batch`` — and the ladder is the entire preemption policy: the arbiter
only ever takes slices from a lower class to heal a higher one, and
only down to the victim's quota floor (``min_slices``), never below.

The inventory side is deliberately thin: slices are the scheduling
atom (a slice is one logical machine — cluster/recovery.py), so the
arbiter trades in ``{slice_name: chips}`` derived straight from the
cluster contract (``ClusterContract.slice_inventory``).  Chip counts
only break ties; quotas are in slices because reshard, recovery, and
loss all happen at slice granularity.
"""

from __future__ import annotations

from dataclasses import dataclass, field

#: Priority ladder, highest first.  Index = rank; lower rank wins.
PRIORITY_CLASSES = ("prod-serve", "prod-train", "batch")

#: Workload kinds the placer understands.  "serve" jobs map to replica
#: pools (serve/replica.ServeFrontEnd); "train" jobs map to meshes
#: (train/reshard.LiveReshardCoordinator).
JOB_KINDS = ("train", "serve")


def priority_rank(priority: str) -> int:
    """Rank of a priority class (0 = highest).  Raises on unknown names
    so a typo'd spec fails at submit, not at the first preemption."""
    try:
        return PRIORITY_CLASSES.index(priority)
    except ValueError:
        raise ValueError(
            f"unknown priority class {priority!r}; want one of {PRIORITY_CLASSES}"
        ) from None


@dataclass(frozen=True)
class JobSpec:
    """One schedulable workload: name, kind, priority class, slice quota.

    ``min_slices`` is the quota floor — the placer refuses to place the
    job below it and the arbiter never preempts it below it.
    ``max_slices`` is the ceiling the second placement pass fills up to.
    """

    name: str
    kind: str  # "train" | "serve"
    priority: str = "batch"
    min_slices: int = 1
    max_slices: int = 1
    tags: dict[str, str] = field(default_factory=dict)

    def validate(self) -> list[str]:
        """Schema errors, empty when submittable — the same list-check
        contract SloRule.validate uses."""
        errors = []
        if not self.name:
            errors.append("job has no name")
        if self.kind not in JOB_KINDS:
            errors.append(
                f"{self.name}: unknown kind {self.kind!r} (want {JOB_KINDS})"
            )
        if self.priority not in PRIORITY_CLASSES:
            errors.append(
                f"{self.name}: unknown priority {self.priority!r} "
                f"(want {PRIORITY_CLASSES})"
            )
        if self.min_slices < 1:
            errors.append(f"{self.name}: min_slices must be >= 1")
        if self.max_slices < self.min_slices:
            errors.append(
                f"{self.name}: max_slices {self.max_slices} < "
                f"min_slices {self.min_slices}"
            )
        return errors

    @property
    def rank(self) -> int:
        return priority_rank(self.priority)

    @property
    def preemptible(self) -> bool:
        """Whether the arbiter may shrink this job to heal a page.
        ``prod-serve`` is the class pages are healed FOR, never from."""
        return self.priority != "prod-serve"

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "kind": self.kind,
            "priority": self.priority,
            "min_slices": self.min_slices,
            "max_slices": self.max_slices,
            "tags": dict(self.tags),
        }

    @classmethod
    def from_dict(cls, body: dict) -> "JobSpec":
        return cls(
            name=str(body["name"]),
            kind=str(body["kind"]),
            priority=str(body.get("priority", "batch")),
            min_slices=int(body.get("min_slices", 1)),
            max_slices=int(body.get("max_slices", 1)),
            tags=dict(body.get("tags", {})),
        )
