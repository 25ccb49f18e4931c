"""Deterministic bin-packing placement of jobs onto slices.

Counterpart of ``deeplearning_cfn_tpu/sched/placer.py``, copied.

Two passes, both in strict (priority rank, job name) order over slices
sorted by (-chips, name) — biggest slices go to the highest class first:

1. **Floor pass** — every job takes exactly ``min_slices`` from the free
   pool, or is recorded unplaced with a reason (nothing partial: a job
   that cannot reach its floor takes zero slices).
2. **Fill pass** — remaining slices are dealt round-robin, priority
   order, to jobs still under ``max_slices``, until the pool is dry or
   every job is at its ceiling.

``place()`` is a pure function of (jobs, inventory, pinned): no clock,
no randomness, no ambient state — two calls (and a permuted submission
order) are byte-identical (``tests/test_torch_sched.py``).
``pinned`` carries sticky assignments from a running arbiter so a
re-place never migrates a healthy job: pinned slices are honored
verbatim and withheld from the free pool.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, Mapping

from deeplearning_cfn_tpu_torch.sched.specs import JobSpec


@dataclass
class Placement:
    """The placer's verdict: who got which slices, and who did not."""

    assignments: dict[str, tuple[str, ...]] = field(default_factory=dict)
    unplaced: dict[str, str] = field(default_factory=dict)  # name -> reason

    def slices_of(self, job: str) -> tuple[str, ...]:
        return self.assignments.get(job, ())

    def to_dict(self) -> dict:
        return {
            "assignments": {j: list(s) for j, s in sorted(self.assignments.items())},
            "unplaced": dict(sorted(self.unplaced.items())),
        }


def _job_order(jobs: Iterable[JobSpec]) -> list[JobSpec]:
    return sorted(jobs, key=lambda j: (j.rank, j.name))


def place(
    jobs: Iterable[JobSpec],
    inventory: Mapping[str, int],
    pinned: Mapping[str, Iterable[str]] | None = None,
) -> Placement:
    """Assign every job a slice set: floor pass then fill pass (above).

    ``inventory`` is ``{slice_name: chips}`` (ClusterContract.slice_inventory);
    ``pinned`` is ``{job_name: slices}`` of assignments that must survive
    as-is.  Pinning an unknown slice or double-pinning one raises — a
    corrupt ledger must fail loudly, not place two jobs on one slice.
    """
    specs = _job_order(jobs)
    names = [j.name for j in specs]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate job names: {sorted(names)}")
    out = Placement()
    taken: set[str] = set()
    if pinned:
        for job, slices in pinned.items():
            slices = tuple(slices)
            unknown = [s for s in slices if s not in inventory]
            if unknown:
                raise ValueError(
                    f"pinned slices {unknown} for {job!r} are not in the inventory"
                )
            dupes = [s for s in slices if s in taken]
            if dupes:
                raise ValueError(f"slices {dupes} pinned to more than one job")
            taken.update(slices)
            out.assignments[job] = slices
    # Biggest slices first; name breaks ties, so equal-size inventories
    # place identically regardless of dict construction order.
    free = [
        s for s in sorted(inventory, key=lambda s: (-inventory[s], s))
        if s not in taken
    ]
    # Pass 1 — floors.
    for spec in specs:
        if spec.name in out.assignments:
            continue  # pinned: the running assignment is the placement
        if len(free) < spec.min_slices:
            out.unplaced[spec.name] = (
                f"needs {spec.min_slices} slice(s), only {len(free)} free"
            )
            continue
        out.assignments[spec.name] = tuple(free[: spec.min_slices])
        free = free[spec.min_slices:]
    # Pass 2 — fill to ceilings, one slice per job per round so a greedy
    # high-priority ceiling cannot starve the class below it of its fill.
    grew = True
    while free and grew:
        grew = False
        for spec in specs:
            if not free:
                break
            have = out.assignments.get(spec.name)
            if have is None or len(have) >= spec.max_slices:
                continue
            out.assignments[spec.name] = have + (free.pop(0),)
            grew = True
    return out


def verify_placement(
    placement: Placement,
    jobs: Iterable[JobSpec],
    inventory: Mapping[str, int],
) -> list[str]:
    """Invariant violations, empty when sound: every assigned slice
    exists and is assigned once; every placed job sits inside its
    [min, max] quota; every job is either placed or explained."""
    errors: list[str] = []
    specs = {j.name: j for j in jobs}
    seen: dict[str, str] = {}
    for job, slices in placement.assignments.items():
        for s in slices:
            if s not in inventory:
                errors.append(f"{job}: assigned unknown slice {s!r}")
            if s in seen:
                errors.append(f"slice {s!r} assigned to both {seen[s]} and {job}")
            seen[s] = job
        spec = specs.get(job)
        if spec is None:
            errors.append(f"assignment for unknown job {job!r}")
        elif not spec.min_slices <= len(slices) <= spec.max_slices:
            errors.append(
                f"{job}: {len(slices)} slice(s) outside quota "
                f"[{spec.min_slices}, {spec.max_slices}]"
            )
    for name in specs:
        if name not in placement.assignments and name not in placement.unplaced:
            errors.append(f"{name}: neither placed nor explained")
    return errors
