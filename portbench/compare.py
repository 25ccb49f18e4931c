"""The comparison that decides ``correct``.

Leaf readings are norms a leaf (a gradient, a momentum trace, a change of
the parameters).  The gap of a leaf is ``|program − reference|`` over the
larger of the reference's norm of that leaf and of the median leaf; a
number is its worst leaf's gap.  Leaves whose reference gradient is under a
thousandth of the median leaf's are left out of every leaf number: under
Adam they move by rounding alone."""

from __future__ import annotations

import math
import statistics

EXCLUDE_BELOW = 1e-3


def kept_leaves(ref_grad: dict[str, float]) -> set[str]:
    median = statistics.median(ref_grad.values())
    return {n for n, g in ref_grad.items() if g >= EXCLUDE_BELOW * median}


def worst_leaf_gap(prog: dict[str, float], ref: dict[str, float],
                   kept: set[str]) -> tuple[float, str]:
    if set(prog) != set(ref):
        raise ValueError("the program's leaves and the reference's differ")
    median = statistics.median(ref[n] for n in kept)
    worst, leaf = 0.0, ""
    for n in sorted(kept):
        gap = abs(prog[n] - ref[n]) / max(ref[n], median)
        if not math.isfinite(gap):
            return math.inf, n
        if gap > worst:
            worst, leaf = gap, n
    return worst, leaf


def median_leaf_gap(prog: dict[str, float], ref: dict[str, float], kept: set[str]) -> float:
    """The median over the kept leaves of a leaf's gap: steadier from seed to
    seed than the worst leaf, where a few small leaves swing by rounding."""
    median = statistics.median(ref[n] for n in kept)
    return statistics.median(abs(prog[n] - ref[n]) / max(ref[n], median) for n in kept)


def loss_gap(prog: list[float], ref: list[float]) -> float:
    """The largest gap of a step's loss, over the reference's loss."""
    if len(prog) < len(ref):
        return math.inf
    gaps = [abs(p - r) / abs(r) for p, r in zip(prog, ref)]
    return max(g if math.isfinite(g) else math.inf for g in gaps)


def within(checks: list[tuple[str, float, float]]) -> bool:
    return all(math.isfinite(v) and v <= limit for _, v, limit in checks)
