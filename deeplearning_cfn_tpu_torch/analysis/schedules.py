"""Counterpart of ``VirtualClock`` and ``interleavings`` in
``deeplearning_cfn_tpu/analysis/schedules.py``.

The serving plane's load generator and scheduler measure latency on an
injectable clock; on a virtual one the soak and failover tests are
deterministic and wall-clock free.  ``interleavings`` gives the seeded
event orders that the debounce tests and the ``slice-loss-live`` scenario
replay.  The heartbeat choreography and the simulated brokers around them
drive the liveness plane, which is not part of the port yet.
"""

from __future__ import annotations

import random
from typing import Sequence


class VirtualClock:
    """Monotonic virtual time: only :meth:`advance` moves it.  Callable so
    it drops into every ``clock=`` seam."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def now(self) -> float:
        return self._now

    __call__ = now

    def advance(self, dt_s: float) -> float:
        if dt_s < 0:
            raise ValueError(f"virtual time cannot go backwards: {dt_s}")
        self._now += dt_s
        return self._now


def interleavings(
    actions: Sequence[str],
    count: int,
    seed: int = 0,
) -> list[tuple[str, ...]]:
    """``count`` distinct seeded shuffles of ``actions``.  Deterministic:
    the same (actions, count, seed) always yields the same schedules, so
    a failure names its schedule reproducibly."""
    rng = random.Random(seed)
    seen: set[tuple[str, ...]] = set()
    out: list[tuple[str, ...]] = []
    attempts = 0
    limit = count * 1000
    while len(out) < count:
        attempts += 1
        if attempts > limit:
            raise RuntimeError(
                f"could not generate {count} distinct schedules from "
                f"{len(actions)} actions (got {len(out)})"
            )
        shuffled = list(actions)
        rng.shuffle(shuffled)
        candidate = tuple(shuffled)
        if candidate not in seen:
            seen.add(candidate)
            out.append(candidate)
    return out
