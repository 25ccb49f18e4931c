"""Counterpart of ``VirtualClock`` in ``deeplearning_cfn_tpu/analysis/schedules.py``.

The serving plane's load generator and scheduler measure latency on an
injectable clock; on a virtual one the soak and failover tests are
deterministic and wall-clock free.  Only the clock is ported: the
interleaving harness around it drives the broker and liveness plane,
which are not part of the port yet.
"""

from __future__ import annotations


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
