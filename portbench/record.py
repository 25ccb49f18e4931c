"""What one run of a cell knows: its inputs, then what the driver measured.
Metric readers read it; nothing in it comes from a CPU run under a device
metric's name."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable


@dataclass
class Run:
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: Any = None  # torch.device of this rank
    rank: int = 0
    world: int = 1
    t0_wall: float = 0.0  # time.time() when the command started
    plant: str | None = None  # a fault planted in the program (tests only: plants.py)
    # Filled by the driver.
    setup_s: float | None = None
    window_s: float | None = None
    window_steps: int = 0
    window_failed: int = 0
    peak_bytes: int | None = None
    input_wait_s: float | None = None
    flops_per_step: float | None = None
    profile: dict | None = None  # trace.summarise(), this rank's
    busy_s: list[float] = field(default_factory=list)  # every rank's
    probes: dict = field(default_factory=dict)  # what metrics' probes measured
    checks: list[tuple[str, float, float]] = field(default_factory=list)  # (name, value, limit)
    notes: dict = field(default_factory=dict)
    # Set by the harness in a traced run: runs the cell's metrics' probes on
    # what the driver hands it ({"model": ..., "trainer": ...}).
    probe_fn: Callable[["Run", dict], None] | None = None

    def probe(self, handles: dict) -> None:
        if self.probe_fn is not None:
            self.probe_fn(self, handles)
