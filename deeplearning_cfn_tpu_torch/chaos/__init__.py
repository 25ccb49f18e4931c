"""Chaos-injection layer of the port — counterpart of ``deeplearning_cfn_tpu/chaos``:
seeded, deterministic faults over real seams.

``injectors`` wraps the seams the stack already exposes (GoogleAuthTransport's
``opener``, Heartbeater's ``connection_factory``, the RendezvousQueue
interface, checkpoint I/O) with seeded fault models — disk injectors share
a uniform ``wrap()`` seam so faults stack; ``scenarios`` composes them into
the named end-to-end soaks of the JAX catalog, which drive the REAL
components (over virtual time, and the trainers and engines on the card)
and assert recovery invariants.  ``gauntlet`` composes MULTIPLE faults
into one incident against one end-to-end workload from a declarative
:class:`FaultSchedule`, with a seeded sweep explorer and a greedy schedule
shrinker.  ``python -m deeplearning_cfn_tpu_torch.cli chaos`` and ``cli
gauntlet`` are the entry points.
"""

from deeplearning_cfn_tpu_torch.chaos.gauntlet import (
    FAULT_KINDS,
    REGRESSION_SCHEDULES,
    FaultEvent,
    FaultSchedule,
    GauntletInvariants,
    perturbed_schedule,
    pinned_schedule,
    run_gauntlet,
    run_gauntlet_sweep,
    shrink_schedule,
)
from deeplearning_cfn_tpu_torch.chaos.injectors import (
    ChaosQueue,
    DiskInjector,
    FlakyOpener,
    ManifestCrashDisk,
    RecordingClock,
    SlowDisk,
    StallingConnectionFactory,
    TornDisk,
)
from deeplearning_cfn_tpu_torch.chaos.scenarios import (
    SCENARIO_FAULTS,
    SCENARIOS,
    ScenarioReport,
    run_scenario,
)

__all__ = [
    "ChaosQueue",
    "DiskInjector",
    "FAULT_KINDS",
    "FaultEvent",
    "FaultSchedule",
    "FlakyOpener",
    "GauntletInvariants",
    "ManifestCrashDisk",
    "REGRESSION_SCHEDULES",
    "RecordingClock",
    "SCENARIOS",
    "SCENARIO_FAULTS",
    "ScenarioReport",
    "SlowDisk",
    "StallingConnectionFactory",
    "TornDisk",
    "perturbed_schedule",
    "pinned_schedule",
    "run_gauntlet",
    "run_gauntlet_sweep",
    "run_scenario",
    "shrink_schedule",
]
