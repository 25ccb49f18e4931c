"""Chaos scenarios — counterpart of ``deeplearning_cfn_tpu/chaos/scenarios.py``:
the whole catalog, in the JAX package's order, on the port's components.

Each scenario drives real components through seeded faults and records
which recovery invariants held in a :class:`ScenarioReport`, whose
``to_dict()`` is the JAX package's wire shape (schema 2) and is the same
for the same (scenario, seed) run twice.  The control-plane scenarios
(``silent-death``, ``partition``, ``flaky-rpc``, ``slow-disk``,
``straggler``, ``broker-failover``, ``split-brain``, ``shard-failover``,
``degraded-pair-heal``, ``alert-storm``) run on virtual clocks in this
process, as JAX's do.  ``serve-replica-loss`` serves the tiny f32 Llama
from two engines in this process.  The scenarios that train
(``slice-loss-live``, ``data-reshard-live``, ``sched-flash-crowd`` and the
``gauntlet``, ``chaos/gauntlet.py``) run one SPMD trainer over eight
virtual CPU devices in JAX; here every rank is a process: four gloo ranks
(2 slices x fsdp 2, one rank a worker), each running its own ``fit``, and
this process checks the invariants on what the ranks report.  A control
plane around a trainer (the arbiter, SLO engine and serve pool of
``sched-flash-crowd``, :class:`FlashCrowd`; the gauntlet's broker ring,
data plane and SLO engine) lives in rank 0's process.

Run one with ``python -m deeplearning_cfn_tpu_torch.cli chaos --scenario
NAME --seed N``: its trainers and engines run on the card (the ranks all
on ``cuda:0`` of a one-card host, still over gloo), or on the CPU with
``--device cpu``; without a card and ``--device cpu`` they raise.
"""

from __future__ import annotations

import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

from deeplearning_cfn_tpu_torch.chaos.injectors import (
    ChaosQueue,
    FlakyOpener,
    RecordingClock,
    SlowDisk,
    TornDisk,
)
from deeplearning_cfn_tpu_torch.utils.timeouts import FakeClock

#: Bump when the report wire shape changes (the JAX package's schema 2).
REPORT_SCHEMA_VERSION = 2

RANKS, TOTAL_STEPS, JOIN_TIMEOUT_S = 4, 8, 600


@dataclass
class ScenarioReport:
    """What a scenario proved (and what it could not).

    ``faults`` is the declarative fault block: one dict per injected
    fault (``{"kind", "at_step", ...}``), empty for scenarios whose faults
    are implicit in the scenario body.
    """

    name: str
    seed: int
    passed: bool = True
    invariants: list[str] = field(default_factory=list)
    violations: list[str] = field(default_factory=list)
    details: dict[str, Any] = field(default_factory=dict)
    faults: list[dict[str, Any]] = field(default_factory=list)
    schema_version: int = REPORT_SCHEMA_VERSION
    #: What the run measured beside the report (wall times, whole outputs):
    #: not part of ``to_dict()``, which stays the same run to run.
    observed: dict[str, Any] = field(default_factory=dict, compare=False, repr=False)

    def check(self, condition: bool, description: str) -> None:
        if condition:
            self.invariants.append(description)
        else:
            self.violations.append(description)
            self.passed = False

    def to_dict(self) -> dict[str, Any]:
        return {
            "schema_version": self.schema_version,
            "scenario": self.name,
            "seed": self.seed,
            "passed": self.passed,
            "invariants": list(self.invariants),
            "violations": list(self.violations),
            "details": dict(self.details),
            "faults": [dict(f) for f in self.faults],
        }


def _close(a: list, b: list, rtol: float, atol: float) -> bool:
    return len(a) == len(b) and all(abs(x - y) <= atol + rtol * abs(y) for x, y in zip(a, b))


def _journal_count(kind: str) -> int:
    from deeplearning_cfn_tpu_torch.obs.recorder import get_recorder

    return sum(1 for e in get_recorder().tail(4096) if e.get("kind") == kind)


def _degraded_event_count() -> int:
    return _journal_count("degraded")


def _datastream_event_count(event: str) -> int:
    from deeplearning_cfn_tpu_torch.obs.recorder import get_recorder

    return sum(1 for e in get_recorder().tail(8192)
               if e.get("kind") == "datastream" and e.get("event") == event)


# --- silent-death ------------------------------------------------------------

_SD_PREFIX = ["beat:w0", "beat:w1", "poll"]
_SD_MIDDLE = (
    "beat:w0",
    "beat:w1",
    "beat:w1",
    "tick",
    "tick",
    "poll",
    "kill:w0",
    "poll",
)
_SD_DRAIN = ["beat:w1", "tick"] * 13 + ["poll"]


def silent_death(seed: int) -> ScenarioReport:
    """A worker dies silently under several seeded interleavings; the
    liveness plane must terminate it exactly once and recovery must
    replace it, with the survivor untouched."""
    from deeplearning_cfn_tpu_torch.analysis.schedules import (
        HeartbeatChoreography,
        InvariantViolation,
        interleavings,
    )
    from deeplearning_cfn_tpu_torch.obs.liveness import LivenessConfig, WorkerState

    report = ScenarioReport("silent-death", seed)
    schedules = interleavings(_SD_MIDDLE, count=6, seed=seed)
    terminations = 0
    for middle in schedules:
        choreo = HeartbeatChoreography(
            ["w0", "w1"],
            config=LivenessConfig(suspect_after_s=15.0, dead_after_s=60.0),
            tick_s=5.0,
        )
        try:
            choreo.run(_SD_PREFIX + list(middle) + _SD_DRAIN + ["recover", "poll"])
        except InvariantViolation as violation:
            report.check(False, f"ground-truth invariant: {violation}")
            continue
        states = choreo.states()
        report.check(
            states.get("w0") == WorkerState.DEAD.value,
            "silently-dead worker classified DEAD",
        )
        w0_terminations = choreo.terminated_workers().count("w0")
        terminations += w0_terminations
        report.check(
            w0_terminations == 1, "exactly one INSTANCE_TERMINATE for the victim"
        )
        report.check(
            states.get("w1") == WorkerState.ALIVE.value
            and "w1" not in choreo.terminated_workers(),
            "survivor stayed ALIVE and was never terminated",
        )
        report.check(
            choreo.recovered == {"w0": "w0+1"}
            and states.get("w0+1") == WorkerState.ALIVE.value,
            "recovery replaced the victim; replacement is beating",
        )
    report.details.update(
        schedules=len(schedules), terminations=terminations
    )
    return report


# --- partition ---------------------------------------------------------------


class _FlappingSink:
    """A metrics sink that raises OSError while ``down``."""

    def __init__(self) -> None:
        self.down = False
        self.records: list[dict] = []

    def write(self, record: dict) -> None:
        if self.down:
            raise OSError("sink unreachable (partition)")
        self.records.append(record)

    def close(self) -> None:
        pass


def partition(seed: int) -> ScenarioReport:
    """Network cuts: short ones must not kill, long ones must kill
    exactly once, healing resurrects; meanwhile the metrics plane rides
    out the outage inside its grace window and queue-level chaos cannot
    break the at-least-once consumer contract."""
    from deeplearning_cfn_tpu_torch.analysis.schedules import (
        HeartbeatChoreography,
        InvariantViolation,
        interleavings,
    )
    from deeplearning_cfn_tpu_torch.cluster.queue import InMemoryQueue
    from deeplearning_cfn_tpu_torch.obs.liveness import LivenessConfig, WorkerState
    from deeplearning_cfn_tpu_torch.train.metrics import MetricsOutage, ResilientSink

    report = ScenarioReport("partition", seed)

    # -- liveness under cut/heal ----------------------------------------
    short_cut = ("beat:w0", "beat:w1", "tick", "tick", "poll")
    for middle in interleavings(short_cut, count=4, seed=seed):
        choreo = HeartbeatChoreography(
            ["w0", "w1"],
            config=LivenessConfig(suspect_after_s=15.0, dead_after_s=60.0),
            tick_s=5.0,
        )
        try:
            # Short partition (10 virtual seconds < suspect threshold),
            # then heal: nobody may be terminated.
            choreo.run(
                _SD_PREFIX
                + ["cut:w0"]
                + list(middle)
                + ["heal:w0", "beat:w0", "poll"]
            )
            report.check(
                choreo.terminated_workers() == []
                and choreo.states().get("w0") == WorkerState.ALIVE.value,
                "short partition: no termination, worker ALIVE after heal",
            )
            # Long partition: w0 cut past dead_after (65 virtual s) while
            # w1 keeps beating -> exactly one terminate, then recovery,
            # then heal resurrects the original.
            choreo.run(
                ["cut:w0"]
                + ["beat:w0", "beat:w1", "tick"] * 13
                + ["poll", "recover", "heal:w0", "beat:w0", "poll"]
            )
        except InvariantViolation as violation:
            report.check(False, f"ground-truth invariant: {violation}")
            continue
        states = choreo.states()
        report.check(
            choreo.terminated_workers().count("w0") == 1,
            "long partition: exactly one INSTANCE_TERMINATE",
        )
        report.check(
            "w1" not in choreo.terminated_workers()
            and states.get("w1") == WorkerState.ALIVE.value,
            "worker on the healthy side never terminated",
        )
        report.check(
            states.get("w0") == WorkerState.ALIVE.value,
            "healed worker resurrected to ALIVE",
        )
        report.check(
            choreo.recovered.get("w0") == "w0+1"
            and states.get("w0+1") == WorkerState.ALIVE.value,
            "recovery brought up a replacement during the cut",
        )

    # -- trainer grace window -------------------------------------------
    clock = FakeClock()
    inner = _FlappingSink()
    sink = ResilientSink(inner, grace_s=120.0, clock=clock)
    sink.write({"step": 0})
    inner.down = True
    buffered = 0
    for step in range(1, 6):  # 5 writes over 50 virtual s of outage
        clock.advance(10.0)
        sink.write({"step": step})
        buffered = sink.buffered
    report.check(
        buffered == 5 and sink.degraded,
        "metrics outage inside grace window: writes buffered, no raise",
    )
    inner.down = False
    sink.write({"step": 6})
    report.check(
        sink.buffered == 0
        and not sink.degraded
        and [r["step"] for r in inner.records] == list(range(7)),
        "sink recovery flushed the buffer in order, nothing lost",
    )
    inner.down = True
    outage_raised = False
    try:
        for step in range(7, 30):
            clock.advance(30.0)
            sink.write({"step": step})
    except MetricsOutage:
        outage_raised = True
    report.check(
        outage_raised, "outage past the grace window raises typed MetricsOutage"
    )

    # -- message chaos vs at-least-once consumers -----------------------
    chaos_q = ChaosQueue(
        InMemoryQueue("chaos", clock=clock),
        seed=seed,
        drop_rate=0.1,
        delay_rate=0.2,
        delay_ops=2,
        duplicate_rate=0.2,
        reorder=True,
    )
    sent = 30
    for i in range(sent):
        chaos_q.send({"event": "worker-setup", "id": i})
    seen: set[int] = set()
    deliveries = 0
    for _sweep in range(50):
        messages = chaos_q.receive(max_messages=10, visibility_timeout_s=60.0)
        if not messages and not chaos_q._held:
            break
        for msg in messages:
            deliveries += 1
            seen.add(int(msg.body["id"]))
            chaos_q.delete(msg.receipt)
    chaos_q.flush_held()
    for _sweep in range(10):
        messages = chaos_q.receive(max_messages=10, visibility_timeout_s=60.0)
        if not messages:
            break
        for msg in messages:
            deliveries += 1
            seen.add(int(msg.body["id"]))
            chaos_q.delete(msg.receipt)
    report.check(
        len(seen) == sent - chaos_q.dropped,
        "every non-dropped message delivered despite delay/dup/reorder",
    )
    report.check(
        deliveries >= len(seen), "duplicates deduplicated by consumers"
    )
    report.details.update(
        dropped=chaos_q.dropped,
        delayed=chaos_q.delayed,
        duplicated=chaos_q.duplicated,
        deliveries=deliveries,
    )
    return report


# --- flaky-rpc ---------------------------------------------------------------


def flaky_rpc(seed: int) -> ScenarioReport:
    """Retryable error bursts against the unified RetryPolicy (jittered,
    clock-injected, deadline-safe) and a hard outage against the circuit
    breaker wired into GoogleAuthTransport."""
    from deeplearning_cfn_tpu_torch.provision.gcp_transport import (
        GCPAPIError,
        GoogleAuthTransport,
    )
    from deeplearning_cfn_tpu_torch.utils.resilience import CircuitBreaker, CircuitOpen

    report = ScenarioReport("flaky-rpc", seed)

    # -- burst phase: every call must eventually succeed ----------------
    clock = RecordingClock()
    opener = FlakyOpener(seed=seed, error_rate=0.45, reset_rate=0.15)
    transport = GoogleAuthTransport(
        project="chaos",
        token_provider=lambda: ("tok", 1e18),
        opener=opener,
        max_retries=8,
        backoff_s=0.05,
        clock=clock,
        seed=seed,
    )
    calls = 20
    successes = 0
    for i in range(calls):
        try:
            out = transport("GET", f"projects/p/locations/z/nodes/n{i}", None)
            successes += 1 if out == {"ok": True} else 0
        except GCPAPIError:
            pass
    report.check(
        successes == calls,
        "all calls succeeded through seeded 429/500/503/reset bursts",
    )
    base, cap = 0.05, 0.05 * 2**8
    report.check(
        all(base <= s <= cap for s in clock.sleeps),
        "every backoff sleep within jitter bounds [base_s, cap_s]",
    )
    report.check(
        len(set(round(s, 6) for s in clock.sleeps)) > 1
        if len(clock.sleeps) > 4
        else True,
        "backoff is jittered (not a fixed exponential ladder)",
    )
    # The clock's own sum: its sleeps added one by one from 0.0, as the
    # clock adds them.  ``sum()`` of floats rounds differently since Python
    # 3.12 (compensated summation): one ulp off on seed 0.
    waited = 0.0
    for sleep in clock.sleeps:
        waited += sleep
    report.check(
        clock.now() == waited,
        "all waiting happened on the injected clock (no real sleeps)",
    )

    # -- hard-down phase: the breaker must fail fast --------------------
    degraded_before = _degraded_event_count()
    hard_opener = FlakyOpener(seed=seed + 1, hard_down=True)
    breaker = CircuitBreaker(
        name="gcp-control-plane",
        failure_threshold=3,
        reset_after_s=60.0,
        clock=clock,
    )
    down = GoogleAuthTransport(
        project="chaos",
        token_provider=lambda: ("tok", 1e18),
        opener=hard_opener,
        max_retries=1,
        backoff_s=0.01,
        clock=clock,
        seed=seed,
        breaker=breaker,
    )
    outcomes: list[str] = []
    for i in range(6):
        try:
            down("GET", f"projects/p/locations/z/nodes/d{i}", None)
            outcomes.append("ok")
        except CircuitOpen:
            outcomes.append("circuit-open")
        except GCPAPIError:
            outcomes.append("api-error")
    requests_when_open = len(hard_opener.requests)
    report.check(
        outcomes == ["api-error"] * 3 + ["circuit-open"] * 3,
        "breaker tripped after 3 consecutive outages, then failed fast",
    )
    report.check(
        requests_when_open == 3 * 2,
        "no HTTP requests issued while the circuit is open",
    )
    report.check(
        _degraded_event_count() == degraded_before + 1,
        "breaker trip published a degraded event to the obs plane",
    )
    # -- half-open probe ------------------------------------------------
    clock.advance(61.0)
    try:
        down("GET", "projects/p/locations/z/nodes/probe", None)
        probe_outcome = "ok"
    except GCPAPIError:
        probe_outcome = "api-error"
    except CircuitOpen:
        probe_outcome = "circuit-open"
    report.check(
        probe_outcome == "api-error"
        and len(hard_opener.requests) == requests_when_open + 2
        and breaker.state == "open",
        "after cooldown exactly one probe ran, failed, and re-opened the circuit",
    )
    report.details.update(
        burst_requests=len(opener.requests),
        retries=len(opener.requests) - calls,
        backoff_sleeps=len(clock.sleeps),
        virtual_wait_s=round(sum(clock.sleeps), 6),
        hard_down_requests=len(hard_opener.requests),
    )
    return report


# --- slow-disk ---------------------------------------------------------------


def slow_disk(seed: int) -> ScenarioReport:
    """Torn and slow checkpoint writes: the atomic protocol must make
    torn writes unobservable, and the fallback chain must keep absorbing
    checkpoints (degrading local -> objectstore) instead of failing."""
    from deeplearning_cfn_tpu_torch.provision.objectstore import LocalObjectStore
    from deeplearning_cfn_tpu_torch.train.checkpoint import (
        FallbackCheckpointer,
        ObjectStoreCheckpointer,
        StateCheckpointer,
    )

    report = ScenarioReport("slow-disk", seed)
    root = Path(tempfile.mkdtemp(prefix="dlcfn-chaos-"))
    try:
        clock = FakeClock()
        torn = TornDisk(seed=seed, fail_rate=0.6)
        local = StateCheckpointer(root / "local", io=torn)
        remote = ObjectStoreCheckpointer(
            store=LocalObjectStore(root=root / "bucket")
        )
        degraded_before = _degraded_event_count()
        chain = FallbackCheckpointer(
            tiers=[("local", local), ("objectstore", remote)],
            failure_threshold=3,
            reset_after_s=1_000.0,
            clock=clock,
        )
        tiers_used: list[str] = []
        steps = 12
        for step in range(1, steps + 1):
            tiers_used.append(chain.save(step, {"step": step, "loss": 0.5 / step}))
        report.check(
            len(tiers_used) == steps,
            "every checkpoint landed on some tier (no failed saves escaped)",
        )
        report.check(torn.torn > 0, "torn writes actually injected")
        restored = chain.restore_latest()
        report.check(
            restored is not None and restored[1] == steps,
            "restore_latest returns the newest checkpoint across tiers",
        )
        report.check(
            restored is not None and restored[0]["step"] == steps,
            "restored state is intact (content hash verified)",
        )
        # Every checkpoint visible on the local tier must verify: torn
        # writes may only ever leave temp files, never half a committed
        # checkpoint.
        local_ok = all(
            local.io.read_bytes(local._file(s)) and local.restore_latest()
            for s in local.steps()
        )
        committed = list((root / "local").glob("state-*.json"))
        temps = list((root / "local").glob(".state-*"))
        report.check(
            local_ok and not temps,
            "no torn bytes observable: committed files verify, temps cleaned",
        )
        # Accounting invariant: the local tier's save count equals its
        # successful writes (attempted minus torn), and everything else
        # fell through to the objectstore — fallback fires exactly when
        # the local tier failed or its breaker quarantined it, never
        # spuriously.
        report.check(
            tiers_used.count("local") == torn.writes - torn.torn
            and tiers_used.count("objectstore")
            == steps - tiers_used.count("local"),
            "fallback engaged exactly when the local tier failed or was quarantined",
        )
        if chain.breaker("local").state != "closed":
            report.check(
                _degraded_event_count() > degraded_before,
                "local-tier breaker trip published a degraded event",
            )

        # -- slow disk: latency consumes virtual, not wall, time --------
        slow = SlowDisk(clock=clock, latency_s=7.0)
        slow_ck = StateCheckpointer(root / "slow", io=slow)
        t0 = clock.now()
        for step in (1, 2, 3):
            slow_ck.save(step, {"step": step})
        report.check(
            clock.now() - t0 == 21.0,
            "slow-disk latency consumed injected-clock time only",
        )
        report.check(
            slow_ck.restore_latest() == ({"step": 3}, 3),
            "slow writes still commit atomically and restore cleanly",
        )
        report.details.update(
            tiers_used=tiers_used,
            torn_writes=torn.torn,
            total_writes=torn.writes,
            local_steps=local.steps(),
        )
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return report


# --- slice-loss-live ---------------------------------------------------------

def _slice_loss_live_rank(seed: int, root: str, device: str) -> None:
    """One rank of ``slice-loss-live`` (started with the cluster contract's
    env), its trainers on ``device`` (``cuda``: the card of index rank mod
    cards; the process group is gloo either way, as the coordinator's and
    DCP's groups are): the straight, live and fallback runs, its results as JSON in
    ``<root>/rank<id>.json``.  A rank of the lost slice leaves each run at
    the boundary and waits at the store until rank 0 is done."""
    import itertools

    import torch
    import torch.distributed as dist

    from deeplearning_cfn_tpu_torch.analysis.schedules import VirtualClock, interleavings
    from deeplearning_cfn_tpu_torch.cluster.contract import ClusterContract
    from deeplearning_cfn_tpu_torch.cluster.elasticity import ElasticityController, GroupPolicy
    from deeplearning_cfn_tpu_torch.cluster.recovery import LiveReshardManager
    from deeplearning_cfn_tpu_torch.parallel.mesh import (
        MeshSpec,
        data_group,
        hybrid_mesh_for_slices,
    )
    from deeplearning_cfn_tpu_torch.provision.events import EventBus, EventKind, LifecycleEvent
    from deeplearning_cfn_tpu_torch.train.checkpoint import Checkpointer
    from deeplearning_cfn_tpu_torch.train.data import SyntheticDataset
    from deeplearning_cfn_tpu_torch.train.reshard import (
        LiveReshardCoordinator,
        mesh_topology,
        rescale_grad_accum,
        survivor_ranks,
    )

    rank = _rank_setup(device)
    store = dist.distributed_c10d._get_default_store()

    origin = ClusterContract.build(
        cluster_name="chaos-live", coordinator_ip="10.0.0.1",
        other_worker_ips=["10.0.0.2", "10.0.0.3", "10.0.0.4"], chips_per_worker=1,
        storage_mount="/mnt/none",
        slices={"s0": ["10.0.0.1", "10.0.0.2"], "s1": ["10.0.0.3", "10.0.0.4"]})

    def mesh_for(contract):
        n = contract.slices_count
        return hybrid_mesh_for_slices(n, MeshSpec(fsdp=contract.total_chips // n), "dp",
                                      device_type=device,
                                      ranks=survivor_ranks(origin, contract))

    def make_trainer(mesh, accum: int = 1):
        return _mlp_trainer(mesh, device, accum=accum)

    die_at = 3 + seed % 3
    dataset = lambda: SyntheticDataset(  # noqa: E731 - a fresh iterator a run
        shape=(8, 8, 1), num_classes=10, batch_size=32, seed=seed)
    order = list(interleavings(["10.0.0.3", "10.0.0.4", "10.0.0.3"], count=1, seed=seed)[0])

    def make_cluster(vclock):
        class Backend:
            """Event plane only: terminate handling never describes or launches."""

            def __init__(self):
                self.events = EventBus()

        controller = ElasticityController(backend=Backend(), coordinator_queue_name="coord",
                                          slice_loss_window_s=10.0, clock=vclock)
        controller.register(GroupPolicy("s0", 1, "sig-s0", coordinator=True))
        controller.register(GroupPolicy("s1", 1, "sig-s1"))
        controller.attach()
        manager = LiveReshardManager(origin)
        manager.attach(controller)
        return controller, manager

    def eventful(src, controller, vclock):
        """Publish the slice-s1 terminate burst while batch ``die_at`` is
        made, then advance past the debounce window."""
        for i, b in enumerate(src):
            if i == die_at:
                for ip in order:
                    controller.backend.events.publish(LifecycleEvent(
                        kind=EventKind.INSTANCE_TERMINATE, group="s1", instance_id=ip,
                        detail={"reason": "preempted"}))
                    vclock.advance(0.5)
                vclock.advance(11.0)
            yield b

    def done(key: str, left: bool) -> None:
        if left:
            store.wait([key])
        elif rank == 0:
            store.set(key, "done")

    out: dict[str, Any] = {"rank": rank, "die_at": die_at, "order": order}
    trainer = make_trainer(mesh_for(origin))
    _, out["straight"] = trainer.fit(trainer.init(seed=seed), dataset().batches(TOTAL_STEPS),
                                     steps=TOTAL_STEPS, prefetch=0)

    vclock = VirtualClock()
    controller, manager = make_cluster(vclock)
    coordinator = LiveReshardCoordinator(manager=manager, mesh_for=mesh_for,
                                         flush=controller.flush_slice_losses, clock=vclock)
    trainer = make_trainer(mesh_for(origin))
    before = {k: _journal_count(k) for k in ("slice_loss_coalesced", "reshard",
                                             "grad_accum_rescaled", "reshard_fallback")}
    state, losses = trainer.fit(trainer.init(seed=seed),
                                eventful(dataset().batches(TOTAL_STEPS), controller, vclock),
                                steps=TOTAL_STEPS, prefetch=0, reshard=coordinator)
    out["live"] = {"losses": losses, "step": state.step, "left": coordinator.departed,
                   "live_total": coordinator.live_total,
                   "fallback_total": coordinator.fallback_total,
                   "journal": {k: _journal_count(k) - n for k, n in before.items()},
                   "topology": mesh_topology(trainer.mesh),
                   "slices": manager.contract.slices_count,
                   "degraded": manager.contract.degraded,
                   "grad_accum": trainer.config.grad_accum_steps,
                   "paused_at": [r.step for r in coordinator.records]}
    done("slice-loss-live/live", coordinator.departed)

    vclock = VirtualClock()
    controller, manager = make_cluster(vclock)
    forced = LiveReshardCoordinator(manager=manager, mesh_for=mesh_for,
                                    flush=controller.flush_slice_losses, clock=vclock,
                                    force_fallback=True)
    ck = Checkpointer(Path(root) / "ckpt", interval_s=None, every_steps=1, async_save=False)
    trainer = make_trainer(mesh_for(origin))
    n_fallback = _journal_count("reshard_fallback")
    state, losses1 = trainer.fit(trainer.init(seed=seed),
                                 eventful(dataset().batches(TOTAL_STEPS), controller, vclock),
                                 steps=TOTAL_STEPS, prefetch=0, checkpointer=ck, reshard=forced)
    ck.close()
    fallback = {"losses1": losses1, "left": forced.departed,
                "pending": forced.fallback_pending, "total": forced.fallback_total,
                "journaled": _journal_count("reshard_fallback") - n_fallback}
    if not forced.departed:
        # The existing restore path on the topology the coordinator derived:
        # a fresh trainer on the survivors' mesh, DCP restoring the 4-rank
        # checkpoint onto it, over a checkpoint group of the survivors alone.
        mesh2 = mesh_for(forced.fallback_contract)
        trainer2 = make_trainer(mesh2, rescale_grad_accum(1, RANKS, int(mesh2.size())))
        ck2 = Checkpointer(Path(root) / "ckpt", interval_s=None, async_save=False,
                           process_group=data_group(mesh2))
        state2, restore_step = ck2.restore_latest(trainer2.init(seed=seed + 1))
        state2, losses2 = trainer2.fit(
            state2, itertools.islice(dataset().batches(TOTAL_STEPS), restore_step, None),
            steps=TOTAL_STEPS - restore_step, prefetch=0)
        ck2.close()
        fallback.update(restore_step=restore_step, losses2=losses2, step=state2.step,
                        contract_slices=forced.fallback_contract.slices_count)
    out["fallback"] = fallback
    Path(root, f"rank{rank}.json").write_text(json.dumps(out))
    done("slice-loss-live/fallback", forced.departed)
    dist.destroy_process_group()


def _spawn_ranks(seed: int, root: str, device: str, entry: str = "--slice-loss-live-rank",
                 extra: tuple[str, ...] = ()) -> list[dict[str, Any]]:
    """Run a scenario's ranks (``entry``: the flag of this module's rank
    function) as processes of one gloo group on this host; each rank's
    results.  A rank that fails raises."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = str(Path(__file__).resolve().parents[2])
    procs = []
    for i in range(RANKS):
        env = dict(os.environ, DEEPLEARNING_WORKERS_COUNT=str(RANKS), DLCFN_PROCESS_ID=str(i),
                   DEEPLEARNING_COORDINATOR=f"127.0.0.1:{port}", OMP_NUM_THREADS="1",
                   PYTHONFAULTHANDLER="1",
                   PYTHONPATH=os.pathsep.join(filter(None, [repo, os.environ.get("PYTHONPATH")])))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "deeplearning_cfn_tpu_torch.chaos.scenarios",
             entry, str(seed), root, device, *extra],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errors = []
    try:
        for i, p in enumerate(procs):
            _, err = p.communicate(timeout=JOIN_TIMEOUT_S)
            if p.returncode:
                errors.append(f"rank {i} exited {p.returncode}:\n{err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if errors:
        name = entry.removeprefix("--").removesuffix("-rank")
        raise RuntimeError(f"a {name} rank failed:\n" + errors[0])
    return [json.loads(Path(root, f"rank{i}.json").read_text()) for i in range(RANKS)]


def slice_loss_live(seed: int, device: str = "cuda") -> ScenarioReport:
    """A slice dies mid-run; training must survive WITHOUT a restart.

    Drives the real stack end to end on four gloo ranks: FSDP2
    trainers on a 2-slice hybrid mesh (2 x fsdp 2), the elasticity
    controller's terminate debouncer on a virtual clock, the
    LiveReshardManager's surviving-topology derivation, and the live
    reshard in ``Trainer.fit``'s pause seam.  Invariants: the 3-event
    terminate burst (with a duplicate) coalesces into exactly ONE reshard;
    every rank pauses at that boundary and the lost slice's ranks leave
    there; the step count is monotone with no step lost or repeated; grad
    accumulation rescales 1 -> 2 so the global batch is preserved on half
    the ranks; the loss curve matches an uninterrupted 4-rank run within
    tolerance.  A second pass forces the fallback: the coordinator must
    journal ``reshard_fallback``, stop the episode cleanly, and the
    checkpoint/restore path onto the surviving mesh must line up with the
    same straight run.  The ranks train on ``device`` (``cuda`` unless the
    caller asks for the CPU).
    """
    from deeplearning_cfn_tpu_torch.device import resolve_device

    device = resolve_device(device).type
    report = ScenarioReport("slice-loss-live", seed)
    root = tempfile.mkdtemp(prefix="dlcfn-chaos-live-")
    try:
        ranks = _spawn_ranks(seed, root, device)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    r0 = ranks[0]
    die_at, straight, live, fb = r0["die_at"], r0["straight"], r0["live"], r0["fallback"]
    survivors, leavers = ranks[:2], ranks[2:]
    report.check(
        len(live["losses"]) == TOTAL_STEPS and live["step"] == TOTAL_STEPS,
        "no restart, no lost step: one fit() call trained every step "
        "through the slice death (monotone step count)",
    )
    report.check(
        live["live_total"] == 1 and live["fallback_total"] == 0,
        "the 3-event terminate burst (incl. a duplicate) coalesced into "
        "exactly one live reshard and zero fallbacks",
    )
    report.check(
        live["journal"]["slice_loss_coalesced"] == 1 and live["journal"]["reshard"] == 1,
        "journal shows one coalesced slice loss and one reshard event",
    )
    report.check(
        all(r["live"]["paused_at"] == [die_at] for r in survivors)
        and all(r["live"]["left"] and len(r["live"]["losses"]) == die_at for r in leavers),
        "every rank paused at the same step boundary; the lost slice's ranks "
        "left there (one decision, broadcast from the coordinator rank)",
    )
    report.check(
        live["topology"] == {"devices": 2, "axes": {"fsdp": 2}}
        and live["slices"] == 1 and live["degraded"],
        "trainer rebound to the surviving 2-rank fsdp mesh and the "
        "contract degraded to the single surviving slice",
    )
    report.check(
        live["grad_accum"] == 2 and live["journal"]["grad_accum_rescaled"] == 1,
        "grad accumulation rescaled 1 -> 2 (journaled), preserving the "
        "global batch of 32 on half the ranks",
    )
    report.check(
        _close(live["losses"][:die_at], straight[:die_at], 1e-5, 1e-6),
        "pre-loss losses identical to the uninterrupted run",
    )
    report.check(
        _close(live["losses"], straight, 5e-3, 1e-4),
        "loss continuity across the reshard: full curve matches the "
        "uninterrupted 4-rank run within tolerance",
    )
    report.check(
        fb["pending"] and fb["total"] == 1 and fb["journaled"] == 1,
        "forced fallback journaled reshard_fallback and stopped the "
        "episode cleanly at the pause boundary",
    )
    report.check(
        len(fb["losses1"]) == die_at,
        "fallback episode kept every loss up to the pause (graceful "
        "stop, not an exception)",
    )
    report.check(
        fb.get("restore_step") == die_at,
        "checkpoint tier held the pause step: no training step lost "
        "across the fallback",
    )
    fallback_losses = fb["losses1"] + fb.get("losses2", [])
    report.check(
        len(fallback_losses) == TOTAL_STEPS and fb.get("step") == TOTAL_STEPS,
        "fallback path completed the run: restore episode finished "
        "the remaining steps with a monotone step count",
    )
    report.check(
        _close(fallback_losses, straight, 5e-3, 1e-4),
        "loss continuity across the fallback: combined curve matches "
        "the uninterrupted run within tolerance",
    )
    report.details.update(
        die_at_step=die_at,
        burst_order=r0["order"],
        grad_accum_after=live["grad_accum"],
        post_mesh=live["topology"],
        straight_losses=[round(v, 6) for v in straight],
        live_losses=[round(v, 6) for v in live["losses"]],
        fallback_losses=[round(v, 6) for v in fallback_losses],
        fallback_restore_step=fb.get("restore_step", -1),
    )
    return report


# --- data-reshard-live -------------------------------------------------------

DATA_STEPS = 8


def id_shards(root: Path, seed: int) -> tuple[list[Path], Any, int]:
    """Six uneven DLC1 shards whose records carry their global id in ``y``
    (so "every record exactly once" is literally ``sorted(seen) ==
    range(total)``): the paths, the spec and the record count."""
    import numpy as np

    from deeplearning_cfn_tpu_torch.train.records import Field, RecordSpec, write_records

    spec = RecordSpec((Field("x", "uint8", (2,)), Field("y", "int32", ())))
    sizes = [17 + (3 * sid + seed) % 7 for sid in range(6)]  # uneven
    paths: list[Path] = []
    gid = 0
    for sid, n in enumerate(sizes):
        recs = []
        for _ in range(n):
            recs.append(spec.encode(x=np.array([gid % 251, gid % 7], dtype=np.uint8),
                                    y=np.int32(gid)))
            gid += 1
        p = root / f"shard-{sid:02d}.dlc"
        write_records(p, spec, recs)
        paths.append(p)
    return paths, spec, gid


def _data_contract() -> Any:
    """JAX's four-host, two-slice contract of the data plane (2 chips a
    host there; only its hosts matter to the plane)."""
    from deeplearning_cfn_tpu_torch.cluster.contract import ClusterContract

    return ClusterContract.build(
        cluster_name="chaos-data", coordinator_ip="10.0.0.1",
        other_worker_ips=["10.0.0.2", "10.0.0.3", "10.0.0.4"], chips_per_worker=2,
        storage_mount="/mnt/none",
        slices={"s0": ["10.0.0.1", "10.0.0.2"], "s1": ["10.0.0.3", "10.0.0.4"]})


def plane_consumption(paths: list[Path], spec: Any, seed: int) -> tuple[dict[str, list[int]], dict]:
    """``data-reshard-live``'s phase 1 run of the plane: two interleaved
    rounds of batches across all four hosts, then s1 dies mid-epoch with
    partially-read shards on both sides and the survivors drain the epoch.
    The ids each host consumed, in order, and the plane's progress
    snapshot."""
    from deeplearning_cfn_tpu_torch.train.datastream import DataStreamPlane

    contract = _data_contract()
    plane = DataStreamPlane(contract, paths, spec, batch_size=5, seed=seed, loop=False)
    ids: dict[str, list[int]] = {h: [] for h in plane.hosts}
    iters = {h: plane.stream(h).batches() for h in plane.hosts}
    for _ in range(2):
        for h in list(plane.hosts):
            b = next(iters[h], None)
            if b is not None:
                ids[h].extend(int(v) for v in b.y)
    plane.reshard(contract.surviving(["s1"]))
    for h in tuple(plane.hosts):
        for b in iters[h]:
            ids[h].extend(int(v) for v in b.y)
    return ids, plane.journal_progress()


def train_shards(root: Path, seed: int) -> list[Path]:
    """The training records: 2 shards x 128 = 256 = exactly 8 batches of 32
    (``SyntheticDataset`` of seeds ``seed * 7 + i``), so a stop/resume seam
    lands mid-epoch and the run ends on the boundary."""
    from deeplearning_cfn_tpu_torch.train.data import SyntheticDataset
    from deeplearning_cfn_tpu_torch.train.records import RecordSpec, write_dataset

    spec = RecordSpec.classification((8, 8, 1), "float32")
    paths = []
    for i in range(2):
        ds = SyntheticDataset(shape=(8, 8, 1), num_classes=10, batch_size=32, seed=seed * 7 + i)
        p = root / f"train-{i}.dlc"
        write_dataset(p, spec, ds.batches(4), 4)
        paths.append(p)
    return paths


def train_stream(paths: list[Path], seed: int, state=None) -> Any:
    """The single-host stream every rank reads whole (the global batch of
    32; each rank's trainer takes its part), so the record order, and the
    loss curve, do not depend on the topology."""
    from deeplearning_cfn_tpu_torch.train.datastream import HostShardStream
    from deeplearning_cfn_tpu_torch.train.records import RecordSpec

    return HostShardStream(paths, RecordSpec.classification((8, 8, 1), "float32"), 32,
                           host="10.0.0.1", hosts=("10.0.0.1",), seed=seed, loop=True,
                           state=state)


def _mlp_model_fn(weights: str | None = None) -> Callable:
    """The JAX scenarios' ``_MLP`` (fc1 64 -> 256, fc2 256 -> 256, head 256 ->
    10) as a ``Trainer`` model function: fc2's 256 x 256 weight clears the
    FSDP rule's floor, so a reshard moves genuinely sharded arrays.  Its
    weights are normal / sqrt(fan_in) with zero biases from the generator,
    or the state dict at ``weights`` (JAX's draw through
    ``interop.dense_params_from_jax``); built on ``meta`` (no generator),
    it stays unfilled."""
    import torch
    from torch import nn

    class MLP(nn.Module):
        def __init__(self, generator=None):
            super().__init__()
            self.fc1, self.fc2, self.head = (nn.Linear(a, b) for a, b in
                                             ((64, 256), (256, 256), (256, 10)))
            if generator is not None:
                with torch.no_grad():
                    for layer in (self.fc1, self.fc2, self.head):
                        fan_in = layer.weight.shape[1]
                        layer.weight.copy_(torch.randn(layer.weight.shape, generator=generator)
                                           * fan_in**-0.5)
                        layer.bias.zero_()

        def forward(self, x):
            x = x.reshape(x.shape[0], -1)
            return self.head(torch.relu(self.fc2(torch.relu(self.fc1(x)))))

    loaded = torch.load(weights, map_location="cpu") if weights else None

    def model_fn(generator=None):
        model = MLP(generator)
        if loaded is not None and generator is not None:
            model.load_state_dict(loaded)
        return model

    return model_fn


def _mlp_trainer(mesh, device: str, weights: str | None = None, accum: int = 1) -> Any:
    """The scenarios' FSDP trainer of the MLP: AdamW at 1e-3, f32."""
    from deeplearning_cfn_tpu_torch.train.trainer import Trainer, TrainerConfig

    return Trainer(_mlp_model_fn(weights),
                   TrainerConfig(optimizer="adamw", learning_rate=1e-3, strategy="fsdp",
                                 matmul_precision="float32", log_every=1,
                                 grad_accum_steps=accum),
                   device=device, mesh=mesh)


def _rank_setup(device: str) -> int:
    """A rank's process group (gloo, from the cluster contract's env) and
    card; its rank."""
    import torch

    from deeplearning_cfn_tpu_torch.examples.common import maybe_init_distributed

    torch.set_num_threads(1)
    rank = maybe_init_distributed("cpu")  # gloo
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    return rank


def _rank_facts(device: str) -> dict[str, Any]:
    """Where this rank trained (its card, or the CPU) and the port's kernel
    launches it made (the MLP's path runs none)."""
    import torch

    from deeplearning_cfn_tpu_torch.ops._kernels import launch_counts

    return {"device": f"cuda:{torch.cuda.current_device()}" if device == "cuda" else "cpu",
            "kernel_launches": {k: n for k, n in launch_counts.items() if n}}


def _ranks_observed(ranks: list[dict]) -> dict[str, Any]:
    """The ranks' devices and their kernel launches, summed."""
    launched: dict[str, int] = {}
    for r in ranks:
        for k, n in r["kernel_launches"].items():
            launched[k] = launched.get(k, 0) + n
    return {"devices": [r["device"] for r in ranks], "kernel_launches": launched}


def _data_reshard_live_rank(seed: int, root: str, device: str, weights: str) -> None:
    """One rank of ``data-reshard-live``'s phase 2 (the cluster contract's
    env), its trainers on ``device`` over the 2 x fsdp 2 mesh: the unbroken
    run, the run stopped at step ``stop`` with the async sharded
    checkpointer saving every step (this rank's own directory), and the run
    restored from it.  Results as JSON in ``<root>/rank<id>.json``."""
    import torch.distributed as dist

    from deeplearning_cfn_tpu_torch.parallel.mesh import MeshSpec, hybrid_mesh_for_slices
    from deeplearning_cfn_tpu_torch.train.datastream import AsyncShardedCheckpointer
    from deeplearning_cfn_tpu_torch.train.reshard import mesh_topology

    rank = _rank_setup(device)
    tpaths = sorted(Path(root).glob("train-*.dlc"))
    mesh = hybrid_mesh_for_slices(2, MeshSpec(fsdp=2), "dp", device_type=device)
    stop = 3 + seed % 3

    def trainer():
        return _mlp_trainer(mesh, device, weights or None)

    out: dict[str, Any] = {"rank": rank, "stop": stop, "topology": mesh_topology(mesh)}
    t = trainer()
    _, out["straight"] = t.fit(t.init(seed=seed), train_stream(tpaths, seed).batches(),
                               steps=DATA_STEPS, prefetch=0)

    writes_before = _datastream_event_count("checkpoint_write")
    t = trainer()
    stream = train_stream(tpaths, seed)
    ck = AsyncShardedCheckpointer(Path(root) / f"ackpt-rank{rank}", every_steps=1, n_shards=3)
    _, out["losses1"] = t.fit(t.init(seed=seed), stream.batches(), steps=stop, prefetch=0,
                              checkpointer=ck, datastream=stream)
    ck.wait()
    out["latest"] = ck.latest_step()
    out["writes"] = _datastream_event_count("checkpoint_write") - writes_before
    t = trainer()
    restored = ck.restore_latest(template=t.init(seed=seed))
    out["restored"] = restored is not None
    if restored is not None:
        state, out["restore_step"] = restored
        out["stream_host"] = (ck.last_stream_state or {}).get("host")
        stream = train_stream(tpaths, seed, state=ck.last_stream_state)
        out["records_at_resume"] = stream.records_total
        _, out["losses2"] = t.fit(state, stream.batches(), steps=DATA_STEPS - stop, prefetch=0)
    ck.close()
    out.update(_rank_facts(device))
    Path(root, f"rank{rank}.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


def data_reshard_live(seed: int, device: str = "cuda", weights: str | None = None
                      ) -> ScenarioReport:
    """The data plane survives a mid-epoch slice loss exactly-once, and a
    run resumed from a v3 envelope reproduces the unbroken loss sequence
    bit-identically.

    Phase 1 drives :class:`~deeplearning_cfn_tpu_torch.train.datastream.
    DataStreamPlane` over REAL DLC1 shard files in this process: four hosts
    (two slices) interleave batches, slice s1 dies mid-epoch, and
    ``plane.reshard(contract.surviving(["s1"]))`` redistributes the
    epoch's unfinished work over the survivors.  Invariants: every record
    is consumed exactly once (zero dropped, zero duplicated — asserted on
    record ids baked into the shards), the per-host shard assignment is an
    exact partition, and the whole consumption order is byte-deterministic
    per seed (the run replays identically).

    Phase 2 trains the FSDP MLP from the record stream on four gloo ranks
    (2 slices x fsdp 2, on ``device``), with
    :class:`~deeplearning_cfn_tpu_torch.train.datastream.
    AsyncShardedCheckpointer` capturing the stream cursor in the v3
    envelope every step (``prefetch=0``, the bit-exact-resume mode).  A run
    stopped at step K and restored — state from the sharded JSON codec,
    stream from ``last_stream_state`` — must reproduce the uninterrupted
    run's loss sequence EXACTLY, float for float.  A writer crashed at the
    manifest commit point (ManifestCrashDisk) must leave shard litter but
    no manifest, the previous checkpoint fully restorable, and the recorded
    v3 topology must gate a cross-topology restore.  ``weights`` is a state
    dict for the MLP (the port's own draw from ``seed`` without it).
    """
    import numpy as np

    from deeplearning_cfn_tpu_torch.chaos.injectors import ManifestCrashDisk
    from deeplearning_cfn_tpu_torch.device import resolve_device
    from deeplearning_cfn_tpu_torch.train.checkpoint import TopologyMismatch
    from deeplearning_cfn_tpu_torch.train.datastream import (
        AsyncShardedCheckpointer,
        assign_shards,
    )

    device = resolve_device(device).type
    report = ScenarioReport("data-reshard-live", seed)
    root = Path(tempfile.mkdtemp(prefix="dlcfn-chaos-data-"))
    try:
        # --- phase 1: exactly-once over a live reshard -------------------
        paths, spec, total = id_shards(root, seed)
        sizes = [17 + (3 * sid + seed) % 7 for sid in range(6)]

        assigned = assign_shards(_data_contract().datastream_hosts(), len(paths), seed, 0)
        report.check(
            sorted(s for w in assigned.values() for s in w) == list(range(len(paths))),
            "per-host shard assignment is an exact partition of the "
            "shard set (every shard owned by exactly one host)",
        )
        reshard_before = _datastream_event_count("reshard")
        ids1, snap1 = plane_consumption(paths, spec, seed)
        ids2, _snap2 = plane_consumption(paths, spec, seed)
        seen = sorted(v for host_ids in ids1.values() for v in host_ids)
        report.check(
            seen == list(range(total)),
            "every record consumed exactly once across the live reshard "
            "(zero dropped, zero duplicated, including the lost hosts' "
            "pre-loss reads)",
        )
        report.check(
            ids1 == ids2,
            "consumption order is byte-deterministic per seed: the full "
            "run (including the reshard splice) replays identically",
        )
        report.check(
            _datastream_event_count("reshard") - reshard_before == 2,
            "each reshard journaled exactly one datastream reshard event",
        )
        report.check(
            snap1["records_total"] == total and snap1["hosts"] == 2 and snap1["reshards"] == 1,
            "plane snapshot agrees with ground truth: all records "
            "counted, two survivors, one reshard",
        )

        # --- phase 2: bit-identical resume from the v3 envelope ----------
        train_shards(root, seed)
        ranks = _spawn_ranks(seed, str(root), device, "--data-reshard-live-rank",
                             (weights or "",))
        r0 = ranks[0]
        report.observed.update(_ranks_observed(ranks))
        stop, straight, losses1 = r0["stop"], r0["straight"], r0["losses1"]
        losses2 = r0.get("losses2", [])
        report.check(
            losses1 == straight[:stop],
            "pre-stop losses bit-identical to the uninterrupted run "
            "(same records, same arithmetic)",
        )
        report.check(
            r0["latest"] == stop and r0["writes"] >= 1,
            "the background writer committed the stop-step manifest "
            "(journaled checkpoint_write) without ever blocking a step",
        )
        report.check(r0["restored"], "v3 manifest restored")
        report.check(
            r0.get("restore_step") == stop and r0.get("stream_host") == "10.0.0.1",
            "restore returned the stop step and the envelope's stream "
            "state for the right host",
        )
        report.check(
            r0.get("records_at_resume") == stop * 32,
            "resumed stream cursor sits exactly stop*batch records in — "
            "no replay, no skip",
        )
        report.check(
            losses1 + losses2 == straight
            and all(r["losses1"] + r.get("losses2", []) == straight for r in ranks),
            "resumed run reproduces the unbroken run's loss sequence "
            "bit-identically (exact float equality, the v3 acceptance "
            "bar: JSON codec + stream cursor both lossless)",
        )

        # --- phase 2b: writer crash at the manifest commit point ---------
        disk = ManifestCrashDisk()
        failed_before = _datastream_event_count("checkpoint_write_failed")
        topo = r0["topology"]
        payload = {"w": np.arange(12, dtype=np.float32).reshape(3, 4), "b": np.float32(0.5)}
        ck2 = AsyncShardedCheckpointer(root / "crash", every_steps=1, n_shards=2, io=disk)
        ck2.save(1, payload, mesh_topology=topo, stream_state={"host": "10.0.0.1", "cursor": 1})
        ck2.wait()
        disk.arm()
        ck2.save(2, {"w": payload["w"] + 1.0, "b": np.float32(1.5)})
        ck2.wait()
        report.check(
            ck2.write_failures == 1 and disk.crashes == 1
            and _datastream_event_count("checkpoint_write_failed") - failed_before == 1,
            "the armed crash fired exactly once at the manifest write and "
            "was journaled as checkpoint_write_failed (writer survived)",
        )
        report.check(
            not (root / "crash" / "ckpt-00000002.manifest.json").exists()
            and (root / "crash" / "ckpt-00000002.shard-00-of-02.json").exists(),
            "the crashed step left shard litter but NO manifest: the "
            "commit point never passed",
        )
        template2 = {"w": np.zeros((3, 4), np.float32), "b": np.float32(0.0)}
        r2 = ck2.restore_latest(template=template2, expected_topology=topo)
        report.check(
            r2 is not None and r2[1] == 1 and np.array_equal(np.asarray(r2[0]["w"]), payload["w"])
            and ck2.last_stream_state == {"host": "10.0.0.1", "cursor": 1},
            "the previous checkpoint (state, step, stream state) is "
            "fully restorable after the crash — bit-equal leaves",
        )
        mismatch = False
        try:
            ck2.restore_latest(template=template2,
                               expected_topology={"devices": 4, "axes": {"fsdp": 4}})
        except TopologyMismatch:
            mismatch = True
        report.check(
            mismatch,
            "the recorded v3 mesh topology gates cross-topology restores "
            "(TopologyMismatch, fail-fast)",
        )
        ck2.close()

        report.details.update(
            stop_step=stop,
            total_records=total,
            shard_sizes=sizes,
            straight_losses=[round(v, 6) for v in straight],
            resumed_losses=[round(v, 6) for v in losses1 + losses2],
        )
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return report


# --- straggler ---------------------------------------------------------------


def straggler(seed: int) -> ScenarioReport:
    """One host runs injected-slow steps under seeded cross-host clock
    skew; the merged trace must recover the skews from heartbeat pairs,
    order events correctly, and name exactly the injected straggler."""
    import json
    import random

    from deeplearning_cfn_tpu_torch.obs.recorder import FlightRecorder
    from deeplearning_cfn_tpu_torch.obs.trace_export import (
        chrome_trace,
        merge_journals,
        straggler_table,
    )

    report = ScenarioReport("straggler", seed)
    rng = random.Random(seed)
    hosts = ["host-a", "host-b", "host-c"]
    slow_host = hosts[seed % len(hosts)]
    # Skew magnitude > the 1 s step spacing: a raw-timestamp merge is
    # GUARANTEED to interleave steps wrongly, so correct ordering after
    # alignment is a real proof, not luck.  Virtual clocks throughout —
    # every timestamp below is computed, never read from time.time().
    base = 1_700_000_000.0
    skews = {
        host: round(rng.uniform(2.0, 6.0) * rng.choice((-1, 1)), 6)
        for host in hosts
    }
    n_steps = 8
    slow_steps = set(range(2, 7))  # 5 of 8: a strict slowest-count majority
    slow_extra_ms = 40.0

    root = Path(tempfile.mkdtemp(prefix="dlcfn-chaos-straggler-"))
    try:
        # Supervisor journal (skew 0 = the reference clock): observes
        # each worker's beats 2 s after the true send instant.
        sup = FlightRecorder(path=root / "sup.jsonl")
        for host in hosts:
            for seq, t_send in enumerate((0.0, 10.0, 20.0), start=1):
                sup.record(
                    "heartbeat_observed",
                    ts=round(base + t_send + 2.0, 6),
                    host="sup",
                    pid=1,
                    worker=host,
                    seq=seq,
                    age_s=2.0,
                )
        sup.close()
        # Worker journals: every ts is the TRUE instant plus that host's
        # clock skew (caller fields override the recorder's identity).
        true_durations: dict[str, dict[int, float]] = {}
        for hi, host in enumerate(hosts):
            rec = FlightRecorder(path=root / f"{host}.jsonl")
            for seq, t_send in enumerate((0.0, 10.0, 20.0), start=1):
                rec.record(
                    "heartbeat_sent",
                    ts=round(base + t_send + skews[host], 6),
                    host=host,
                    pid=1,
                    worker=host,
                    seq=seq,
                )
            durations = {}
            for step in range(n_steps):
                dur_ms = 50.0 + hi * 1.0 + step * 0.5
                if host == slow_host and step in slow_steps:
                    dur_ms += slow_extra_ms
                durations[step] = dur_ms
                t_end = base + 100.0 + step * 1.0 + dur_ms / 1e3
                rec.record(
                    "step_time",
                    ts=round(t_end + skews[host], 6),
                    host=host,
                    pid=1,
                    worker=host,
                    profiler="train",
                    step=step,
                    steps=1,
                    total_ms=round(dur_ms, 3),
                    dispatch_ms=round(dur_ms * 0.1, 3),
                    host_ms=round(dur_ms * 0.05, 3),
                )
                rec.record(
                    "span",
                    ts=round(t_end + skews[host], 6),
                    host=host,
                    pid=1,
                    worker=host,
                    span="train_step",
                    seconds=round(dur_ms / 1e3, 6),
                    ok=True,
                )
            true_durations[host] = durations
            rec.close()

        paths = [root / "sup.jsonl"] + [root / f"{h}.jsonl" for h in hosts]

        def step_sequence(events):
            return [
                e["step"] for e in events if e.get("kind") == "step_time"
            ]

        raw_events, _ = merge_journals(paths, align=False)
        raw_seq = step_sequence(raw_events)
        report.check(
            raw_seq != sorted(raw_seq),
            "raw (unaligned) merge interleaves steps out of order — the "
            "injected skew is large enough to matter",
        )

        events, meta = merge_journals(paths, align=True)
        report.check(meta["reference"] == "sup", "supervisor journal is the reference clock")
        offsets = meta["offsets"]
        report.check(
            all(
                abs(offsets.get(host, 0.0) + skews[host]) < 1e-3
                for host in hosts
            ),
            "heartbeat pairs recover every host's clock offset (within 1 ms)",
        )
        aligned_seq = step_sequence(events)
        report.check(
            aligned_seq == sorted(aligned_seq),
            "aligned merge orders every step_time event by true step across hosts",
        )

        table = straggler_table(events)
        slowed_rows = [r for r in table["steps"] if r["step"] in slow_steps]
        report.check(
            bool(slowed_rows)
            and all(
                r["slowest"] == slow_host and r["margin_ms"] >= 30.0
                for r in slowed_rows
            ),
            "every injected-slow step names the slow host with a wide margin",
        )
        report.check(
            all(
                r["margin_ms"] < 10.0
                for r in table["steps"]
                if r["step"] not in slow_steps
            ),
            "steps without injection show no false wide-margin straggler",
        )
        report.check(
            table["top_straggler"] == slow_host,
            "the slowest-count majority names the injected host",
        )

        trace = chrome_trace(events)
        payload = json.dumps(trace, allow_nan=False)
        decoded = json.loads(payload)
        report.check(
            decoded.get("traceEvents") == trace["traceEvents"],
            "trace-event JSON is strict (allow_nan) and round-trips",
        )
        slices = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
        report.check(
            bool(slices)
            and all(
                isinstance(e.get("ts"), (int, float))
                and isinstance(e.get("dur"), (int, float))
                and e.get("dur") >= 0
                and "pid" in e
                and "tid" in e
                for e in slices
            ),
            "every complete (X) slice carries ts/dur/pid/tid",
        )
        processes = {
            e["args"]["name"]
            for e in trace["traceEvents"]
            if e.get("ph") == "M" and e.get("name") == "process_name"
        }
        report.check(
            processes == set(hosts) | {"sup"},
            "one trace process row per journal (3 workers + supervisor)",
        )
    finally:
        shutil.rmtree(root, ignore_errors=True)

    report.details.update(
        slow_host=slow_host,
        slow_steps=sorted(slow_steps),
        skews_s=dict(sorted(skews.items())),
        recovered_offsets_s=dict(sorted(offsets.items())),
        top_straggler=table["top_straggler"],
        slowest_counts=table["slowest_counts"],
        straggler_steps=len(table["steps"]),
        trace_events=len(trace["traceEvents"]),
    )
    return report



# --- serve-replica-loss ------------------------------------------------------


def serve_replica_loss(seed: int, device: str = "cuda", serve_weights: str | None = None
                       ) -> ScenarioReport:
    """A serving replica dies mid-traffic; no accepted request may be lost.

    Drives the real serving plane end-to-end on virtual time: two
    :class:`ServeReplica` engines behind a :class:`ServeFrontEnd` (the tiny
    f32 Llama on ``device``), seeded Poisson traffic from the load
    generator, replica liveness beating a :class:`SimBroker`, and the
    elasticity controller's ``on_instance_loss`` seam wired to the
    front-end's failover.  Mid-run an ``INSTANCE_TERMINATE`` for a
    seed-picked victim kills one replica; its in-flight requests replay
    onto the survivor with their original arrival times.

    Invariants: every accepted request completes (zero loss); greedy
    outputs are identical to an undisturbed single-engine reference run
    (failover is invisible in content, visible only in latency); p99
    per-token latency and p99 TTFT stay inside the SLO even through the
    disruption; the victim's heartbeat goes silent while the survivor
    keeps beating; the failover is journaled exactly once.
    ``serve_weights`` is a state dict for the Llama (the port's seed-0
    weights without it).
    """
    import numpy as np
    import torch

    from deeplearning_cfn_tpu_torch.analysis.schedules import (
        SimBroker,
        SimBrokerConnection,
        VirtualClock,
    )
    from deeplearning_cfn_tpu_torch.cluster.elasticity import ElasticityController, GroupPolicy
    from deeplearning_cfn_tpu_torch.device import resolve_device
    from deeplearning_cfn_tpu_torch.models import llama
    from deeplearning_cfn_tpu_torch.provision.events import EventBus, EventKind, LifecycleEvent
    from deeplearning_cfn_tpu_torch.serve import (
        ContinuousBatchingEngine,
        ServeConfig,
        ServeFrontEnd,
        ServeReplica,
        TrafficConfig,
        run_load,
    )

    # SLOs asserted through the disruption (virtual milliseconds; the
    # traffic model charges 10ms/step + 4ms/prefill, so these bound
    # QUEUEING, deterministically, not host FLOPs).
    slo_per_token_p99_ms = 150.0
    slo_ttft_p99_ms = 250.0

    device = resolve_device(device)
    report = ScenarioReport("serve-replica-loss", seed)
    cfg = llama.LlamaConfig.tiny(vocab_size=64, seq_len=64, dtype=torch.float32)
    model = llama.init_model(cfg, seed=0, device=device)
    if serve_weights:
        model.load_state_dict(torch.load(serve_weights, map_location=device))
    scfg = ServeConfig(num_slots=4, block_size=4, blocks_per_slot=8, prefill_len=16)
    tcfg = TrafficConfig(requests=80, seed=seed)

    def make_engine(clock, name):
        return ContinuousBatchingEngine(model, scfg, clock=clock, name=name, journal=False)

    # --- undisturbed single-engine reference (expected outputs) --------
    ref_clock = VirtualClock()
    reference = run_load(make_engine(ref_clock, "ref"), tcfg, ref_clock)

    # --- live run: 2 replicas, broker liveness, terminate mid-traffic --
    vclock = VirtualClock()
    broker = SimBroker(vclock)

    class _KV:
        """Broker KV verbs a register() needs (a BrokerConnection.set
        stand-in; same key/value contract)."""

        def __init__(self):
            self.table: dict[str, bytes] = {}

        def set(self, key: str, value: bytes) -> None:
            self.table[key] = value

    class _Backend:
        """Event-plane-only backend (the elasticity controller only
        touches .events for terminate handling)."""

        def __init__(self):
            self.events = EventBus()

    kv = _KV()
    replicas = [
        ServeReplica(make_engine(vclock, f"rep{i}"), f"rep{i}", group="serve",
                     connection_factory=lambda: SimBrokerConnection(broker))
        for i in range(2)
    ]
    for r in replicas:
        r.register(kv)
    frontend = ServeFrontEnd(replicas)

    backend = _Backend()
    controller = ElasticityController(backend=backend, coordinator_queue_name="coord",
                                      on_instance_loss=frontend.on_instance_loss, clock=vclock)
    controller.register(GroupPolicy("serve", 1, "sig-serve"))
    controller.attach()

    victim = f"rep{seed % 2}"
    survivor = f"rep{1 - seed % 2}"
    kill_step = 20 + seed % 7
    failover_before = _journal_count("serve_failover")
    lost_before = _journal_count("instance_lost")
    killed: list[str] = []

    def on_step(step: int) -> None:
        # Live replicas beat every scheduler step; a failed one falls out
        # of the front-end and goes silent — exactly what the liveness
        # watcher would escalate.
        for rep in frontend.replicas.values():
            rep.beat()
        if step == kill_step and not killed:
            killed.append(victim)
            backend.events.publish(LifecycleEvent(
                kind=EventKind.INSTANCE_TERMINATE, group="serve",
                instance_id=f"serve/{victim}", detail={"reason": "chaos"}))

    load = run_load(frontend, tcfg, vclock, on_step=on_step)

    report.check(
        load.completed == tcfg.requests and not frontend.lost_requests(),
        f"zero lost accepted requests: all {tcfg.requests} completed "
        "through the replica death",
    )
    report.check(
        frontend.failed == [victim] and f"serve/{victim}" in controller.lost_instances,
        "the terminate event reached the front-end through the "
        "elasticity controller's on_instance_loss seam",
    )
    report.check(
        load.completions == reference.completions,
        "greedy outputs identical to the undisturbed single-engine "
        "reference — failover is invisible in content",
    )
    per_token_p99 = load.latency_per_token_ms.get("p99", float("inf"))
    ttft_p99 = load.ttft_ms.get("p99", float("inf"))
    report.check(
        per_token_p99 <= slo_per_token_p99_ms,
        f"p99 per-token latency {per_token_p99}ms inside the "
        f"{slo_per_token_p99_ms}ms SLO through the disruption",
    )
    report.check(
        ttft_p99 <= slo_ttft_p99_ms,
        f"p99 TTFT {ttft_p99}ms inside the {slo_ttft_p99_ms}ms SLO "
        "through the disruption",
    )
    victim_silence = broker.silence_s(f"serve/{victim}")
    survivor_silence = broker.silence_s(f"serve/{survivor}")
    report.check(
        victim_silence is not None and survivor_silence is not None
        and victim_silence > survivor_silence,
        "victim's heartbeat went silent while the survivor kept beating",
    )
    report.check(
        _journal_count("serve_failover") - failover_before == 1
        and _journal_count("instance_lost") - lost_before == 1,
        "journal shows exactly one failover and one instance loss",
    )
    report.check(
        sorted(kv.table) == ["serve/serve/rep0", "serve/serve/rep1"],
        "both replicas registered in the broker KV table",
    )
    checksum = int(np.sum([np.sum(tokens, dtype=np.int64)
                           for tokens in load.completions.values()], dtype=np.int64))
    report.details.update(
        victim=victim,
        kill_step=kill_step,
        replayed=sorted(frontend.replayed),
        requests=tcfg.requests,
        steps=load.steps,
        duration_s=load.duration_s,
        throughput_rps=load.throughput_rps,
        tokens_out=load.tokens_out,
        output_checksum=checksum,
        ttft_p99_ms=ttft_p99,
        per_token_p99_ms=per_token_p99,
        reference_steps=reference.steps,
        victim_silence_s=round(victim_silence or 0.0, 6),
    )
    report.observed.update(completions=load.completions,
                           devices=[str(next(model.parameters()).device)])
    return report


# --- broker-failover ---------------------------------------------------------


def broker_failover(seed: int) -> ScenarioReport:
    """The primary broker dies mid-traffic under 1,000 heartbeating
    agents; the warm standby is promoted and NOTHING is lost.

    Runs :func:`soak_failover` — real Heartbeaters and a real
    BrokerLivenessWatcher over the replicated sim pair on virtual time —
    and pins the acceptance invariants: every silently-killed agent is
    terminated exactly once (zero lost, zero spurious, zero premature
    INSTANCE_TERMINATE events), idempotent re-sends across the switch
    produce zero duplicate side effects, and the promotion fenced a
    strictly-higher epoch with no fenced writes (no split brain here).
    """
    from deeplearning_cfn_tpu_torch.analysis.schedules import soak_failover

    report = ScenarioReport("broker-failover", seed)
    soak = soak_failover(agents=1000, seed=seed)
    report.check(
        soak["terminated"] == soak["killed"]
        and soak["lost_terminates"] == 0,
        "zero lost INSTANCE_TERMINATE events across the failover "
        f"({soak['killed']} killed agents all terminated)",
    )
    report.check(
        soak["spurious_terminates"] == 0,
        "no live agent was spuriously terminated during the broker outage",
    )
    report.check(
        soak["duplicate_terminates"] == 0,
        "each killed agent terminated exactly once (no duplicates)",
    )
    report.check(
        soak["premature_terminates"] == 0,
        "every termination happened at silence >= dead_after_s "
        "(ground truth from the replicated heartbeat table)",
    )
    report.check(
        soak["duplicate_sends"] == 0
        and soak["work_depth"] == soak["senders"],
        "idempotent re-sends across the switch: every request id landed "
        "exactly once (replayed or re-sent, never both)",
    )
    report.check(
        soak["epoch"] == 1 and soak["fenced_writes"] == 0,
        "standby promoted to a strictly-higher epoch; no write was fenced "
        "(single leader throughout)",
    )
    report.check(
        soak["unshipped_at_kill"] > 0
        and soak["replayed_seq"] == soak["journaled_seq"] - soak["unshipped_at_kill"],
        "the kill left a real unshipped journal tail and the standby "
        "replayed exactly the shipped prefix",
    )
    report.check(
        soak["client_failovers"] == soak["senders"],
        "every re-sending client failed over past the dead primary",
    )
    report.details.update(soak)
    return report


# --- split-brain -------------------------------------------------------------


def split_brain(seed: int) -> ScenarioReport:
    """A partition isolates the primary; the standby is promoted; the
    deposed primary keeps accepting writes on its side.  Epoch fencing
    must reject every one of its stale replication entries, the deposed
    node must stand down on contact with the higher epoch, and healed
    clients' re-sends must land exactly once on the true primary."""
    import random as _random

    from deeplearning_cfn_tpu_torch.analysis.schedules import (
        FailoverSimConnection,
        ReplicatedSimBroker,
        SimFenced,
        SimNotPrimary,
        VirtualClock,
    )

    report = ScenarioReport("split-brain", seed)
    rng = _random.Random(seed)
    clock = VirtualClock()
    cluster = ReplicatedSimBroker(clock)

    # Healthy traffic, fully replicated, before the partition.
    pre = 20
    for i in range(pre):
        cluster.primary.send_idempotent("work", f"pre-{i}".encode(), f"pre-{i}")
        clock.advance(0.5)
    cluster.stream()
    report.check(
        cluster.standby.sync_seq == cluster.primary.seq == pre,
        "standby fully caught up before the partition",
    )

    # The operator side can't reach the primary and promotes the standby.
    epoch = cluster.promote_standby()
    report.check(
        epoch == 1 and cluster.standby.role == "primary",
        "standby promoted to a strictly-higher epoch",
    )

    # Dual leader: the deposed primary still believes it leads and keeps
    # accepting writes from clients on its side of the partition.
    stale = [f"stale-{seed}-{i}" for i in range(7 + rng.randrange(5))]
    for rid in stale:
        cluster.primary.send_idempotent("work", rid.encode(), rid)
        clock.advance(0.5)
    report.check(
        cluster.primary.role == "primary" and cluster.primary.epoch == 0,
        "deposed primary still claims leadership at the stale epoch "
        "(the dangerous window is real)",
    )

    # Its replication stream must be fenced entry by entry.
    fenced_raises = 0
    for entry in cluster.pending():
        try:
            cluster.standby.sync(entry["epoch"], entry["seq"], entry["frame"])
        except SimFenced:
            fenced_raises += 1
    report.check(
        fenced_raises == len(stale)
        and cluster.standby.fenced == len(stale),
        f"epoch fencing rejected every stale-primary write "
        f"({len(stale)} of {len(stale)})",
    )
    true_rids = {rid for rid, _body in cluster.standby.queues.get("work", [])}
    report.check(
        not (set(stale) & true_rids) and len(true_rids) == pre,
        "no stale write leaked into the promoted primary's state",
    )

    # First contact with the higher epoch demotes the deposed node (the
    # receive-side half: a SYNC from the new term stands it down).
    cluster.standby.set("leader", b"broker-b")
    new_entry = cluster.standby.journal[-1]
    cluster.primary.sync(
        new_entry["epoch"], cluster.primary.seq + 1, new_entry["frame"]
    )
    report.check(
        cluster.primary.role == "standby"
        and cluster.primary.epoch == epoch,
        "deposed primary demoted itself on first higher-epoch contact",
    )
    demoted_rejects = False
    try:
        cluster.primary.send_idempotent("work", b"late", "post-demote")
    except SimNotPrimary:
        demoted_rejects = True
    report.check(
        demoted_rejects, "demoted node rejects client writes (not primary)"
    )

    # Heal: clients from the wrong side re-send their request ids through
    # the failover path — exactly-once effects on the true primary, even
    # with a duplicate retry round.
    conn = FailoverSimConnection(cluster.nodes())
    for _round in range(2):
        for rid in stale:
            conn.send_idempotent("work", rid.encode(), rid)
    conn.close()
    work = cluster.standby.queues.get("work", [])
    rid_list = [rid for rid, _body in work]
    report.check(
        len(rid_list) == len(set(rid_list))
        and set(stale) <= set(rid_list)
        and len(work) == pre + len(stale),
        "healed re-sends landed exactly once on the true primary",
    )
    report.check(
        conn.failovers == 2 * len(stale),
        "every healed send failed over past the demoted node",
    )
    report.details.update(
        pre_partition_writes=pre,
        stale_writes=len(stale),
        fenced=cluster.standby.fenced,
        epoch=epoch,
        true_primary_depth=len(work),
        demoted_epoch=cluster.primary.epoch,
    )
    return report


# --- shard-failover ----------------------------------------------------------


def shard_failover(seed: int) -> ScenarioReport:
    """One shard's primary dies mid-traffic in a sharded fleet; the other
    shards never notice, and the failed pair auto-heals back to a
    replicating primary+standby.

    Runs :func:`soak_fleet` — real Heartbeaters and per-shard
    BrokerLivenessWatchers over a consistent-hash-sharded sim fleet on
    virtual time — and pins the sharded acceptance invariants on top of
    the single-pair ones: a failover on one shard stalls ONLY that
    shard's clients (zero failovers on connections routed elsewhere),
    every pair ends the run healed (a degraded pair is never steady
    state), and the concurrent split-brain on another shard is fenced
    without a single diverged entry.
    """
    from deeplearning_cfn_tpu_torch.analysis.schedules import soak_fleet

    report = ScenarioReport("shard-failover", seed)
    soak = soak_fleet(
        agents=2000,
        shards=4,
        seed=seed,
        kill_count=50,
        senders=100,
        failover_shards=1,
        unshipped_tail=5,
        stale_writes=3,
    )
    report.check(
        soak["terminated"] == soak["killed"]
        and soak["lost_terminates"] == 0
        and soak["spurious_terminates"] == 0
        and soak["duplicate_terminates"] == 0
        and soak["premature_terminates"] == 0,
        f"exactly-once liveness verdicts across the shard failover "
        f"({soak['killed']} killed agents, {soak['agents']} total)",
    )
    report.check(
        soak["delivered"] == soak["senders"] + soak["stale_writes"]
        and soak["duplicate_sends"] == 0,
        "idempotent re-sends across the shard switch: every request id "
        "landed exactly once on its shard's acting primary",
    )
    report.check(
        soak["unaffected_shard_failovers"] == 0,
        "a single-shard failover stalled only that shard: clients routed "
        "to healthy shards never failed over",
    )
    report.check(
        all(epoch == 1 for epoch in soak["epochs"].values())
        and soak["unshipped_at_kill"] > 0,
        "each failed shard promoted to a strictly-higher epoch with a "
        "real unshipped journal tail at the kill",
    )
    report.check(
        soak["degraded_pairs"] == 0
        and soak["healed_pairs"] == soak["shards"]
        and soak["reprovisions"] == len(soak["failover_shards"]) + 1,
        "auto-heal restored a replicating primary+standby pair on every "
        "shard (no degraded pair as steady state)",
    )
    report.check(
        soak["diverged_entries"] == 0 and soak["fenced_streams"] == 1,
        "the concurrent split-brain shard fenced its deposed primary's "
        "stream; zero entries diverged",
    )
    report.details.update(soak)
    return report


# --- degraded-pair-heal ------------------------------------------------------


def degraded_pair_heal(seed: int) -> ScenarioReport:
    """A promoted standby must not stay alone: after a failover the new
    primary re-provisions a fresh standby and replication lag drains to
    zero — the self-healing half of the broker failover ladder.

    Drives one replicated sim pair through kill -> promote ->
    re-provision and pins that the replay of the promoted journal into
    the fresh standby (old-term entries shipped under the new term) is
    never fenced, converges to zero pending entries, and that
    replication of NEW writes resumes on the healed pair."""
    import random as _random

    from deeplearning_cfn_tpu_torch.analysis.schedules import (
        ReplicatedSimBroker,
        VirtualClock,
    )

    report = ScenarioReport("degraded-pair-heal", seed)
    rng = _random.Random(seed)
    clock = VirtualClock()
    cluster = ReplicatedSimBroker(clock)

    # Replicated traffic, then a tail the standby never saw.
    pre = 30 + rng.randrange(10)
    tail = 3 + rng.randrange(4)
    for i in range(pre + tail):
        cluster.primary.send_idempotent("work", f"r-{i}".encode(), f"r-{i}")
        clock.advance(0.5)
    cluster.stream(max_entries=pre)
    cluster.kill_primary()
    epoch = cluster.promote_standby()
    acting = cluster.active()
    report.check(
        epoch == 1
        and acting is cluster.standby
        and acting.sync_seq == pre,
        "standby promoted at a strictly-higher epoch holding exactly the "
        f"shipped prefix ({pre} of {pre + tail} writes)",
    )

    # The degraded window is real: the promoted node is alone.
    report.check(
        cluster.primary is not acting or cluster.standby is acting,
        "pair is degraded after promotion (promoted node has no standby)",
    )

    # Auto-heal: fresh standby at the promoted epoch, full journal replay.
    fresh = cluster.reprovision_standby()
    report.check(
        cluster.primary is acting
        and cluster.standby is fresh
        and fresh.role == "standby"
        and fresh.epoch == epoch,
        "re-provisioned standby joined at the promoted epoch",
    )
    report.check(
        fresh.fenced == 0,
        "replaying old-term journal entries under the new term was never "
        "fenced (sender-epoch stamping)",
    )
    report.check(
        len(cluster.pending()) == 0 and fresh.sync_seq == acting.seq,
        "replication lag drained to zero within the scenario",
    )
    healed_rids = {rid for rid, _body in fresh.queues.get("work", [])}
    report.check(
        healed_rids == {f"r-{i}" for i in range(pre)},
        "fresh standby state matches the acting primary's exactly "
        "(the dead node's unshipped tail is gone from both)",
    )

    # The healed pair replicates new writes like any healthy pair.
    post = 5 + rng.randrange(5)
    for i in range(post):
        acting.send_idempotent("work", f"post-{i}".encode(), f"post-{i}")
        clock.advance(0.5)
    shipped = cluster.stream()
    report.check(
        shipped == post
        and fresh.sync_seq == acting.seq
        and fresh.fenced == 0,
        "replication of new writes resumed on the healed pair",
    )
    report.details.update(
        pre_writes=pre,
        unshipped_tail=tail,
        post_writes=post,
        epoch=epoch,
        reprovisions=cluster.reprovisions,
        standby_seq=fresh.sync_seq,
    )
    return report


# --- alert-storm -------------------------------------------------------------


def alert_storm(seed: int) -> ScenarioReport:
    """The full telemetry plane under a correlated incident: ~200 agents
    piggyback TELEM snapshots on their heartbeats at a replicated sim
    broker while the SHIPPED SLO rules (obs/slo.DEFAULT_RULES) evaluate
    the fleet merge every round on virtual time.

    Storyline: a seeded subset dies silently (dead-fraction must fire
    exactly once, after its for-window), a second subset turns straggler
    (step-time p99 must fire exactly once), the primary broker dies with
    an unshipped telemetry tail mid-storm (firing alerts must HOLD
    through the one-round blackout — no flapping — and telemetry loss is
    bounded by the tail), the fleet heals (both alerts resolve exactly
    once), and a quiet drain proves no further transitions.  Alert
    transitions are journaled as kind "alert" and published as
    EventKind.ALERT; the terminate events also trigger a blackbox
    capture, tying the postmortem path into the same storm.
    """
    import random as _random

    from deeplearning_cfn_tpu_torch.analysis.schedules import (
        FailoverSimConnection,
        ReplicatedSimBroker,
        VirtualClock,
    )
    from deeplearning_cfn_tpu_torch.cluster.broker_service import (
        BrokerLivenessWatcher,
    )
    from deeplearning_cfn_tpu_torch.obs.aggregator import (
        FleetAggregator,
        fleet_metric_values,
    )
    from deeplearning_cfn_tpu_torch.obs.blackbox import BlackBox
    from deeplearning_cfn_tpu_torch.obs.heartbeat import Heartbeater
    from deeplearning_cfn_tpu_torch.obs.liveness import LivenessConfig
    from deeplearning_cfn_tpu_torch.obs.recorder import FlightRecorder
    from deeplearning_cfn_tpu_torch.obs.slo import DEFAULT_RULES, SloEngine
    from deeplearning_cfn_tpu_torch.provision.events import EventBus, EventKind

    report = ScenarioReport("alert-storm", seed)
    rng = _random.Random(seed)
    tick_s = 5.0
    agents = 200
    kill_count = 30  # 15% dead > the 10% rule threshold
    straggler_count = 20
    unshipped_tail = 57

    clock = VirtualClock()
    cluster = ReplicatedSimBroker(clock)
    cfg = LivenessConfig(suspect_after_s=15.0, dead_after_s=60.0)
    bus = EventBus()
    recorder = FlightRecorder()  # in-memory ring, no journal file
    alerts_on_bus: list[tuple[str, str]] = []
    terminates: list[str] = []

    def on_event(event) -> None:
        if event.kind is EventKind.ALERT:
            alerts_on_bus.append(
                (event.detail.get("rule"), event.detail.get("state"))
            )
        elif event.kind is EventKind.INSTANCE_TERMINATE:
            terminates.append(event.instance_id)

    bus.subscribe(on_event)
    watcher = BrokerLivenessWatcher(
        cluster_name="sim-storm",
        group="agents",
        bus=bus,
        config=cfg,
        clock=clock,
        fetch=cluster.active_dump,
    )
    engine = SloEngine(
        DEFAULT_RULES, clock=clock.now, bus=bus, recorder=recorder
    )
    aggregator = FleetAggregator()

    tmp = Path(tempfile.mkdtemp(prefix="dlcfn-storm-"))
    blackbox = BlackBox(
        tmp, host="sim-host", worker="agents", recorder=recorder, clock=clock.now
    )
    blackbox.attach(bus)

    names = [f"agent-{i:03d}" for i in range(agents)]
    # Per-agent mutable profile the telemetry closure reads each beat:
    # the straggler phase flips "ms", the heal phase flips it back.
    profiles = {w: {"ms": 100.0} for w in names}

    def make_source(worker: str):
        def source() -> dict:
            return {
                "v": 1,
                "gauges": {"dlcfn_serve_queue_depth": 1.0},
                "summaries": {"dlcfn_step_ms": [profiles[worker]["ms"]] * 8},
            }

        return source

    beaters = {
        w: Heartbeater(
            host="sim",
            port=0,
            worker_id=w,
            interval_s=tick_s,
            connection_factory=lambda: FailoverSimConnection(cluster.nodes()),
            telemetry_source=make_source(w),
        )
        for w in names
    }
    alive = set(names)
    transitions: list[dict] = []

    def round_(stream: bool = True) -> list[dict]:
        for w in names:
            if w in alive:
                beaters[w].beat_step()
        if stream and cluster.active() is cluster.primary:
            cluster.stream()
        clock.advance(tick_s)
        watcher.poll()
        merged = aggregator.merge(
            cluster.active_dump_telem(), liveness=watcher.snapshot()
        )
        new = engine.evaluate(fleet_metric_values(merged))
        transitions.extend(new)
        return new

    try:
        # Phase 1 — warmup: healthy fleet, replication caught up, quiet.
        for _ in range(4):
            round_()
        report.check(
            not transitions, "warmup: healthy fleet raised no alerts"
        )

        # Phase 2 — silent death: the dead-fraction rule must fire once,
        # only after classification (dead_after_s) plus its for-window.
        alive -= set(rng.sample(names, kill_count))
        for _ in range(22):
            round_()
        dead_state = engine.snapshot()["worker-dead-fraction"]
        report.check(
            dead_state["firing"] and dead_state["fired_count"] == 1,
            "dead-fraction alert fired exactly once for the silent deaths",
        )
        report.check(
            len(set(terminates)) == kill_count
            and blackbox.captures == len(terminates),
            "every dead agent terminated once and each terminate "
            "triggered a blackbox capture",
        )

        # Phase 3 — stragglers: slow step samples push the fleet p99
        # over the shipped threshold; fires once after its for-window.
        for w in rng.sample(sorted(alive), straggler_count):
            profiles[w]["ms"] = 4000.0
        for _ in range(15):
            round_()
        strag_state = engine.snapshot()["step-time-p99-straggler"]
        report.check(
            strag_state["firing"] and strag_state["fired_count"] == 1,
            "step-time p99 straggler alert fired exactly once",
        )

        # Phase 4 — broker failover mid-storm with an unshipped tail.
        before = len(transitions)
        for w in names:
            if w in alive:
                beaters[w].beat_step()
        # Ground truth at the instant of death: the primary's post-beat
        # table — whatever the standby lacks of THIS is the real loss.
        pre_counts = {
            w: c for w, (_a, c, _p) in cluster.primary.dump_telem().items()
        }
        backlog = len(cluster.pending())
        cluster.stream(max_entries=max(0, backlog - unshipped_tail))
        lag_at_kill = len(cluster.pending())
        cluster.kill_primary()
        clock.advance(tick_s)
        watcher.poll()  # outage round: empty fetch, firing alerts HOLD
        merged = aggregator.merge(
            cluster.active_dump_telem(), liveness=watcher.snapshot()
        )
        transitions.extend(engine.evaluate(fleet_metric_values(merged)))
        epoch = cluster.promote_standby()
        post_telem = cluster.standby.dump_telem()
        post_counts = {w: c for w, (_a, c, _p) in post_telem.items()}
        lost_snapshots = sum(
            pre_counts[w] - post_counts.get(w, 0) for w in pre_counts
        )
        report.check(
            lag_at_kill == unshipped_tail and 0 < lost_snapshots <= unshipped_tail,
            f"telemetry loss across failover bounded by the unshipped "
            f"journal tail ({lost_snapshots} <= {unshipped_tail} frames)",
        )
        round_()  # first round on the new primary: agents fail over
        report.check(
            alive <= set(cluster.standby.dump_telem()),
            "one beat round after promotion every live agent's snapshot "
            "is back on the new primary (telemetry self-heals)",
        )
        report.check(
            len(transitions) == before
            and engine.snapshot()["worker-dead-fraction"]["firing"]
            and engine.snapshot()["step-time-p99-straggler"]["firing"],
            "no alert flapped through the failover blackout: both "
            "incidents held firing, zero transitions",
        )

        # Phase 5 — heal: dead agents resurrect, stragglers normalize;
        # each alert resolves exactly once.
        alive = set(names)
        for profile in profiles.values():
            profile["ms"] = 100.0
        for _ in range(4):
            round_()
        snap = engine.snapshot()
        report.check(
            not snap["worker-dead-fraction"]["firing"]
            and snap["worker-dead-fraction"]["resolved_count"] == 1,
            "dead-fraction alert resolved exactly once on heal",
        )
        report.check(
            not snap["step-time-p99-straggler"]["firing"]
            and snap["step-time-p99-straggler"]["resolved_count"] == 1,
            "straggler alert resolved exactly once on heal",
        )

        # Phase 6 — drain: a quiet fleet must stay quiet.
        quiet_before = len(transitions)
        for _ in range(6):
            round_()
        report.check(
            len(transitions) == quiet_before,
            "drain: no flapping after recovery",
        )

        snap = engine.snapshot()
        report.check(
            all(s["fired_count"] == s["resolved_count"] for s in snap.values())
            and sum(s["fired_count"] for s in snap.values()) == 2,
            "exactly two incidents fleet-wide; every fire has one resolve",
        )
        journaled = [
            e for e in recorder.tail(4096) if e.get("kind") == "alert"
        ]
        report.check(
            len(journaled) == len(transitions) == len(alerts_on_bus) == 4,
            "every transition journaled as kind 'alert' and published as "
            "EventKind.ALERT (4 of 4)",
        )
        report.check(
            [t["rule"] for t in transitions]
            == [r for r, _s in alerts_on_bus],
            "journal and bus agree on transition order",
        )
        final = aggregator.merge(
            cluster.active_dump_telem(), liveness=watcher.snapshot()
        )
        report.check(
            final["hosts"] == agents and final["dead_fraction"] == 0.0,
            "final fleet merge sees every agent fresh and alive",
        )
        report.details.update(
            agents=agents,
            killed=kill_count,
            stragglers=straggler_count,
            epoch=epoch,
            unshipped_at_kill=lag_at_kill,
            lost_snapshots=lost_snapshots,
            transitions=[[t["rule"], t["state"]] for t in transitions],
            terminates=len(terminates),
            blackbox_captures=blackbox.captures,
            fleet_gauge_sum=final["gauges"]
            .get("dlcfn_serve_queue_depth", {})
            .get("sum"),
            step_p99_final=final["summaries"]
            .get("dlcfn_step_ms", {})
            .get("p99"),
        )
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return report



# --- sched-flash-crowd ---------------------------------------------------------------

#: Arrivals a round: calm, a three-round flash crowd, then the tail (JAX's).
CROWD_SCHEDULE = {0: 2, 1: 2, 2: 8, 3: 8, 4: 8, 5: 1, 6: 1}
CROWD_STEPS, CROWD_DRAIN_ROUNDS = 16, 200
#: The journal kinds the incident counts (their increase over the run).
CROWD_KINDS = ("sched_preempt", "sched_restore", "serve_failover", "serve_pool_resize",
               "reshard", "grad_accum_rescaled", "slice_restore_armed")


def crowd_fleet(hosts_per_slice: int = 2) -> Any:
    """JAX's 3-slice inventory (2 hosts x 2 chips a slice; its first
    ``hosts_per_slice`` hosts a slice): the arbiter's slices and the hosts
    its synthetic terminates name."""
    from deeplearning_cfn_tpu_torch.cluster.contract import ClusterContract

    slices = {f"s{k}": [f"10.0.0.{2 * k + 1 + h}" for h in range(hosts_per_slice)]
              for k in range(3)}
    ips = [ip for hosts in slices.values() for ip in hosts]
    return ClusterContract.build(
        cluster_name="chaos-sched", coordinator_ip=ips[0], other_worker_ips=ips[1:],
        chips_per_worker=2, storage_mount="/mnt/none", slices=slices)


def crowd_train_contract(hosts_per_slice: int = 2) -> Any:
    """The training job's contract: slices s1 (the coordinator's) and s2 of
    the fleet, their first ``hosts_per_slice`` hosts, one rank a host."""
    from deeplearning_cfn_tpu_torch.cluster.contract import ClusterContract

    s1 = ["10.0.0.3", "10.0.0.4"][:hosts_per_slice]
    s2 = ["10.0.0.5", "10.0.0.6"][:hosts_per_slice]
    return ClusterContract.build(
        cluster_name="chaos-sched-train", coordinator_ip=s1[0], other_worker_ips=s1[1:] + s2,
        chips_per_worker=1, storage_mount="/mnt/none", slices={"s1": s1, "s2": s2})


class FlashCrowd:
    """The ``sched-flash-crowd`` world around one training job, in the
    process of the job's coordinator rank: a serve pool (``pool-a``,
    ``pool-b``) of engines from ``make_engine(name, slots, clock)`` on slice s0,
    the elasticity controller on a virtual clock (its safe points run the
    arbiter's ``reconcile``), the ``LiveReshardManager`` of the job's
    ``contract``, the arbiter persisting its ledger to a dict store, the
    preemption driver (a lent slice becomes a 6-slot replica), and the page
    rule on the pool's inflight requests.  :meth:`round` is one round of
    JAX's incident (arrivals, a replica death in round ``3 + seed % 2``, a
    step of the pool, the SLO's evaluation); ``serve_clock`` times the
    requests (the virtual clock by default, as JAX's)."""

    def __init__(self, seed: int, make_engine: Callable[[str, int, Any], Any], contract: Any,
                 vocab_size: int = 64, serve_clock: Callable[[], float] | None = None):
        import numpy as np

        from deeplearning_cfn_tpu_torch.analysis.schedules import VirtualClock
        from deeplearning_cfn_tpu_torch.cluster.elasticity import (
            ElasticityController,
            GroupPolicy,
        )
        from deeplearning_cfn_tpu_torch.cluster.recovery import LiveReshardManager
        from deeplearning_cfn_tpu_torch.obs.slo import SloEngine, SloRule
        from deeplearning_cfn_tpu_torch.provision.events import EventBus
        from deeplearning_cfn_tpu_torch.sched import (
            FleetArbiter,
            JobSpec,
            PreemptionDriver,
            ServePoolHandle,
            TrainJobHandle,
        )
        from deeplearning_cfn_tpu_torch.serve import ServeFrontEnd, ServeReplica

        class Backend:
            def __init__(self):
                self.events = EventBus()

        self.seed, self.vocab_size = seed, vocab_size
        self.vclock = VirtualClock()
        self.serve_clock = serve_clock or self.vclock
        self.frontend = ServeFrontEnd([
            ServeReplica(make_engine(name, 4, self.serve_clock), name, group="serve")
            for name in ("pool-a", "pool-b")])
        self.backend = Backend()
        self.controller = ElasticityController(
            backend=self.backend, coordinator_queue_name="coord",
            on_instance_loss=self.frontend.on_instance_loss, slice_loss_window_s=1.0,
            clock=self.vclock)
        self.controller.register(GroupPolicy("serve", 1, "sig-serve"))
        self.controller.register(GroupPolicy("s1", 1, "sig-s1", coordinator=True))
        self.controller.register(GroupPolicy("s2", 1, "sig-s2"))
        self.controller.attach()
        self.manager = LiveReshardManager(contract)
        self.manager.attach(self.controller)
        self.store = _DictStore()
        driver = PreemptionDriver()
        driver.register_train("train-fsdp", TrainJobHandle(self.manager,
                                                           bus=self.backend.events))
        # A whole lent slice is a bigger replica than the s0 pair's: 6 slots.
        driver.register_serve("serve-chat", ServePoolHandle(
            self.frontend, spawn=lambda name: ServeReplica(
                make_engine(name, 6, self.serve_clock), name, group="serve")))
        self.arbiter = FleetArbiter.from_contract(
            crowd_fleet(len(contract.slices["s1"])), store=self.store, driver=driver)
        self.arbiter.attach(self.backend.events)
        self.controller.add_safe_point_hook(self.arbiter.reconcile)
        self.arbiter.submit(JobSpec(name="serve-chat", kind="serve", priority="prod-serve"))
        self.arbiter.submit(JobSpec(name="train-fsdp", kind="train", priority="prod-train",
                                    min_slices=1, max_slices=2))
        self.initial = {j: list(s) for j, s in self.arbiter.assignments.items()}
        # The page rule: total inflight (queued + slotted) across the pool.
        # Inflight is invariant under replay/resize (requests move between
        # replicas, the total only drains), so a monotone drain produces
        # exactly one fire and one resolve — no flap at the reclaim.
        self.rule = SloRule(name="serve-queue-depth", metric="dlcfn_serve_queue_depth",
                            agg="sum", op=">", threshold=12.0, for_s=2.0, severity="page",
                            description="chaos: pool inflight beyond the two-replica budget")
        self.slo = SloEngine(rules=(self.rule,), clock=self.vclock, bus=self.backend.events)
        self.kill_round = 3 + seed % 2
        self.victim = "pool-a" if seed % 2 == 0 else "pool-b"
        self.rng = np.random.default_rng(seed)
        self.submitted: list[str] = []
        self.killed: list[str] = []
        self.timeline: list[tuple[int, str, str]] = []
        self.ledger_mid = self.assignments_mid = None
        self.serve_s = 0.0  # wall seconds in the pool's steps
        self.drain_rounds = 0
        self.before = {k: _journal_count(k) for k in CROWD_KINDS}

    def _step_pool(self) -> None:
        import time

        t0 = time.perf_counter()
        self.frontend.step_all()
        self.serve_s += time.perf_counter() - t0
        self.vclock.advance(1.0)

    def round(self, round_no: int) -> None:
        import numpy as np

        from deeplearning_cfn_tpu_torch.provision.events import EventKind, LifecycleEvent
        from deeplearning_cfn_tpu_torch.sched import LEDGER_KEY
        from deeplearning_cfn_tpu_torch.serve import ServeRequest

        for _ in range(CROWD_SCHEDULE.get(round_no, 0)):
            rid = f"req-{len(self.submitted):03d}"
            prompt = self.rng.integers(1, self.vocab_size, size=int(self.rng.integers(4, 12)),
                                       dtype=np.int32)
            self.frontend.submit(ServeRequest(rid, prompt, max_new_tokens=4),
                                 arrival_s=self.serve_clock())
            self.submitted.append(rid)
        if round_no == self.kill_round and not self.killed:
            self.killed.append(self.victim)
            self.backend.events.publish(LifecycleEvent(
                kind=EventKind.INSTANCE_TERMINATE, group="serve",
                instance_id=f"serve/{self.victim}", detail={"reason": "chaos"}))
        self._step_pool()
        inflight = float(sum(r.load for r in self.frontend.replicas.values()))
        for t in self.slo.evaluate({"dlcfn_serve_queue_depth": {"sum": inflight}}):
            self.timeline.append((round_no, t["rule"], t["state"]))
        # Crash evidence: the ledger as persisted right after the
        # preemption, while its loan is still outstanding.
        if self.ledger_mid is None and self.arbiter.counters["preemptions"] == 1:
            self.ledger_mid = self.store.get(LEDGER_KEY)
            self.assignments_mid = {j: list(s) for j, s in self.arbiter.assignments.items()}

    def drain(self) -> None:
        """Step the pool until every request completed (train is done)."""
        while self.frontend.pending() and self.drain_rounds < CROWD_DRAIN_ROUNDS:
            self._step_pool()
            self.drain_rounds += 1

    def crash_resume_ok(self) -> bool:
        """An arbiter resumed from the ledger persisted mid-preemption absorbs
        the replayed page that caused it: no second preemption."""
        from deeplearning_cfn_tpu_torch.obs.recorder import get_recorder
        from deeplearning_cfn_tpu_torch.provision.events import EventKind, LifecycleEvent
        from deeplearning_cfn_tpu_torch.sched import LEDGER_KEY, FleetArbiter

        def absorbed() -> int:
            return sum(1 for e in get_recorder().tail(4096)
                       if e.get("kind") == "sched_decision" and e.get("action") == "page-absorbed")

        if self.ledger_mid is None:
            return False
        store = _DictStore()
        store.set(LEDGER_KEY, self.ledger_mid)
        arbiter = FleetArbiter.resume(store)
        preempts, absorbed_before = _journal_count("sched_preempt"), absorbed()
        arbiter.on_event(LifecycleEvent(kind=EventKind.ALERT, group="fleet", detail={
            "rule": self.rule.name, "state": "firing", "value": 13.0, "severity": "page"}))
        actions = arbiter.reconcile()
        return (actions == [] and _journal_count("sched_preempt") - preempts == 0
                and absorbed() - absorbed_before == 1
                and {j: list(s) for j, s in arbiter.assignments.items()} == self.assignments_mid
                and json.loads(self.ledger_mid)["loans"][0]["slice"] == "s2")

    def summary(self) -> dict[str, Any]:
        """What rank 0 reports: the serve, SLO, arbiter and journal sides."""
        snap = self.slo.snapshot()[self.rule.name]
        completions = self.frontend.completions
        return {
            "kill_round": self.kill_round, "victim": self.victim, "timeline": self.timeline,
            "requests": len(self.submitted), "completions": len(completions),
            "lost": self.frontend.lost_requests(), "failed": list(self.frontend.failed),
            "replayed": sorted(set(self.frontend.replayed)), "drain_rounds": self.drain_rounds,
            "alert_counts": self.arbiter.alert_counts,
            "slo": {"fired": snap["fired_count"], "resolved": snap["resolved_count"]},
            "counters": dict(self.arbiter.counters), "loans": self.arbiter.loans,
            "initial": self.initial, "final": {j: list(s) for j, s in
                                               self.arbiter.assignments.items()},
            "assignments_mid": self.assignments_mid,
            "journal": {k: _journal_count(k) - n for k, n in self.before.items()},
            "crash_resume_ok": self.crash_resume_ok(),
            "ttft_s": [c.first_token_s - c.arrival_s for c in completions.values()],
            "tokens": sum(len(c.tokens) for c in completions.values()),
            "serve_s": self.serve_s,
        }


class _DictStore:
    """Broker KV stand-in the ledger persists through."""

    def __init__(self):
        self.table: dict[str, str] = {}

    def set(self, key: str, value: str) -> None:
        self.table[key] = value

    def get(self, key: str) -> str | None:
        return self.table.get(key)


def crowd_checks(report: ScenarioReport, r0: dict, straight: list[float], live: list[float],
                 mid: dict, post: dict, rtol: float = 5e-3, atol: float = 1e-4) -> None:
    """JAX's ``sched-flash-crowd`` invariants on rank 0's report (``mid``
    and ``post``: the topology and accumulation while lent and after the
    regrowth, each beside the one expected)."""
    j, c = r0["journal"], r0["crowd"]
    report.check(
        len(live) == CROWD_STEPS and r0["step"] == CROWD_STEPS,
        "train survived preempt AND restore in one fit() call (no restart, monotone step "
        "count)")
    report.check(
        r0["live_total"] == 2 and r0["fallback_total"] == 0 and c["journal"]["reshard"] == 2,
        "exactly two live reshards: the preempt shrink and the off-peak re-grow, zero "
        "fallbacks")
    report.check(
        mid["topology"] == mid["want"] and mid["grad_accum"] == 2,
        "preempted mesh was the one-slice fsdp survivor with grad accum rescaled 1 -> 2 "
        "(global batch preserved)")
    report.check(
        post["topology"] == post["want"] and r0["slices"] == 2 and post["grad_accum"] == 1
        and c["journal"]["grad_accum_rescaled"] == 2 and c["journal"]["slice_restore_armed"] == 1,
        "restore was bit-safe: full 2-slice mesh re-formed and grad accum returned to exactly "
        "1 (symmetric rescale, journaled)")
    report.check(
        live[:5] == straight[:5],
        "pre-preemption losses identical to the uninterrupted run")
    report.check(
        _close(live, straight, rtol, atol),
        "loss continuity through preempt and restore: full curve matches the uninterrupted "
        "run within tolerance")
    report.check(
        c["completions"] == c["requests"] and not c["lost"],
        f"zero lost requests: all {c['requests']} accepted requests completed through the "
        "replica death and both pool resizes")
    report.check(
        c["failed"] == [c["victim"]] and c["journal"]["serve_failover"] == 1,
        "the mid-crowd replica death failed over exactly once")
    report.check(
        c["journal"]["serve_pool_resize"] == 2,
        "journal shows exactly two pool resizes: the lend and the reclaim")
    report.check(
        c["alert_counts"] == {"serve-queue-depth": {"firing": 1, "resolved": 1}}
        and c["slo"] == {"fired": 1, "resolved": 1},
        "the SLO paged exactly once and resolved exactly once (engine and arbiter agree)")
    report.check(
        c["counters"]["preemptions"] == 1 and c["counters"]["restores"] == 1
        and c["journal"]["sched_preempt"] == 1 and c["journal"]["sched_restore"] == 1,
        "exactly one preemption and one restore, counted and journaled")
    report.check(
        c["final"] == c["initial"] == {"serve-chat": ["s0"], "train-fsdp": ["s1", "s2"]}
        and c["loans"] == []
        and c["assignments_mid"] == {"serve-chat": ["s0", "s2"], "train-fsdp": ["s1"]},
        "the loan round-tripped: s2 to the serve pool during the crowd, back to the train "
        "job after, no loan left open")
    report.check(
        c["crash_resume_ok"],
        "arbiter crashed mid-preemption resumed from the persisted ledger and ABSORBED the "
        "replayed page — no repeated preemption")


def _sched_flash_crowd_rank(seed: int, root: str, device: str, weights: str) -> None:
    """One rank of ``sched-flash-crowd`` (the cluster contract's env): the
    straight run, then the incident — on rank 0 with the :class:`FlashCrowd`
    world, its engines on ``device`` (the tiny f32 Llama, seed-0 weights or
    the state dict at ``weights``); on the ranks of s2 parking when the
    arbiter preempts their slice and rejoining at the restore.  Results as
    JSON in ``<root>/rank<id>.json``."""
    import itertools

    import torch
    import torch.distributed as dist

    from deeplearning_cfn_tpu_torch.analysis.schedules import VirtualClock
    from deeplearning_cfn_tpu_torch.cluster.recovery import LiveReshardManager
    from deeplearning_cfn_tpu_torch.parallel.mesh import MeshSpec, hybrid_mesh_for_slices
    from deeplearning_cfn_tpu_torch.train.data import SyntheticDataset
    from deeplearning_cfn_tpu_torch.train.reshard import (
        LiveReshardCoordinator,
        mesh_topology,
        survivor_ranks,
    )

    rank = _rank_setup(device)
    origin = crowd_train_contract()

    def mesh_for(contract):
        n = contract.slices_count
        return hybrid_mesh_for_slices(n, MeshSpec(fsdp=contract.total_chips // n), "dp",
                                      device_type=device,
                                      ranks=survivor_ranks(origin, contract))

    def make_trainer():
        return _mlp_trainer(mesh_for(origin), device)

    dataset = lambda: SyntheticDataset(  # noqa: E731 - a fresh iterator a run
        shape=(8, 8, 1), num_classes=10, batch_size=32, seed=seed)
    out: dict[str, Any] = {"rank": rank}
    trainer = make_trainer()
    _, out["straight"] = trainer.fit(trainer.init(seed=seed),
                                     dataset().batches(CROWD_STEPS), steps=CROWD_STEPS,
                                     prefetch=0)

    crowd = None
    if rank == 0:
        from deeplearning_cfn_tpu_torch.models import llama
        from deeplearning_cfn_tpu_torch.serve import ContinuousBatchingEngine, ServeConfig

        cfg = llama.LlamaConfig.tiny(vocab_size=64, seq_len=64, dtype=torch.float32)
        model = llama.init_model(cfg, seed=0, device=device)
        if weights:
            model.load_state_dict(torch.load(weights, map_location=device))

        def make_engine(name, slots, clock):
            scfg = ServeConfig(num_slots=slots, block_size=4, blocks_per_slot=8, prefill_len=16)
            return ContinuousBatchingEngine(model, scfg, clock=clock, name=name, journal=False)

        crowd = FlashCrowd(seed, make_engine, origin)
        manager = crowd.manager
    else:
        manager = LiveReshardManager(origin)
    coordinator = LiveReshardCoordinator(
        manager=manager, mesh_for=mesh_for,
        flush=crowd.controller.flush_slice_losses if crowd is not None else None,
        clock=crowd.vclock if crowd is not None else VirtualClock(),
        symmetric_accum=True)
    trainer = make_trainer()
    captured: dict[str, Any] = {}

    def world(src):
        for i, b in enumerate(src):
            if crowd is not None:
                crowd.round(i)
                if "mid" not in captured and coordinator.live_total == 1:
                    captured["mid"] = {"topology": mesh_topology(trainer.mesh),
                                       "grad_accum": trainer.config.grad_accum_steps}
            yield b

    state, live = trainer.fit(trainer.init(seed=seed), world(dataset().batches(CROWD_STEPS)),
                              steps=CROWD_STEPS, prefetch=0, reshard=coordinator)
    out["left_at"] = len(live) if coordinator.departed else None
    if coordinator.departed:
        state = coordinator.rejoin(trainer, state)
        if state is not None:
            out["rejoined_at"] = state.step
            rest = itertools.islice(dataset().batches(CROWD_STEPS), state.step, None)
            state, more = trainer.fit(state, rest, steps=CROWD_STEPS - state.step, prefetch=0,
                                      reshard=coordinator)
            live += more
    out.update(live=live, step=state.step if state is not None else None,
               live_total=coordinator.live_total, fallback_total=coordinator.fallback_total,
               slices=manager.contract.slices_count,
               post={"topology": mesh_topology(trainer.mesh),
                     "grad_accum": trainer.config.grad_accum_steps},
               mid=captured.get("mid"))
    if crowd is not None:
        coordinator.release()
        crowd.drain()
        out["crowd"] = crowd.summary()
        out["journal"] = out["crowd"]["journal"]
    Path(root, f"rank{rank}.json").write_text(json.dumps(out))
    dist.barrier()  # every rank is back in the group: the teardown meets
    dist.destroy_process_group()


def sched_flash_crowd(seed: int, device: str = "cuda",
                      serve_weights: str | None = None) -> ScenarioReport:
    """Competing train+serve jobs under a flash crowd; the arbiter preempts.

    The multi-tenancy gate, end to end on virtual time: a FleetArbiter places
    a ``prod-serve`` chat job (slice s0, two replicas) and a ``prod-train``
    FSDP job (slices s1+s2: four gloo ranks, 2 x fsdp 2) on one 3-slice
    inventory.  A seeded flash crowd floods the serve pool while — mid-crowd
    — one of its replicas dies outright; the inflight SLO rule pages, the
    arbiter preempts the train job's non-anchor slice (live reshard 4 -> 2
    ranks, grad accum 1 -> 2 preserving the global batch; s2's ranks park)
    and lends it to the serve pool as a fresh replica.  The crowd draining
    resolves the page; the arbiter reclaims the replica (stragglers replayed
    — zero loss) and re-grows the mesh (s2's ranks rejoin), returning grad
    accum to exactly 1 (``symmetric_accum``).

    Invariants (JAX's): train loss continuity against an uninterrupted
    4-rank run; the SLO fires and resolves exactly once; zero lost serve
    requests through BOTH the replica death and the pool resizes; exactly
    one ``sched_preempt`` and one ``sched_restore`` in the journal; and an
    arbiter crashed mid-preemption resumes from the persisted ledger
    absorbing a replayed page WITHOUT repeating the preemption.  The ranks
    and the pool run on ``device`` (``cuda`` unless the caller asks for the
    CPU); ``serve_weights`` is a state dict for the pool's tiny Llama (the
    port's seed-0 weights without it).
    """
    from deeplearning_cfn_tpu_torch.device import resolve_device

    device = resolve_device(device).type
    report = ScenarioReport("sched-flash-crowd", seed)
    root = tempfile.mkdtemp(prefix="dlcfn-chaos-sched-")
    try:
        ranks = _spawn_ranks(seed, root, device, "--sched-flash-crowd-rank",
                             (serve_weights or "",))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    r0 = ranks[0]
    straight, live = r0["straight"], r0["live"]
    report.check(
        r0["crowd"]["initial"] == {"serve-chat": ["s0"], "train-fsdp": ["s1", "s2"]},
        "placer gave prod-serve the first slice and prod-train the rest (floors then "
        "priority-ordered fill)")
    crowd_checks(report, r0, straight, live,
                 {**(r0["mid"] or {"topology": None, "grad_accum": None}),
                  "want": {"devices": 2, "axes": {"fsdp": 2}}},
                 {**r0["post"], "want": {"devices": 4, "axes": {"dp": 2, "fsdp": 2}}})
    left = [r["left_at"] for r in ranks[2:]]
    back = [r.get("rejoined_at") for r in ranks[2:]]
    report.check(
        len(set(left)) == 1 and left[0] is not None and back[0] is not None
        and len(set(back)) == 1 and all(r["step"] == CROWD_STEPS for r in ranks)
        and all(r["live"][left[0]:] == live[back[0]:] for r in ranks[2:]),
        "the preempted slice's ranks parked at the shrink and rejoined at the re-grow, "
        "training its last steps with the survivors")
    c = r0["crowd"]
    report.details.update(
        schedule={str(k): v for k, v in sorted(CROWD_SCHEDULE.items())},
        kill_round=c["kill_round"],
        victim=c["victim"],
        timeline=[list(t) for t in c["timeline"]],
        requests=c["requests"],
        completions=c["completions"],
        replayed=c["replayed"],
        drain_rounds=c["drain_rounds"],
        mid_topology=(r0["mid"] or {}).get("topology"),
        post_topology=r0["post"]["topology"],
        grad_accum_mid=(r0["mid"] or {}).get("grad_accum"),
        grad_accum_final=r0["post"]["grad_accum"],
        straight_losses=[round(v, 6) for v in straight],
        live_losses=[round(v, 6) for v in live],
        arbiter_counters=c["counters"],
        parked_at=left[0],
        rejoined_at=back[0],
    )
    return report


# --- gauntlet ----------------------------------------------------------------


def gauntlet(seed: int, device: str = "cuda") -> ScenarioReport:
    """Composed multi-fault incident: slice loss + broker shard failover
    in the SAME reshard pause + a writer crash at the manifest commit
    point, against one end-to-end workload — the cross-subsystem
    invariants no single-subsystem scenario can see (chaos/gauntlet.py).
    """
    from deeplearning_cfn_tpu_torch.chaos.gauntlet import pinned_schedule, run_gauntlet

    return run_gauntlet(pinned_schedule(seed), device)


SCENARIOS: dict[str, Callable[..., ScenarioReport]] = {
    "silent-death": silent_death,
    "partition": partition,
    "flaky-rpc": flaky_rpc,
    "slow-disk": slow_disk,
    "slice-loss-live": slice_loss_live,
    "data-reshard-live": data_reshard_live,
    "straggler": straggler,
    "serve-replica-loss": serve_replica_loss,
    "broker-failover": broker_failover,
    "split-brain": split_brain,
    "shard-failover": shard_failover,
    "degraded-pair-heal": degraded_pair_heal,
    "alert-storm": alert_storm,
    "sched-flash-crowd": sched_flash_crowd,
    "gauntlet": gauntlet,
}
# Pinned gauntlet regression reproducers (chaos/gauntlet.py
# REGRESSION_SCHEDULES) register themselves into SCENARIOS and
# SCENARIO_FAULTS when chaos.gauntlet is imported — the package
# __init__ always imports it, so `cli chaos --all` and the tests'
# parametrization see them.

#: Fault vocabulary per scenario — the seams each one injects into,
#: printed by ``cli chaos --list`` next to the description.
SCENARIO_FAULTS: dict[str, tuple[str, ...]] = {
    "silent-death": ("silent-death",),
    "partition": ("partition", "message-chaos"),
    "flaky-rpc": ("http-errors", "connection-reset", "hard-down"),
    "slow-disk": ("torn-write", "slow-write"),
    "slice-loss-live": ("slice-loss", "forced-fallback"),
    "data-reshard-live": ("slice-loss", "writer-crash"),
    "straggler": ("straggler",),
    "serve-replica-loss": ("replica-loss",),
    "broker-failover": ("broker-failover",),
    "split-brain": ("partition", "split-brain"),
    "shard-failover": ("shard-failover", "silent-death", "split-brain"),
    "degraded-pair-heal": ("broker-failover",),
    "alert-storm": ("silent-death", "straggler", "broker-failover"),
    "sched-flash-crowd": ("flash-crowd", "replica-loss", "preemption"),
    "gauntlet": ("slice-loss", "shard-failover", "writer-crash", "telemetry-blackout"),
}


def on_device(name: str) -> bool:
    """Whether scenario ``name`` runs trainers or engines (which take a
    ``device``), not only the control plane."""
    import inspect

    return "device" in inspect.signature(SCENARIOS[name]).parameters


def run_scenario(name: str, seed: int = 0, device: str = "cuda") -> ScenarioReport:
    """Run one named scenario, its trainers and engines on ``device``;
    unknown names list the catalog."""
    try:
        fn = SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown chaos scenario {name!r}; available: {sorted(SCENARIOS)}"
        ) from None
    return fn(seed, device) if on_device(name) else fn(seed)


_RANK_ENTRIES: dict[str, tuple[int, Callable]] = {  # flag -> (arguments, rank function)
    "--slice-loss-live-rank": (3, _slice_loss_live_rank),
    "--data-reshard-live-rank": (4, _data_reshard_live_rank),
    "--sched-flash-crowd-rank": (4, _sched_flash_crowd_rank),
}

if __name__ == "__main__":
    if sys.argv[1:2] == ["--gauntlet-rank"]:
        from deeplearning_cfn_tpu_torch.chaos.gauntlet import gauntlet_rank

        gauntlet_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    elif len(sys.argv) >= 2 and len(sys.argv) == 2 + _RANK_ENTRIES.get(sys.argv[1], (-9,))[0]:
        _, fn = _RANK_ENTRIES[sys.argv[1]]
        fn(int(sys.argv[2]), *sys.argv[3:])
    else:
        raise SystemExit("usage: python -m deeplearning_cfn_tpu_torch.chaos.scenarios "
                         f"{{{'|'.join(_RANK_ENTRIES)}}} SEED ROOT DEVICE [WEIGHTS] | "
                         "--gauntlet-rank SEED ROOT DEVICE (one rank; run_scenario starts them)")
