"""The full-stack chaos gauntlet: composed multi-fault incidents —
counterpart of ``deeplearning_cfn_tpu/chaos/gauntlet.py``.

Every other chaos scenario proves one subsystem at a time.  Real
incidents are correlated: the slice you lose mid-epoch is also the
moment the broker shard fails over and the async checkpoint writer
tears a manifest.  The gauntlet runs ONE real end-to-end workload — the
FSDP MLP on a 2-slice hybrid mesh of four gloo ranks (2 slices x fsdp 2;
eight virtual devices in JAX), fed by the sharded datastream,
checkpointed by :class:`AsyncShardedCheckpointer`, heartbeating through a
2-shard broker ring, under a live SLO engine — and composes faults into
it from a declarative, seeded :class:`FaultSchedule` on one virtual
clock.  The control plane (the ring, the hosts' heartbeats, the data
plane, the SLO engine, the schedule's clock) lives in rank 0's process.

Fault vocabulary (:data:`FAULT_KINDS`):

* ``slice-loss``          — the s1 terminate burst mid-epoch: live
  reshard onto the survivors AND the datastream reshard in the same
  pause (wired through the coordinator's ``on_commit`` seam).
* ``shard-failover``      — a broker shard's primary dies and its warm
  standby is promoted; when scheduled at the slice-loss step it
  executes INSIDE the reshard pause (the composed case).
* ``writer-crash``        — :class:`ManifestCrashDisk` armed so the
  next async checkpoint dies at the manifest commit point.
* ``telemetry-blackout``  — the SLO engine sees no fleet values for a
  window of rounds; firing alerts must HOLD, nothing may flap.

:class:`GauntletInvariants` then asserts the cross-subsystem contract
no single-subsystem gate can see: exactly-once training records across
the composed reshard, loss continuity against an undisturbed reference
run (bit-exact when no reshard occurred), zero process restarts (one
``fit`` a rank, no rank process restarted), the previous checkpoint fully
restorable after the torn manifest, each SLO alert firing and resolving
exactly once through the blackout, and the same report for the same seed
run twice.

On top sits the seeded incident explorer: :func:`perturbed_schedule`
draws a random-but-valid composition per seed,
:func:`run_gauntlet_sweep` runs N of them, and :func:`shrink_schedule`
greedily deletes events from any failing schedule until it is a
minimal reproducer — which gets pinned in :data:`REGRESSION_SCHEDULES`
and auto-registered as a scenario.  ``python -m
deeplearning_cfn_tpu_torch.cli gauntlet [--seed N] [--sweep N]`` runs them.
"""

from __future__ import annotations

import json
import random
import shutil
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable

from deeplearning_cfn_tpu_torch.chaos.scenarios import (
    ScenarioReport,
    _datastream_event_count,
    _journal_count,
)

#: The composable fault vocabulary, in canonical order.
FAULT_KINDS = (
    "slice-loss",
    "shard-failover",
    "writer-crash",
    "telemetry-blackout",
)

_WORK_QUEUE = "gauntlet-work"


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.  ``at_step`` is the driver round (== the
    0-based batch index; training step ``at_step`` has completed when
    the fault executes).  ``duration`` is rounds (blackout only);
    ``shard`` is the broker shard index (shard-failover only)."""

    kind: str
    at_step: int
    duration: int = 0
    shard: int = 0

    def to_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = {"kind": self.kind, "at_step": self.at_step}
        if self.kind == "telemetry-blackout":
            out["duration"] = self.duration
        if self.kind == "shard-failover":
            out["shard"] = self.shard
        return out

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "FaultEvent":
        return cls(
            kind=str(d["kind"]),
            at_step=int(d["at_step"]),
            duration=int(d.get("duration", 0)),
            shard=int(d.get("shard", 0)),
        )


@dataclass(frozen=True)
class FaultSchedule:
    """A seeded, declarative incident: which faults, when, composed how.

    At most one event per kind — composition is ACROSS subsystems, not
    repetition within one.  ``validate()`` returns the structural
    errors that would make the incident un-assertable (e.g. a blackout
    that would swallow the alert's firing window)."""

    seed: int
    events: tuple[FaultEvent, ...]
    total_steps: int = 12
    n_broker_shards: int = 2

    def by_kind(self) -> dict[str, FaultEvent]:
        return {e.kind: e for e in self.events}

    def validate(self) -> list[str]:
        errors: list[str] = []
        T = self.total_steps
        if T < 8:
            errors.append(f"total_steps must be >= 8, got {T}")
        kinds = [e.kind for e in self.events]
        if len(set(kinds)) != len(kinds):
            errors.append(f"duplicate fault kinds: {sorted(kinds)}")
        for e in self.events:
            if e.kind not in FAULT_KINDS:
                errors.append(f"unknown fault kind {e.kind!r} (want {FAULT_KINDS})")
        if any(e.kind not in FAULT_KINDS for e in self.events):
            return errors
        by = self.by_kind()
        sl = by.get("slice-loss")
        fo = by.get("shard-failover")
        wc = by.get("writer-crash")
        bo = by.get("telemetry-blackout")
        if sl is not None and not (2 <= sl.at_step <= T - 6):
            errors.append(
                f"slice-loss at_step {sl.at_step} outside [2, {T - 6}] "
                "(needs a loss prefix and room to fire/heal the composed alert)"
            )
        if fo is not None:
            if not (1 <= fo.at_step <= T - 5):
                errors.append(
                    f"shard-failover at_step {fo.at_step} outside [1, {T - 5}] "
                    "(the alert must fire and resolve inside the run)"
                )
            if not (0 <= fo.shard < self.n_broker_shards):
                errors.append(
                    f"shard-failover shard {fo.shard} outside "
                    f"[0, {self.n_broker_shards})"
                )
        if wc is not None:
            if not (1 <= wc.at_step <= T - 2):
                errors.append(
                    f"writer-crash at_step {wc.at_step} outside [1, {T - 2}] "
                    "(arm needs a prior manifest and a probe round after)"
                )
            if sl is not None and wc.at_step <= sl.at_step:
                errors.append(
                    "writer-crash must land after slice-loss "
                    f"(got {wc.at_step} <= {sl.at_step}): the incident "
                    "narrative is a crash during/after the reshard pause, and "
                    "the frozen checkpoint must match the surviving topology"
                )
        if bo is not None:
            if not (1 <= bo.duration <= 3):
                errors.append(f"telemetry-blackout duration {bo.duration} outside [1, 3]")
            if bo.at_step < 1 or bo.at_step + bo.duration > T - 1:
                errors.append(
                    f"telemetry-blackout [{bo.at_step}, "
                    f"{bo.at_step + bo.duration}) must sit inside [1, {T - 1}] "
                    "(a post-blackout round must exist to heal and resolve)"
                )
            if fo is not None and bo.at_step < fo.at_step + 4:
                errors.append(
                    f"telemetry-blackout at {bo.at_step} would swallow the "
                    f"failover alert's firing window (needs at_step >= "
                    f"{fo.at_step + 4})"
                )
        return errors

    def to_dict(self) -> dict[str, Any]:
        return {
            "seed": self.seed,
            "total_steps": self.total_steps,
            "n_broker_shards": self.n_broker_shards,
            "events": [e.to_dict() for e in self.events],
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "FaultSchedule":
        return cls(
            seed=int(d["seed"]),
            events=tuple(FaultEvent.from_dict(e) for e in d["events"]),
            total_steps=int(d.get("total_steps", 12)),
            n_broker_shards=int(d.get("n_broker_shards", 2)),
        )


def pinned_schedule(seed: int) -> FaultSchedule:
    """The pinned 3-fault incident (the chaos gate): slice loss
    mid-epoch, a broker shard failover COMPOSED into the same reshard
    pause, and a writer crash at the manifest commit point two steps
    later."""
    die = 3 + seed % 3
    return FaultSchedule(
        seed=seed,
        events=(
            FaultEvent("slice-loss", at_step=die),
            FaultEvent("shard-failover", at_step=die, shard=seed % 2),
            FaultEvent("writer-crash", at_step=die + 2),
        ),
    )


def perturbed_schedule(seed: int, total_steps: int = 12) -> FaultSchedule:
    """One seeded draw from the incident space: 2-4 distinct fault
    kinds with valid (but perturbed) timing and ordering.  Pure
    function of ``seed`` — the sweep explorer's generator."""
    rng = random.Random(0x6AA7 ^ (seed * 2654435761 % (1 << 32)))
    T = total_steps
    n_kinds = rng.randint(2, 4)
    kinds = sorted(rng.sample(FAULT_KINDS, n_kinds), key=FAULT_KINDS.index)
    events: list[FaultEvent] = []
    sl_at: int | None = None
    fo_at: int | None = None
    for kind in kinds:
        if kind == "slice-loss":
            sl_at = rng.randint(2, T - 6)
            events.append(FaultEvent(kind, at_step=sl_at))
        elif kind == "shard-failover":
            if sl_at is not None and rng.random() < 0.5:
                fo_at = sl_at  # composed: failover inside the reshard pause
            else:
                fo_at = rng.randint(1, T - 5)
            events.append(FaultEvent(kind, at_step=fo_at, shard=rng.randrange(2)))
        elif kind == "writer-crash":
            lo = 1 if sl_at is None else sl_at + 1
            events.append(FaultEvent(kind, at_step=rng.randint(lo, T - 2)))
        elif kind == "telemetry-blackout":
            lo = 1 if fo_at is None else fo_at + 4
            if lo > T - 2:
                continue  # no room for a post-blackout resolve round
            at = rng.randint(lo, T - 2)
            dur = rng.randint(1, min(3, T - 1 - at))
            events.append(FaultEvent(kind, at_step=at, duration=dur))
    return FaultSchedule(seed=seed, events=tuple(events), total_steps=T)


class GauntletInvariants:
    """The cross-subsystem invariant catalog, conditioned on which
    faults the schedule composed.  ``verify(report, obs)`` runs every
    applicable check against the facts the engine observed."""

    def __init__(self, schedule: FaultSchedule):
        self.schedule = schedule
        self.by = schedule.by_kind()
        self.kinds = set(self.by)

    def verify(self, report: ScenarioReport, obs: dict[str, Any]) -> None:
        import numpy as np

        T = self.schedule.total_steps
        sl = self.by.get("slice-loss")
        fo = self.by.get("shard-failover")
        wc = self.by.get("writer-crash")
        bo = self.by.get("telemetry-blackout")

        # --- training plane ---------------------------------------------
        report.check(
            len(obs["losses"]) == T and obs["final_step"] == T,
            "zero process restarts: one fit() call trained every step "
            "through the composed incident (monotone step count)",
        )
        if sl is not None:
            report.check(
                obs["live_total"] == 1 and obs["fallback_total"] == 0,
                "the terminate burst coalesced into exactly one live "
                "reshard and zero fallbacks",
            )
            report.check(
                obs["journal"]["slice_loss_coalesced"] == 1
                and obs["journal"]["reshard"] == 1,
                "journal shows one coalesced slice loss and one reshard",
            )
            report.check(
                obs["post_mesh"] == {"devices": 2, "axes": {"fsdp": 2}}
                and obs["grad_accum"] == 2,
                "trainer rebound to the surviving 2-rank fsdp mesh with "
                "grad accumulation rescaled 1 -> 2 (global batch preserved)",
            )
            report.check(
                bool(
                    np.allclose(
                        obs["losses"][: sl.at_step],
                        obs["straight"][: sl.at_step],
                        rtol=1e-5,
                        atol=1e-6,
                    )
                ),
                "pre-incident losses identical to the undisturbed run",
            )
            report.check(
                bool(
                    np.allclose(obs["losses"], obs["straight"], rtol=5e-3, atol=1e-4)
                ),
                "loss continuity across the composed incident: full curve "
                "matches the undisturbed run within tolerance",
            )
        else:
            report.check(
                obs["live_total"] == 0 and obs["journal"]["reshard"] == 0,
                "no slice loss scheduled: zero reshards executed",
            )
            report.check(
                obs["losses"] == obs["straight"],
                "without a reshard the incident is arithmetic-invisible: "
                "loss curve bit-identical to the undisturbed run",
            )

        # --- data plane (exactly-once records) --------------------------
        report.check(
            obs["plane_seen"] == list(range(obs["plane_total"])),
            "every datastream record consumed exactly once across the "
            "incident (zero dropped, zero duplicated)",
        )
        report.check(
            obs["journal"]["datastream_reshard"] == (1 if sl is not None else 0),
            "datastream resharded exactly once per slice loss (inside the "
            "same pause as the mesh reshard), never otherwise",
        )

        # --- checkpoint plane -------------------------------------------
        if wc is not None:
            report.check(
                obs["latest_at_arm"] == wc.at_step,
                "the writer had committed the arm-step manifest before the "
                "crash was armed (deterministic crash point)",
            )
            report.check(
                obs["write_failures"] == 1 and obs["disk_crashes"] == 1
                and obs["journal"]["checkpoint_write_failed"] == 1,
                "the armed crash fired exactly once at the manifest commit "
                "point and was journaled (writer thread survived)",
            )
            report.check(
                not obs["crashed_manifest_exists"] and obs["crashed_shard_exists"],
                "the crashed step left shard litter but NO manifest: the "
                "commit point never passed",
            )
            report.check(
                obs["restore_step"] == wc.at_step
                and obs["restore_stream_records"] == wc.at_step * 32,
                "the previous checkpoint (state + stream cursor) is fully "
                "restorable after the torn manifest — no training step or "
                "record position lost",
            )
        report.check(
            obs["final_latest"] == T,
            "the async writer recovered past the incident: the final step's "
            "manifest committed",
        )

        # --- broker plane ------------------------------------------------
        report.check(
            obs["work_depth"] == T and obs["resends"] == (1 if fo is not None else 0),
            "idempotent work submission is exactly-once through the "
            "incident: the post-failover re-send storm deduplicated, depth "
            "== one entry per round",
        )
        if fo is not None:
            report.check(
                obs["failed_shard_epoch"] == 1 and obs["reprovisions"] == 1,
                "the failed shard promoted its standby (epoch fenced 0 -> 1) "
                "and auto-re-provisioned a fresh one, exactly once",
            )
            report.check(
                obs["healed_pairs"] == self.schedule.n_broker_shards,
                "every broker shard pair is whole and caught up at the end "
                "(zero replication lag after the failover)",
            )
            report.check(
                obs["healthy_shard_failovers"] == 0,
                "zero spurious client failovers on the unaffected shard",
            )
        else:
            report.check(
                obs["healed_pairs"] == self.schedule.n_broker_shards
                and obs["total_failovers"] == 0
                and obs["reprovisions"] == 0,
                "no failover scheduled: the ring stayed whole, zero client "
                "failovers, zero re-provisions",
            )

        # --- SLO plane ----------------------------------------------------
        expect_fired = 1 if fo is not None else 0
        report.check(
            obs["slo"]["fired_count"] == expect_fired
            and obs["slo"]["resolved_count"] == expect_fired
            and not obs["slo"]["firing"],
            "each SLO alert fired and resolved exactly once for the "
            "incident (zero flaps, nothing left firing)",
        )
        if bo is not None:
            blackout = range(bo.at_step, bo.at_step + bo.duration)
            report.check(
                all(t["round"] not in blackout for t in obs["transitions"]),
                "zero alert transitions during the telemetry blackout "
                "(absence of evidence neither fires nor resolves)",
            )
            if fo is not None:
                report.check(
                    all(obs["firing_by_round"][r] for r in blackout),
                    "the firing alert HELD through the telemetry blackout "
                    "(no flap on missing data)",
                )



# Memoised reference loss curves keyed by (seed, total_steps, device,
# weights): the undisturbed run is a pure function of them, and it runs in
# the ranks before the journal deltas are taken, so skipping it on the
# later same-key runs of this process changes nothing observable.  A run
# that trained it (the first of its key, or several started together)
# checks against its own curve.
_STRAIGHT_CACHE: dict[tuple, tuple[float, ...]] = {}

#: The slices and hosts of the gauntlet's cluster: 2 slices x 2 hosts, one
#: rank a host.
_SLICES = {"s0": ["10.0.0.1", "10.0.0.2"], "s1": ["10.0.0.3", "10.0.0.4"]}


def _contract() -> Any:
    from deeplearning_cfn_tpu_torch.cluster.contract import ClusterContract

    return ClusterContract.build(
        cluster_name="chaos-gauntlet", coordinator_ip="10.0.0.1",
        other_worker_ips=["10.0.0.2", "10.0.0.3", "10.0.0.4"], chips_per_worker=1,
        storage_mount="/mnt/none", slices=_SLICES)


class _World:
    """The incident's control plane, in rank 0's process, on ONE virtual
    clock: the elasticity controller and ``LiveReshardManager`` (the s1
    terminate burst), the id-carrying 4-host ``DataStreamPlane``, the
    two-shard ``ShardedSimBroker`` ring carrying heartbeats and idempotent
    work, the SLO engine watching the ring's pair health, and the
    ``ManifestCrashDisk`` under rank 0's async checkpointer.
    :meth:`driver` is JAX's world loop, advanced once per produced batch."""

    def __init__(self, schedule: FaultSchedule, root: Path, ck: Any, disk: Any):
        from deeplearning_cfn_tpu_torch.analysis.schedules import (
            ShardedSimBroker,
            ShardedSimConnection,
            VirtualClock,
            interleavings,
        )
        from deeplearning_cfn_tpu_torch.cluster.elasticity import (
            ElasticityController,
            GroupPolicy,
        )
        from deeplearning_cfn_tpu_torch.cluster.recovery import LiveReshardManager
        from deeplearning_cfn_tpu_torch.obs.slo import SloEngine, SloRule
        from deeplearning_cfn_tpu_torch.provision.events import EventBus
        from deeplearning_cfn_tpu_torch.train.datastream import DataStreamPlane
        from deeplearning_cfn_tpu_torch.train.records import Field, RecordSpec

        self.schedule, self.root, self.ck, self.disk = schedule, root, ck, disk
        by = schedule.by_kind()
        self.sl_ev, self.fo_ev = by.get("slice-loss"), by.get("shard-failover")
        self.wc_ev, self.bo_ev = by.get("writer-crash"), by.get("telemetry-blackout")
        self.composed_failover = (self.fo_ev is not None and self.sl_ev is not None
                                  and self.fo_ev.at_step == self.sl_ev.at_step)
        self.blackout_rounds = (range(self.bo_ev.at_step, self.bo_ev.at_step + self.bo_ev.duration)
                                if self.bo_ev else range(0))
        self.vclock = VirtualClock()

        class _Backend:
            def __init__(self):
                self.events = EventBus()

        self.backend = _Backend()
        self.controller = ElasticityController(backend=self.backend,
                                               coordinator_queue_name="coord",
                                               slice_loss_window_s=10.0, clock=self.vclock)
        self.controller.register(GroupPolicy("s0", 1, "sig-s0", coordinator=True))
        self.controller.register(GroupPolicy("s1", 1, "sig-s1"))
        self.controller.attach()
        self.manager = LiveReshardManager(_contract())
        self.manager.attach(self.controller)

        idspec = RecordSpec((Field("x", "uint8", (2,)), Field("y", "int32", ())))
        self.plane = DataStreamPlane(_contract(), sorted(root.glob("shard-*.dlc")), idspec,
                                     batch_size=5, seed=schedule.seed, loop=False)
        self.plane_iters = {h: self.plane.stream(h).batches() for h in self.plane.hosts}
        self.plane_ids: dict[str, list[int]] = {h: [] for h in self.plane.hosts}

        self.broker = ShardedSimBroker(self.vclock, n_shards=schedule.n_broker_shards)
        self.host_conns = {h: ShardedSimConnection(self.broker)
                           for h in _contract().datastream_hosts()}
        self.work_conn = ShardedSimConnection(self.broker)
        self.rule = SloRule(
            name="gauntlet-broker-degraded",
            metric="dlcfn_gauntlet_broker_degraded_pairs",
            agg="value",
            op=">",
            threshold=0.0,
            for_s=2.0,
            severity="page",
            description="gauntlet: a broker shard pair is degraded "
            "(failover in progress, replication lag, or a dead primary)",
        )
        self.slo = SloEngine(rules=(self.rule,), clock=self.vclock, bus=self.backend.events)
        self.transitions: list[dict[str, Any]] = []
        self.firing_by_round: list[bool] = []
        self.state = {"failover_done": False, "healed": False, "resend_due": False,
                      "resends": 0}
        self.obs: dict[str, Any] = {}
        # A blackout scheduled after the failover (validation guarantees
        # the alert fires first) defers healing until telemetry is back:
        # automation cannot confirm pair health while the fleet is dark,
        # which is exactly the window the hold-don't-flap invariant needs.
        self.heal_from = 0
        if self.fo_ev is not None and self.bo_ev is not None:
            self.heal_from = self.bo_ev.at_step + self.bo_ev.duration
        self.order = list(interleavings(["10.0.0.3", "10.0.0.4", "10.0.0.3"],  # dup on purpose
                                        count=1, seed=schedule.seed)[0])

    def do_failover(self) -> None:
        shard = self.broker.shards[self.fo_ev.shard]
        shard.kill_primary()
        shard.promote_standby()
        self.state["failover_done"] = True
        self.state["resend_due"] = True

    def on_commit(self, contract: Any) -> None:
        """The composed pause: the datastream reshards at the SAME step
        boundary as the mesh, and — when scheduled — the broker shard
        fails over inside that pause."""
        self.plane.reshard(contract)
        if self.composed_failover:
            self.do_failover()

    def driver(self, src):
        """The world loop, advanced once per produced batch: faults,
        heartbeats, idempotent work, replication, healing, SLO
        evaluation, and one id-plane round — all deterministic."""
        from deeplearning_cfn_tpu_torch.provision.events import EventKind, LifecycleEvent

        sl_ev, fo_ev, wc_ev = self.sl_ev, self.fo_ev, self.wc_ev
        obs, state, ck = self.obs, self.state, self.ck
        for i, b in enumerate(src):
            # 1. scheduled faults for this round
            if sl_ev is not None and i == sl_ev.at_step:
                for ip in self.order:
                    self.backend.events.publish(LifecycleEvent(
                        kind=EventKind.INSTANCE_TERMINATE, group="s1", instance_id=ip,
                        detail={"reason": "preempted"}))
                    self.vclock.advance(0.5)
                self.vclock.advance(11.0)
            if fo_ev is not None and not self.composed_failover and i == fo_ev.at_step:
                self.do_failover()
            if wc_ev is not None and i == wc_ev.at_step:
                ck.wait()
                obs["latest_at_arm"] = ck.latest_step()
                self.disk.arm()
            if wc_ev is not None and i == wc_ev.at_step + 1:
                # Probe: the crashed step's save has been attempted (and
                # failed) by now; freeze the directory as the post-crash
                # disk image for the restorability check.
                ck.wait()
                obs["write_failures"] = ck.write_failures
                obs["disk_crashes"] = self.disk.crashes
                crashed = wc_ev.at_step + 1
                ckdir = Path(ck.directory)
                obs["crashed_manifest_exists"] = (
                    ckdir / f"ckpt-{crashed:08d}.manifest.json").exists()
                obs["crashed_shard_exists"] = (
                    ckdir / f"ckpt-{crashed:08d}.shard-00-of-02.json").exists()
                shutil.copytree(ckdir, self.root / "frozen")
            # 2. the at-least-once re-send storm after a failover
            if state["resend_due"] and i >= 1:
                rid = f"w-{i - 1:03d}"
                self.work_conn.send_idempotent(_WORK_QUEUE, rid.encode(), rid)
                state["resends"] += 1
                state["resend_due"] = False
            # 3. heartbeats from every live host
            for h in list(self.plane.hosts):
                self.host_conns[h].heartbeat(h)
            # 4. this round's idempotent work submission
            rid = f"w-{i:03d}"
            self.work_conn.send_idempotent(_WORK_QUEUE, rid.encode(), rid)
            # 5. replication pass (healthy shards stay caught up)
            self.broker.stream_all()
            # 6. auto-heal: once the alert fired (and telemetry is back),
            # the acting primary re-provisions a fresh standby
            if (state["failover_done"] and not state["healed"] and i >= self.heal_from
                    and i not in self.blackout_rounds
                    and self.slo.snapshot()[self.rule.name]["firing"]):
                self.broker.shards[fo_ev.shard].reprovision_standby()
                state["healed"] = True
            # 7. SLO evaluation (a blackout round observes nothing)
            if i in self.blackout_rounds:
                values: dict[str, dict[str, float]] = {}
            else:
                values = {self.rule.metric: {
                    "value": float(self.broker.n_shards - self.broker.healed_pairs())}}
            for t in self.slo.evaluate(values):
                self.transitions.append({"round": i, "rule": t["rule"], "state": t["state"]})
            self.firing_by_round.append(self.slo.snapshot()[self.rule.name]["firing"])
            self.vclock.advance(1.0)
            # 8. one id-plane round across the live hosts
            for h in list(self.plane.hosts):
                nb = next(self.plane_iters[h], None)
                if nb is not None:
                    self.plane_ids[h].extend(int(v) for v in nb.y)
            yield b

    def facts(self) -> dict[str, Any]:
        """After the run: the data plane drained, the ring's and the SLO's
        end state (JAX's observations of those planes)."""
        obs = self.obs
        for h in tuple(self.plane.hosts):  # survivors drain the epoch
            for nb in self.plane_iters[h]:
                self.plane_ids[h].extend(int(v) for v in nb.y)
        obs["plane_seen"] = sorted(v for ids in self.plane_ids.values() for v in ids)
        obs["plane_per_host"] = {h: len(ids) for h, ids in sorted(self.plane_ids.items())}
        broker = self.broker
        broker.stream_all()
        obs["healed_pairs"] = broker.healed_pairs()
        obs["reprovisions"] = sum(s.reprovisions for s in broker.shards)
        obs["resends"] = self.state["resends"]
        work_node = broker.route(_WORK_QUEUE).active()
        obs["work_depth"] = 0 if work_node is None else work_node.depth(_WORK_QUEUE)
        obs["total_failovers"] = self.work_conn.failovers + sum(
            c.failovers for c in self.host_conns.values())
        if self.fo_ev is not None:
            acting = broker.shards[self.fo_ev.shard].active()
            obs["failed_shard_epoch"] = -1 if acting is None else acting.epoch
            healthy = [k for k in range(broker.n_shards) if k != self.fo_ev.shard]
            obs["healthy_shard_failovers"] = sum(
                conn._conns[k].failovers
                for conn in [self.work_conn, *self.host_conns.values()] for k in healthy)
        obs["slo"] = self.slo.snapshot()[self.rule.name]
        obs["transitions"] = self.transitions
        obs["firing_by_round"] = self.firing_by_round
        return obs


def gauntlet_rank(seed: int, root: str, device: str) -> None:
    """One rank of a gauntlet run (the cluster contract's env), its trainer
    on ``device``; the schedule, the weights and whether to run the
    undisturbed reference come in ``<root>/gauntlet.json``.  Rank 0 holds
    the :class:`_World`; every rank trains from the record stream with an
    async sharded checkpointer of its own (the saves gather the state, a
    collective of every rank at every step) and the live reshard; the
    ranks that do not leave restore the frozen post-crash checkpoint.
    Results as JSON in ``<root>/rank<id>.json``."""
    import torch.distributed as dist

    from deeplearning_cfn_tpu_torch.chaos.injectors import ManifestCrashDisk
    from deeplearning_cfn_tpu_torch.chaos.scenarios import (
        _mlp_trainer,
        _rank_facts,
        _rank_setup,
        train_stream,
    )
    from deeplearning_cfn_tpu_torch.cluster.recovery import LiveReshardManager
    from deeplearning_cfn_tpu_torch.parallel.mesh import MeshSpec, hybrid_mesh_for_slices
    from deeplearning_cfn_tpu_torch.train.datastream import AsyncShardedCheckpointer
    from deeplearning_cfn_tpu_torch.train.reshard import (
        LiveReshardCoordinator,
        mesh_topology,
        rescale_grad_accum,
        survivor_ranks,
    )

    t0 = time.perf_counter()
    rank = _rank_setup(device)
    seconds = {"setup": time.perf_counter() - t0}
    root_p = Path(root)
    cfg = json.loads((root_p / "gauntlet.json").read_text())
    schedule = FaultSchedule.from_dict(cfg["schedule"])
    weights, T = cfg["weights"], schedule.total_steps
    origin = _contract()
    tpaths = sorted(root_p.glob("train-*.dlc"))

    def mesh_for(contract):
        n = contract.slices_count
        return hybrid_mesh_for_slices(n, MeshSpec(fsdp=contract.total_chips // n), "dp",
                                      device_type=device, ranks=survivor_ranks(origin, contract))

    out: dict[str, Any] = {"rank": rank}
    if cfg["straight"]:
        t = _mlp_trainer(mesh_for(origin), device, weights)
        _, out["straight"] = t.fit(t.init(seed=seed), train_stream(tpaths, seed).batches(),
                                   steps=T, prefetch=0)
    seconds["straight"] = time.perf_counter() - t0 - sum(seconds.values())

    world = None
    if rank == 0:
        disk = ManifestCrashDisk(once=True)
        ck = AsyncShardedCheckpointer(root_p / "ckpt", every_steps=1, n_shards=2, io=disk)
        world = _World(schedule, root_p, ck, disk)
        manager = world.manager
    else:
        ck = AsyncShardedCheckpointer(root_p / f"ckpt-rank{rank}", every_steps=1, n_shards=2)
        manager = LiveReshardManager(origin)
    # The pause is timed on the wall clock (ReshardRecord.seconds); every
    # decision runs on the world's virtual clock.
    coordinator = LiveReshardCoordinator(
        manager=manager, mesh_for=mesh_for,
        flush=world.controller.flush_slice_losses if world is not None else None,
        clock=time.perf_counter, on_commit=world.on_commit if world is not None else None)
    kinds = ("slice_loss_coalesced", "reshard")
    events = ("checkpoint_write_failed", "reshard")
    before = ({k: _journal_count(k) for k in kinds},
              {e: _datastream_event_count(e) for e in events})

    trainer = _mlp_trainer(mesh_for(origin), device, weights)
    stream = train_stream(tpaths, seed)
    batches = stream.batches()
    tstate, losses = trainer.fit(trainer.init(seed=seed),
                                 world.driver(batches) if world is not None else batches,
                                 steps=T, prefetch=0, checkpointer=ck, datastream=stream,
                                 reshard=coordinator)
    ck.wait()
    seconds["incident"] = time.perf_counter() - t0 - sum(seconds.values())
    out.update(losses=losses, left=coordinator.departed,
               pause_s=[r.seconds for r in coordinator.records])
    if world is not None:
        obs = world.obs
        obs.update(
            losses=losses, final_step=tstate.step, live_total=coordinator.live_total,
            fallback_total=coordinator.fallback_total, post_mesh=mesh_topology(trainer.mesh),
            grad_accum=int(trainer.config.grad_accum_steps), final_latest=ck.latest_step())
        obs["journal"] = {
            "slice_loss_coalesced": _journal_count("slice_loss_coalesced") - before[0][
                "slice_loss_coalesced"],
            "reshard": _journal_count("reshard") - before[0]["reshard"],
            "checkpoint_write_failed": _datastream_event_count("checkpoint_write_failed")
            - before[1]["checkpoint_write_failed"],
            "datastream_reshard": _datastream_event_count("reshard") - before[1]["reshard"],
        }
        world.facts()
    if schedule.by_kind().get("writer-crash") is not None and not coordinator.departed:
        # The frozen post-crash image, restored onto the surviving mesh.
        mesh = mesh_for(manager.contract)
        accum = (rescale_grad_accum(1, origin.total_chips, int(mesh.size()))
                 if manager.contract.degraded else 1)
        ckf = AsyncShardedCheckpointer(root_p / "frozen", every_steps=1, n_shards=2)
        try:
            t = _mlp_trainer(mesh, device, weights, accum)
            restored = ckf.restore_latest(template=t.init(seed=seed))
            if world is not None:
                world.obs["restore_step"] = None if restored is None else restored[1]
                world.obs["restore_stream_records"] = (
                    (ckf.last_stream_state or {}).get("records_total"))
        finally:
            ckf.close()
    ck.close()
    seconds["restore"] = time.perf_counter() - t0 - sum(seconds.values())
    out.update(_rank_facts(device), seconds=seconds)
    if world is not None:
        out["obs"] = world.obs
    (root_p / f"rank{rank}.json").write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()


def run_gauntlet(schedule: FaultSchedule, device: str = "cuda",
                 weights: str | None = None) -> ScenarioReport:
    """Run one composed incident end-to-end and return its report.

    The workload is JAX's: the FSDP MLP on a 2-slice hybrid mesh — four
    gloo ranks (2 slices x fsdp 2, on ``device``) — pulling record batches
    from a single-host shard stream, an id-carrying 4-host
    :class:`DataStreamPlane` exercising the datastream reshard, an async
    sharded checkpointer capturing the stream cursor every step, a 2-shard
    replicated broker ring carrying heartbeats + idempotent work, and an
    SLO engine watching broker pair health — the control plane in rank 0's
    process, on ONE virtual clock, with the schedule's faults injected at
    their rounds.  Deterministic per seed: ``report.to_dict()`` is the
    same across runs.  ``weights`` is a state dict for the MLP (the port's
    draw from the seed without it); ``report.observed`` has the ranks'
    losses, devices, kernel launches and seconds by stage, and rank 0's
    wall-clock pause.
    """
    from deeplearning_cfn_tpu_torch.chaos.scenarios import (
        _ranks_observed,
        _spawn_ranks,
        id_shards,
        train_shards,
    )
    from deeplearning_cfn_tpu_torch.device import resolve_device
    from deeplearning_cfn_tpu_torch.obs.recorder import get_recorder

    errors = schedule.validate()
    if errors:
        raise ValueError("invalid fault schedule: " + "; ".join(errors))
    device = resolve_device(device).type
    seed, T = schedule.seed, schedule.total_steps
    report = ScenarioReport("gauntlet", seed)
    report.faults = [e.to_dict() for e in schedule.events]
    report.details["schedule"] = schedule.to_dict()

    key = (seed, T, device, weights)
    root = Path(tempfile.mkdtemp(prefix="dlcfn-gauntlet-"))
    try:
        train_shards(root, seed)
        _, _, plane_total = id_shards(root, seed)
        (root / "gauntlet.json").write_text(json.dumps(
            {"schedule": schedule.to_dict(), "weights": weights or None,
             "straight": key not in _STRAIGHT_CACHE}))
        ranks = _spawn_ranks(seed, str(root), device, "--gauntlet-rank")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    r0 = ranks[0]
    ran_straight = "straight" in r0  # a run that trained it holds its own curve
    if ran_straight:
        _STRAIGHT_CACHE.setdefault(key, tuple(float(v) for v in r0["straight"]))
    straight = [float(v) for v in r0["straight"]] if ran_straight else list(_STRAIGHT_CACHE[key])
    obs = {**r0["obs"], "straight": straight, "plane_total": plane_total}
    GauntletInvariants(schedule).verify(report, obs)

    losses = obs["losses"]
    report.details.update(
        straight_losses=[round(v, 6) for v in straight],
        gauntlet_losses=[round(v, 6) for v in losses],
        plane_records=plane_total,
        plane_per_host=obs["plane_per_host"],
        work_depth=obs["work_depth"],
        resends=obs["resends"],
        healed_pairs=obs["healed_pairs"],
        alert_timeline=obs["transitions"],
        journal_deltas=obs["journal"],
        restore_step=obs.get("restore_step"),
    )
    report.observed.update(_ranks_observed(ranks))
    report.observed.update(rank_seconds=[r["seconds"] for r in ranks])
    report.observed.update(straight=straight, straight_ran=ran_straight)
    report.observed.update(pause_s=r0["pause_s"], post_mesh=obs["post_mesh"],
                           grad_accum=obs["grad_accum"],
                           ranks=[{"losses": r["losses"], "left": r["left"]} for r in ranks])
    get_recorder().record(
        "gauntlet",
        event="run",
        seed=seed,
        passed=bool(report.passed),
        faults=len(schedule.events),
        violations=len(report.violations),
    )
    return report


def shrink_schedule(
    schedule: FaultSchedule,
    still_fails: Callable[[FaultSchedule], bool],
) -> FaultSchedule:
    """Greedy delta-debugging: repeatedly drop the first event whose
    removal keeps the schedule both valid and failing, until no single
    removal does.  Deterministic (fixed scan order), never returns an
    empty schedule — the minimal reproducer to pin as a regression."""
    current = schedule
    shrunk = True
    while shrunk and len(current.events) > 1:
        shrunk = False
        for i in range(len(current.events)):
            events = current.events[:i] + current.events[i + 1 :]
            candidate = FaultSchedule(
                seed=current.seed,
                events=events,
                total_steps=current.total_steps,
                n_broker_shards=current.n_broker_shards,
            )
            if candidate.validate():
                continue
            if still_fails(candidate):
                current = candidate
                shrunk = True
                break
    return current


#: Pinned minimal reproducers from past sweep failures, auto-registered
#: as scenarios (name -> schedule).  Every entry here is a bug that WAS
#: shrunk, fixed at source, and kept as a permanent regression gate.
REGRESSION_SCHEDULES: dict[str, FaultSchedule] = {}


def _register_regressions() -> None:
    """Each pinned reproducer becomes a scenario of its own, joining the
    chaos gate automatically.  The schedule is fixed; the seed argument is
    ignored by design — a reproducer replays ONE incident exactly."""
    from deeplearning_cfn_tpu_torch.chaos import scenarios as _scenarios

    def make(schedule: FaultSchedule):
        def run(seed: int, device: str = "cuda") -> ScenarioReport:
            return run_gauntlet(schedule, device)

        run.__doc__ = "Pinned gauntlet regression reproducer (fixed schedule)."
        return run

    for name, schedule in sorted(REGRESSION_SCHEDULES.items()):
        _scenarios.SCENARIOS[f"gauntlet-{name}"] = make(schedule)
        _scenarios.SCENARIO_FAULTS[f"gauntlet-{name}"] = tuple(
            e.kind for e in schedule.events
        )


_register_regressions()


def run_gauntlet_sweep(
    n_seeds: int = 20,
    base_seed: int = 0,
    runner: Callable[[FaultSchedule], ScenarioReport] | None = None,
    shrink: bool = True,
    device: str = "cuda",
) -> dict[str, Any]:
    """The seeded incident explorer: run ``n_seeds`` perturbed fault
    schedules (through ``runner``; :func:`run_gauntlet` on ``device``
    by default); for every failing one, greedily shrink it to a minimal
    reproducer.  Returns a deterministic summary (and journals a
    ``gauntlet``/``sweep`` event for the exporter)."""
    if runner is None:
        def runner(schedule: FaultSchedule) -> ScenarioReport:
            return run_gauntlet(schedule, device)

    from deeplearning_cfn_tpu_torch.obs.recorder import get_recorder

    failures: list[dict[str, Any]] = []
    fault_counts: dict[str, int] = {k: 0 for k in FAULT_KINDS}
    for s in range(n_seeds):
        schedule = perturbed_schedule(base_seed + s)
        for e in schedule.events:
            fault_counts[e.kind] += 1
        rep = runner(schedule)
        if not rep.passed:
            entry: dict[str, Any] = {
                "seed": schedule.seed,
                "schedule": schedule.to_dict(),
                "violations": list(rep.violations),
            }
            if shrink:
                minimal = shrink_schedule(
                    schedule, lambda sc: not runner(sc).passed
                )
                entry["shrunk"] = minimal.to_dict()
            failures.append(entry)
    summary = {
        "seeds": n_seeds,
        "base_seed": base_seed,
        "passed": n_seeds - len(failures),
        "failures": failures,
        "fault_counts": fault_counts,
    }
    get_recorder().record(
        "gauntlet",
        event="sweep",
        seeds=n_seeds,
        base_seed=base_seed,
        failures=len(failures),
    )
    return summary
