"""Chaos scenarios — counterpart of ``deeplearning_cfn_tpu/chaos/scenarios.py``.

Ported: :class:`ScenarioReport` (the report's wire shape, schema 2), the
``slice-loss-live`` scenario, the JAX package's own driver of the live
reshard, and ``sched-flash-crowd``, the fleet scheduler's gate (a serve pool
under a flash crowd takes a slice from a training job, which grows back when
the crowd drains), each with its invariants, on the port's trainer and
serving engine.  The JAX scenarios run one SPMD trainer over eight virtual
CPU devices in one process; here every rank is a process: four gloo ranks
(2 slices x fsdp 2, one rank a worker), each running its own ``fit``, and
this process checks the invariants on what the ranks report.  In
``sched-flash-crowd`` the control plane (the arbiter, the SLO engine, the
preemption driver, the serve front end) lives in rank 0's process
(:class:`FlashCrowd`), and the preempted slice's ranks park and rejoin at
the grow.  The other scenarios (silent death, partitions, the broker's
failover, the data plane's writer crash, serving, the gauntlet) drive planes
that later slices port.

Run one with ``python -m deeplearning_cfn_tpu_torch.cli chaos --scenario
NAME --seed N``: its ranks train on the card (all on ``cuda:0`` of a
one-card host, still over gloo), or on the CPU with ``--device cpu``; the
report is deterministic per seed.
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
    from torch import nn

    from deeplearning_cfn_tpu_torch.analysis.schedules import VirtualClock, interleavings
    from deeplearning_cfn_tpu_torch.cluster.contract import ClusterContract
    from deeplearning_cfn_tpu_torch.cluster.elasticity import ElasticityController, GroupPolicy
    from deeplearning_cfn_tpu_torch.cluster.recovery import LiveReshardManager
    from deeplearning_cfn_tpu_torch.examples.common import maybe_init_distributed
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
    from deeplearning_cfn_tpu_torch.train.trainer import Trainer, TrainerConfig

    torch.set_num_threads(1)
    rank = maybe_init_distributed("cpu")  # gloo
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    store = dist.distributed_c10d._get_default_store()

    class MLP(nn.Module):
        """The JAX scenario's ``_MLP``: fc2's 256 x 256 weight clears the
        FSDP rule's floor, so the reshard moves genuinely sharded arrays."""

        def __init__(self, generator=None):
            super().__init__()
            self.fc1, self.fc2, self.head = (nn.Linear(a, b) for a, b in
                                             ((64, 256), (256, 256), (256, 10)))
            if generator is not None:  # normal / sqrt(fan_in), zero biases
                with torch.no_grad():
                    for layer in (self.fc1, self.fc2, self.head):
                        fan_in = layer.weight.shape[1]
                        layer.weight.copy_(torch.randn(layer.weight.shape, generator=generator)
                                           * fan_in**-0.5)
                        layer.bias.zero_()

        def forward(self, x):
            x = x.reshape(x.shape[0], -1)
            return self.head(torch.relu(self.fc2(torch.relu(self.fc1(x)))))

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
        return Trainer(MLP, TrainerConfig(optimizer="adamw", learning_rate=1e-3,
                                          strategy="fsdp", matmul_precision="float32",
                                          log_every=1, grad_accum_steps=accum),
                       device=device, mesh=mesh)

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
                   PYTHONPATH=os.pathsep.join(filter(None, [repo, os.environ.get("PYTHONPATH")])))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "deeplearning_cfn_tpu_torch.chaos.scenarios",
             entry, str(seed), root, device, *extra],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errors = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=JOIN_TIMEOUT_S)
            if p.returncode:
                errors.append(err[-3000:])
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
    from torch import nn

    from deeplearning_cfn_tpu_torch.analysis.schedules import VirtualClock
    from deeplearning_cfn_tpu_torch.cluster.recovery import LiveReshardManager
    from deeplearning_cfn_tpu_torch.examples.common import maybe_init_distributed
    from deeplearning_cfn_tpu_torch.parallel.mesh import MeshSpec, hybrid_mesh_for_slices
    from deeplearning_cfn_tpu_torch.train.data import SyntheticDataset
    from deeplearning_cfn_tpu_torch.train.reshard import (
        LiveReshardCoordinator,
        mesh_topology,
        survivor_ranks,
    )
    from deeplearning_cfn_tpu_torch.train.trainer import Trainer, TrainerConfig

    torch.set_num_threads(1)
    rank = maybe_init_distributed("cpu")  # gloo
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    origin = crowd_train_contract()

    class MLP(nn.Module):
        """The JAX scenario's ``_MLP`` (as ``slice-loss-live``'s)."""

        def __init__(self, generator=None):
            super().__init__()
            self.fc1, self.fc2, self.head = (nn.Linear(a, b) for a, b in
                                             ((64, 256), (256, 256), (256, 10)))
            if generator is not None:  # normal / sqrt(fan_in), zero biases
                with torch.no_grad():
                    for layer in (self.fc1, self.fc2, self.head):
                        fan_in = layer.weight.shape[1]
                        layer.weight.copy_(torch.randn(layer.weight.shape, generator=generator)
                                           * fan_in**-0.5)
                        layer.bias.zero_()

        def forward(self, x):
            x = x.reshape(x.shape[0], -1)
            return self.head(torch.relu(self.fc2(torch.relu(self.fc1(x)))))

    def mesh_for(contract):
        n = contract.slices_count
        return hybrid_mesh_for_slices(n, MeshSpec(fsdp=contract.total_chips // n), "dp",
                                      device_type=device,
                                      ranks=survivor_ranks(origin, contract))

    def make_trainer():
        return Trainer(MLP, TrainerConfig(optimizer="adamw", learning_rate=1e-3,
                                          strategy="fsdp", matmul_precision="float32",
                                          log_every=1, grad_accum_steps=1),
                       device=device, mesh=mesh_for(origin))

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


SCENARIOS: dict[str, Callable[[int], ScenarioReport]] = {
    "slice-loss-live": slice_loss_live,
    "sched-flash-crowd": sched_flash_crowd,
}

#: The fault kinds each scenario injects (the JAX catalog's entries).
SCENARIO_FAULTS: dict[str, tuple[str, ...]] = {
    "slice-loss-live": ("slice-loss", "forced-fallback"),
    "sched-flash-crowd": ("flash-crowd", "replica-loss", "preemption"),
}


def run_scenario(name: str, seed: int = 0, device: str = "cuda") -> ScenarioReport:
    """Run one named scenario, its trainers on ``device``; unknown names
    list the catalog."""
    try:
        fn = SCENARIOS[name]
    except KeyError:
        raise KeyError(
            f"unknown chaos scenario {name!r}; available: {sorted(SCENARIOS)}"
        ) from None
    return fn(seed, device)


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--slice-loss-live-rank":
        _slice_loss_live_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    elif len(sys.argv) == 6 and sys.argv[1] == "--sched-flash-crowd-rank":
        _sched_flash_crowd_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
    else:
        raise SystemExit("usage: python -m deeplearning_cfn_tpu_torch.chaos.scenarios "
                         "--slice-loss-live-rank SEED ROOT DEVICE | --sched-flash-crowd-rank "
                         "SEED ROOT DEVICE WEIGHTS (one rank; run_scenario starts them)")
