"""Chaos scenarios — counterpart of ``deeplearning_cfn_tpu/chaos/scenarios.py``.

Ported: :class:`ScenarioReport` (the report's wire shape, schema 2) and the
``slice-loss-live`` scenario, the JAX package's own driver of the live
reshard, with its invariants, on the port's trainer.  The JAX scenario runs
one SPMD trainer over eight virtual CPU devices in one process; here every
rank is a process: four gloo ranks (2 slices x fsdp 2, one rank a
worker), each running its own ``fit``, and this process checks the
invariants on what the ranks report.  The other scenarios (silent death,
partitions, the broker's failover, the data plane's writer crash, serving,
the scheduler, the gauntlet) drive planes that later slices port.

Run one with ``python -m deeplearning_cfn_tpu_torch.cli chaos --scenario
slice-loss-live --seed N``: its ranks train on the card (all on ``cuda:0``
of a one-card host, still over gloo), or on the CPU with ``--device cpu``;
the report is deterministic per seed.
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


def _spawn_ranks(seed: int, root: str, device: str) -> list[dict[str, Any]]:
    """Run ``slice-loss-live``'s ranks as processes of one gloo group on
    this host; each rank's results.  A rank that fails raises."""
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
             "--slice-loss-live-rank", str(seed), root, device],
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
        raise RuntimeError("a slice-loss-live rank failed:\n" + errors[0])
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


SCENARIOS: dict[str, Callable[[int], ScenarioReport]] = {
    "slice-loss-live": slice_loss_live,
}

#: The fault kinds each scenario injects (the JAX catalog's entries).
SCENARIO_FAULTS: dict[str, tuple[str, ...]] = {
    "slice-loss-live": ("slice-loss", "forced-fallback"),
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
    else:
        raise SystemExit("usage: python -m deeplearning_cfn_tpu_torch.chaos.scenarios "
                         "--slice-loss-live-rank SEED ROOT DEVICE (one rank; run_scenario "
                         "starts them)")
