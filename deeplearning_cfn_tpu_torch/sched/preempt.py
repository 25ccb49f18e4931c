"""The preemption driver: arbiter decisions -> cluster mechanisms —
counterpart of ``deeplearning_cfn_tpu/sched/preempt.py``, copied.

The arbiter (sched/arbiter.py) decides WHAT moves; this module knows
HOW, by composing seams that already exist:

* **Train shrink** — a preemption is a *controlled* slice loss, so it
  rides the live-reshard path wholesale: the driver publishes synthetic
  ``INSTANCE_TERMINATE`` events for the lent slice's hosts on the job's
  event bus, the terminate debouncer coalesces them, and the trainer's
  next step boundary executes the same device-to-device reshard a real
  slice death would (train/reshard.py).  Grad accumulation rescales so
  the global batch is preserved on the smaller mesh.
* **Train grow** — the off-peak restore arms the reshard manager's grow
  direction (``LiveReshardManager.arm_restore``); the next step boundary
  re-forms the full mesh and, with ``symmetric_accum``, returns grad
  accumulation to exactly its pre-preempt value — the restore is
  bit-safe, not merely monotone.  In the port a preempted slice's rank
  processes stay in the process group, parked
  (``LiveReshardCoordinator.rejoin``), and rejoin at the grow
  boundary; a slice whose processes are gone takes the checkpoint
  fallback instead.
* **Serve lend/reclaim** — freed slices become replicas through the
  front-end's pool-resize seam (``ServeFrontEnd.add_replica`` /
  ``retire_replica``); reclaim replays any stragglers onto survivors so
  the zero-loss contract holds through the resize.

The driver is deliberately stateless across crashes: the arbiter's
ledger (persisted through the broker KV) is the source of truth for
outstanding loans, and every driver action is idempotent at the layer
below (duplicate terminates dedup in the debouncer; ``arm_restore`` of
a present slice is a no-op; retiring an absent replica returns None).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

from deeplearning_cfn_tpu_torch.obs.recorder import get_recorder
from deeplearning_cfn_tpu_torch.utils.logging import get_logger

log = get_logger("dlcfn.sched")


@dataclass
class TrainJobHandle:
    """Live wiring for one train job.  ``bus`` routes shrink through the
    real terminate path (debouncer -> manager); when absent the driver
    arms the manager directly (unit tests, headless placement)."""

    manager: Any  # cluster/recovery.LiveReshardManager (duck-typed)
    bus: Any = None  # provision/events.EventBus (duck-typed publish())


@dataclass
class ServePoolHandle:
    """Live wiring for one serve job: the front-end plus a factory that
    turns a lent slice into a replica (``spawn(replica_name) ->
    ServeReplica``)."""

    frontend: Any  # serve/replica.ServeFrontEnd (duck-typed)
    spawn: Callable[[str], Any]


@dataclass
class PreemptionDriver:
    """Executes shrink/lend and reclaim/grow for the arbiter."""

    train_jobs: dict[str, TrainJobHandle] = field(default_factory=dict)
    serve_pools: dict[str, ServePoolHandle] = field(default_factory=dict)
    actions: list[tuple[str, str, str]] = field(default_factory=list)

    def register_train(self, name: str, handle: TrainJobHandle) -> None:
        self.train_jobs[name] = handle

    def register_serve(self, name: str, handle: ServePoolHandle) -> None:
        self.serve_pools[name] = handle

    @staticmethod
    def replica_name(job: str, slice_name: str) -> str:
        return f"{job}-{slice_name}"

    def shrink(self, job: str, slice_name: str, ips: list[str]) -> bool:
        """Take ``slice_name`` away from train job ``job``.  Returns
        False (decision deferred, arbiter keeps it pending) when the job
        has no registered handle — placement-only arbiters plan without
        executing."""
        handle = self.train_jobs.get(job)
        if handle is None:
            return False
        self.actions.append(("shrink", job, slice_name))
        if handle.bus is not None:
            from deeplearning_cfn_tpu_torch.provision.events import (
                EventKind,
                LifecycleEvent,
            )

            for ip in ips:
                handle.bus.publish(
                    LifecycleEvent(
                        kind=EventKind.INSTANCE_TERMINATE,
                        group=slice_name,
                        instance_id=ip,
                        detail={"reason": "sched-preempt"},
                    )
                )
        else:
            from deeplearning_cfn_tpu_torch.provision.events import (
                EventKind,
                LifecycleEvent,
            )

            handle.manager.on_slice_loss(
                slice_name,
                [
                    LifecycleEvent(
                        kind=EventKind.INSTANCE_TERMINATE,
                        group=slice_name,
                        instance_id=ip,
                        detail={"reason": "sched-preempt"},
                    )
                    for ip in ips
                ],
            )
        log.warning(
            "preempt: shrinking train job %s by slice %s (%d host(s))",
            job, slice_name, len(ips),
        )
        return True

    def grow(self, job: str, slice_name: str, ips: list[str]) -> bool:
        """Return ``slice_name`` to train job ``job`` (the off-peak
        restore).  The mesh re-grows at the job's next step boundary."""
        handle = self.train_jobs.get(job)
        if handle is None:
            return False
        self.actions.append(("grow", job, slice_name))
        handle.manager.arm_restore(slice_name, ips)
        log.warning(
            "restore: growing train job %s back by slice %s", job, slice_name
        )
        return True

    def lend(self, job: str, slice_name: str) -> bool:
        """Spin the lent slice up as a replica in ``job``'s pool."""
        handle = self.serve_pools.get(job)
        if handle is None:
            return False
        name = self.replica_name(job, slice_name)
        self.actions.append(("lend", job, slice_name))
        handle.frontend.add_replica(handle.spawn(name))
        return True

    def reclaim(self, job: str, slice_name: str) -> bool:
        """Retire the lent slice's replica from ``job``'s pool.  Forced:
        in-flight requests replay onto survivors (zero-loss), matching
        the failover path's durability contract."""
        handle = self.serve_pools.get(job)
        if handle is None:
            return False
        name = self.replica_name(job, slice_name)
        self.actions.append(("reclaim", job, slice_name))
        retired = handle.frontend.retire_replica(name, force=True)
        if retired is None:
            get_recorder().record(
                "sched_reclaim_missing", job=job, replica=name
            )
        return True
