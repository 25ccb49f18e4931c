"""Automated instance-loss recovery: detect → recreate → resume.

The reference documents this loop but leaves every step to the operator:
the master self-heals only via its ASG (StackSetup.md:113-114), worker
replacement never updates cluster metadata (StackSetup.md:107-108), and the
prescribed remedy is "delete the stack, recreate reusing the EFS, restart
from checkpoint" (examples/distributed-tensorflow/README.md:85-87).  Round
1 automated the middle step (``Provisioner.recover()``); this module closes
the loop: the elasticity controller's terminate events *trigger* recovery,
and training resumes from the checkpoints that survived on retained
storage.

On TPU the whole-slice recreate is the right granularity for any loss — a
slice is one logical machine, so a lost coordinator and a lost worker leave
the same stale contract (unlike the reference's asymmetric master/worker
story).  ``RecoveryManager`` therefore arms on every post-freeze loss in a
managed group.

Deliberate split between *detection* (event-driven, may fire mid-step) and
*recovery* (pulled at a safe point): lifecycle events arrive inside
describe/poll calls, where tearing down the very backend state being
described would re-enter the event bus.  Callers check ``needs_recovery``
between training episodes — or just use :func:`run_with_recovery`.

Counterpart of ``deeplearning_cfn_tpu/cluster/recovery.py``, copied: the port
imports nothing of the JAX package.  Both recovery tiers are here: the live
reshard's ``LiveReshardManager`` (``train/reshard.py``), and this
recreate-and-resume loop (``RecoveryManager``, ``run_with_recovery``), the
tier to fall back to when a lost slice can no longer take part in a reshard.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from deeplearning_cfn_tpu_torch.cluster.contract import ClusterContract
from deeplearning_cfn_tpu_torch.cluster.elasticity import ElasticityController, GroupPolicy
from deeplearning_cfn_tpu_torch.obs.recorder import get_recorder
from deeplearning_cfn_tpu_torch.obs.tracing import span
from deeplearning_cfn_tpu_torch.provision.events import LifecycleEvent
from deeplearning_cfn_tpu_torch.provision.provisioner import ProvisionResult, Provisioner
from deeplearning_cfn_tpu_torch.utils.logging import get_logger
from deeplearning_cfn_tpu_torch.utils.resilience import RetryPolicy

log = get_logger("dlcfn.recovery")


@dataclass
class RecoveryManager:
    """Arms on instance-loss events; performs recover-and-rearm on demand."""

    provisioner: Provisioner
    losses: list[LifecycleEvent] = field(default_factory=list)

    def attach(self, result: ProvisionResult) -> None:
        """Subscribe to the live controller (re-call after every recover —
        each provisioning generation has a fresh controller)."""
        result.controller.on_instance_loss = self._on_loss

    def _on_loss(self, policy: GroupPolicy, event: LifecycleEvent) -> None:
        self.losses.append(event)
        log.warning(
            "armed for recovery: lost %s in group %s (%d losses pending)",
            event.instance_id,
            policy.name,
            len(self.losses),
        )

    @property
    def needs_recovery(self) -> bool:
        return bool(self.losses)

    def recover(self) -> ProvisionResult:
        """Recreate the cluster (reusing retained storage), re-arm on the
        new controller, and return the fresh result.  Checkpoints on the
        reused storage make the subsequent training episode resume via
        ``Checkpointer.restore_latest``."""
        lost = [e.instance_id for e in self.losses]
        self.losses.clear()
        log.warning("recovering cluster after instance loss: %s", lost)
        get_recorder().record("recovery_start", lost=lost)
        with span("recover"):
            result = self.provisioner.recover()
        self.attach(result)
        get_recorder().record("recovery_done", lost=lost)
        return result


@dataclass
class LiveReshardManager:
    """Arms on *coalesced slice losses*; derives the surviving topology.

    The in-place analog of :class:`RecoveryManager`: where that one
    recreates the cluster and restarts the training episode, this one
    feeds the live-reshard coordinator (train/reshard.py), which re-forms
    the mesh from ``surviving_contract()`` and migrates state
    device-to-device with no restart at all.  Same detection/recovery
    split as above — ``on_slice_loss`` fires from the controller's
    debounce flush (itself pulled at a step boundary), and the trainer
    consumes ``needs_reshard`` at that safe point.

    ``commit(contract)`` advances the manager to the post-reshard
    topology; a late duplicate flush for an already-removed group is then
    ignored by the ``group in slices`` guard, keeping the whole path
    idempotent under at-least-once event delivery.
    """

    contract: ClusterContract
    lost_groups: set[str] = field(default_factory=set)
    events: list[LifecycleEvent] = field(default_factory=list)
    # Grow direction (the scheduler's restore path): slices armed to
    # RETURN to the contract at the next step boundary.
    pending_restores: dict[str, list[str]] = field(default_factory=dict)

    def attach(self, controller: ElasticityController) -> None:
        controller.on_slice_loss = self.on_slice_loss

    def on_slice_loss(self, group: str, burst: list[LifecycleEvent]) -> None:
        slices = self.contract.slices or {}
        if group not in slices:
            log.info("slice-loss for unknown/already-removed group %s ignored", group)
            return
        self.lost_groups.add(group)
        self.events.extend(burst)
        get_recorder().record(
            "slice_lost",
            group=group,
            instances=sorted(e.instance_id or "?" for e in burst),
        )
        log.warning(
            "armed for live reshard: slice %s lost (%d slices pending)",
            group,
            len(self.lost_groups),
        )

    def arm_restore(self, group: str, ips: list[str]) -> None:
        """Arm the grow direction: slice ``group`` (with ``ips``) returns
        to the contract at the next step boundary.  The inverse of
        ``on_slice_loss``, same safe-point discipline — arming is cheap
        and idempotent (a slice already in the contract is ignored), the
        reshard itself happens when the trainer polls.  This is the
        scheduler's off-peak restore seam (sched/preempt.py)."""
        slices = self.contract.slices or {}
        if group in slices:
            log.info("restore for already-present group %s ignored", group)
            return
        self.pending_restores[group] = list(ips)
        get_recorder().record(
            "slice_restore_armed", group=group, instances=sorted(ips)
        )
        log.warning(
            "armed for live re-grow: slice %s returning (%d restore(s) pending)",
            group,
            len(self.pending_restores),
        )

    @property
    def needs_reshard(self) -> bool:
        return bool(self.lost_groups or self.pending_restores)

    def surviving_contract(self) -> ClusterContract:
        """The target topology: survivors of any lost slices, plus any
        armed restores (``ClusterContract.restored``).  Raises ValueError
        when live reshard is structurally impossible (e.g. the
        coordinator's slice died) — see ClusterContract.surviving."""
        contract = self.contract
        if self.lost_groups:
            contract = contract.surviving(self.lost_groups)
        if self.pending_restores:
            contract = contract.restored(self.pending_restores)
        return contract

    def commit(self, contract: ClusterContract) -> None:
        self.contract = contract
        self.lost_groups.clear()
        self.events.clear()
        self.pending_restores.clear()


def run_with_recovery(
    provisioner: Provisioner,
    train_once: Callable[[ProvisionResult], dict],
    max_recoveries: int = 1,
    policy: RetryPolicy | None = None,
) -> tuple[dict, ProvisionResult, int]:
    """provision → train → (on loss: recover → resume) loop.

    ``train_once(result)`` runs one training episode against a live
    cluster and returns its metrics; it is responsible for checkpointing
    (and for restoring, which makes resumption automatic).  Returns the
    last episode's metrics, the final provision result, and how many
    recoveries happened.

    ``policy`` (a :class:`~..utils.resilience.RetryPolicy`) adds jittered
    backoff between recovery attempts on the policy's injected clock —
    back-to-back recreates against a struggling control plane are the
    same thundering-herd mistake as unjittered RPC retries.  The give-up
    bound stays ``max_recoveries``; the default (no policy) recovers
    immediately, as before.
    """
    result = provisioner.provision()
    manager = RecoveryManager(provisioner)
    manager.attach(result)
    recoveries = 0
    delays = policy.delays() if policy is not None else None
    while True:
        out = train_once(result)
        if not manager.needs_recovery:
            return out, result, recoveries
        if recoveries >= max_recoveries:
            raise RuntimeError(
                f"instance loss after {max_recoveries} recoveries; giving up "
                f"(pending: {[e.instance_id for e in manager.losses]})"
            )
        recoveries += 1
        if delays is not None and policy is not None:
            backoff = next(delays)
            get_recorder().record("recovery_backoff", delay_s=backoff)
            policy.clock.sleep(backoff)
        result = manager.recover()
