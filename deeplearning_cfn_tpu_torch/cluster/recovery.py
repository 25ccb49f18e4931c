"""Slice-loss recovery — counterpart of ``deeplearning_cfn_tpu/cluster/recovery.py``.

Ported: :class:`LiveReshardManager`, whole — it arms on the elasticity
controller's coalesced slice losses and derives the surviving topology that
the live-reshard coordinator (``train/reshard.py``) re-forms the mesh from.
Same detection/recovery split as the JAX package: ``on_slice_loss`` fires
from the controller's debounce flush (itself pulled at a step boundary), and
the trainer consumes ``needs_reshard`` at that safe point.

``RecoveryManager`` and ``run_with_recovery`` (detect, recreate the cluster
on retained storage, resume from checkpoint) drive
``provision/provisioner.py``, which comes with the provisioning plane in a
later slice: they raise ``NotImplementedError`` naming it.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from deeplearning_cfn_tpu_torch.cluster.contract import ClusterContract
from deeplearning_cfn_tpu_torch.cluster.elasticity import ElasticityController
from deeplearning_cfn_tpu_torch.obs.recorder import get_recorder
from deeplearning_cfn_tpu_torch.provision.events import LifecycleEvent
from deeplearning_cfn_tpu_torch.utils.logging import get_logger

log = get_logger("dlcfn.recovery")

PROVISIONING_SLICE = ("a later slice of the PyTorch port (the provisioning plane: "
                      "provision/provisioner.py, which the recreate-and-resume loop drives)")


class RecoveryManager:
    """Arms on instance-loss events and recreates the cluster: ported with
    the provisioning plane."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"RecoveryManager is ported in {PROVISIONING_SLICE}")


def run_with_recovery(*args, **kwargs):
    """provision -> train -> (on loss: recover -> resume): ported with the
    provisioning plane."""
    raise NotImplementedError(f"run_with_recovery is ported in {PROVISIONING_SLICE}")


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
