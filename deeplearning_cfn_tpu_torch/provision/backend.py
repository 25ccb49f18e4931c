"""Backend interface: what a cloud must provide to host a cluster.
Counterpart of ``deeplearning_cfn_tpu/provision/backend.py``, copied.

This is the seam between the provisioner and a real cloud.  The reference's
equivalent seam is the set of AWS APIs its template and scripts drive: ASG
create/describe/suspend/set-desired (deeplearning.template:666-742,
lambda_function.py:94-169), EC2 describe-instances for IP harvest
(dl_cfn_setup_v2.py:210-281), SQS create/send/receive, EFS create-or-reuse
(deeplearning.template:453-474), and CloudFormation resource signaling
(:769-780).  Each method below is the TPU-native projection of one of those.

Implementations: :class:`~deeplearning_cfn_tpu_torch.provision.local.LocalBackend`
(in-memory, for tests and single-host runs) and
:class:`~deeplearning_cfn_tpu_torch.provision.gcp.GCPBackend` (TPU VM API).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from deeplearning_cfn_tpu_torch.cluster.queue import RendezvousQueue
from deeplearning_cfn_tpu_torch.provision.events import EventBus


class InstanceState(enum.Enum):
    PENDING = "pending"  # EC2 'pending' analog (dl_cfn_setup_v2.py:247-259)
    RUNNING = "running"
    FAILED = "failed"
    TERMINATED = "terminated"


@dataclass
class Instance:
    instance_id: str
    group: str
    index: int
    state: InstanceState = InstanceState.PENDING
    private_ip: str | None = None
    healthy: bool = True
    chips: int = 0


@dataclass
class WorkerGroup:
    """An autoscaling-group analog: a named pool with desired/min size.

    ``replace_unhealthy_suspended`` mirrors suspending the ASG's
    ReplaceUnhealthy process to freeze membership once discovery has cut the
    hostfile (lambda_function.py:129-132).
    """

    name: str
    desired: int
    minimum: int
    chips_per_worker: int
    instances: list[Instance] = field(default_factory=list)
    replace_unhealthy_suspended: bool = False

    @property
    def healthy_instances(self) -> list[Instance]:
        return [
            i
            for i in self.instances
            if i.healthy and i.state in (InstanceState.PENDING, InstanceState.RUNNING)
        ]


@dataclass
class StorageHandle:
    storage_id: str
    kind: str
    mount_point: str
    created: bool  # False when reused (EFSFileSystemId-style reuse)
    retain_on_delete: bool = True


class ResourceSignal(enum.Enum):
    SUCCESS = "SUCCESS"
    FAILURE = "FAILURE"


class Backend:
    """Cloud operations required by the provisioner + controller + agents."""

    events: EventBus

    # --- queues (SQS analog) -------------------------------------------
    def create_queue(self, name: str) -> RendezvousQueue:
        raise NotImplementedError

    def get_queue(self, name: str) -> RendezvousQueue:
        raise NotImplementedError

    # --- worker groups (ASG analog) ------------------------------------
    def create_group(
        self, name: str, desired: int, minimum: int, chips_per_worker: int
    ) -> WorkerGroup:
        raise NotImplementedError

    def describe_group(self, name: str) -> WorkerGroup:
        raise NotImplementedError

    def describe_instances(self, instance_ids: list[str]) -> list[Instance]:
        raise NotImplementedError

    def set_desired_capacity(self, group: str, desired: int) -> None:
        raise NotImplementedError

    def suspend_replace_unhealthy(self, group: str) -> None:
        raise NotImplementedError

    def delete_group(self, name: str) -> None:
        raise NotImplementedError

    # --- storage (EFS/Filestore analog) --------------------------------
    def create_or_reuse_storage(
        self, kind: str, existing_id: str | None, mount_point: str, retain: bool
    ) -> StorageHandle:
        raise NotImplementedError

    def delete_storage(self, storage_id: str, force: bool = False) -> bool:
        """Returns True if deleted; False if retained by policy."""
        raise NotImplementedError

    def storage_exists(self, storage_id: str, kind: str = "filestore") -> bool:
        """Whether retained storage is still present (recover() checks
        before reusing).  ``kind`` selects the API surface to probe (e.g.
        filestore instance vs GCS bucket)."""
        raise NotImplementedError

    # --- stack signaling (WaitCondition / signal_resource analog) ------
    def signal_resource(self, resource: str, signal: ResourceSignal) -> None:
        raise NotImplementedError

    def get_resource_signal(self, resource: str) -> ResourceSignal | None:
        raise NotImplementedError

    def clear_resource_signal(self, resource: str) -> None:
        """Remove a signal so a later provisioning generation of the same
        cluster name starts clean (recover() reuses names; CloudFormation
        got this for free from per-stack WaitCondition handles)."""
        raise NotImplementedError
