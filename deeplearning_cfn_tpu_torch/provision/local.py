"""In-memory cloud backend.

The fake-provisioner backend SURVEY §4 prescribes: an in-memory "cloud" that
answers enumerate/launch/fail calls so the discovery/elasticity choreography
— the part of the reference that was never testable without deploying a real
stack — gets unit tests with duplicate-message and partial-capacity cases.

Fault injection knobs:

- ``fail_instance_indices``: those instance slots fail to launch, producing
  INSTANCE_LAUNCH_ERROR events (the degrade-and-continue trigger,
  lambda_function.py:142-169).
- ``duplicate_events``: every lifecycle event publishes twice, modeling
  SNS/SQS at-least-once delivery.
- ``launch_delay_s``: instances stay PENDING until the (injectable) clock
  advances, exercising the wait_until_instances_active polling path
  (dl_cfn_setup_v2.py:210-281).

Counterpart of ``deeplearning_cfn_tpu/provision/local.py``, copied: the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import itertools
from typing import Callable

from deeplearning_cfn_tpu_torch.cluster.queue import InMemoryQueue, RendezvousQueue
from deeplearning_cfn_tpu_torch.provision.backend import (
    Backend,
    Instance,
    InstanceState,
    ResourceSignal,
    StorageHandle,
    WorkerGroup,
)
from deeplearning_cfn_tpu_torch.provision.events import EventBus, EventKind, LifecycleEvent
from deeplearning_cfn_tpu_torch.utils.timeouts import Clock, MonotonicClock


class LocalBackend(Backend):
    def __init__(
        self,
        clock: Clock | None = None,
        fail_instance_indices: dict[str, set[int]] | None = None,
        duplicate_events: bool = False,
        launch_delay_s: float = 0.0,
        queue_factory: Callable[[str], RendezvousQueue] | None = None,
    ):
        """``queue_factory(name) -> RendezvousQueue`` swaps the transport
        (e.g. the native broker) while keeping the fake compute plane —
        used to run the full choreography over the production queue path."""
        self.queue_factory = queue_factory
        self.clock = clock or MonotonicClock()
        self.events = EventBus()
        self.fail_instance_indices = fail_instance_indices or {}
        self.duplicate_events = duplicate_events
        self.launch_delay_s = launch_delay_s
        self._queues: dict[str, RendezvousQueue] = {}
        self._groups: dict[str, WorkerGroup] = {}
        self._instances: dict[str, Instance] = {}
        self._storage: dict[str, StorageHandle] = {}
        self._signals: dict[str, ResourceSignal] = {}
        self._iid = itertools.count(1)
        self._launch_times: dict[str, float] = {}

    # --- queues ---------------------------------------------------------
    def create_queue(self, name: str) -> RendezvousQueue:
        if name not in self._queues:
            if self.queue_factory is not None:
                self._queues[name] = self.queue_factory(name)
            else:
                self._queues[name] = InMemoryQueue(name, clock=self.clock)
        return self._queues[name]

    def get_queue(self, name: str) -> RendezvousQueue:
        return self._queues[name]

    # --- groups ---------------------------------------------------------
    def _publish(self, event: LifecycleEvent) -> None:
        self.events.publish(event)
        if self.duplicate_events:
            self.events.publish(event)

    def create_group(
        self, name: str, desired: int, minimum: int, chips_per_worker: int
    ) -> WorkerGroup:
        if name in self._groups:
            raise ValueError(f"group {name!r} already exists")
        group = WorkerGroup(
            name=name, desired=desired, minimum=minimum, chips_per_worker=chips_per_worker
        )
        self._groups[name] = group
        fail = self.fail_instance_indices.get(name, set())
        # Materialize every launch attempt first, then deliver notifications:
        # ASG lifecycle events reach the Lambda after the group's state
        # reflects all attempts, and the Lambda's get_instance_count reads
        # that settled state (lambda_function.py:67-92).  Publishing
        # mid-creation would make the controller see phantom below-minimum
        # states that never existed in the reference.
        events: list[LifecycleEvent] = []
        for idx in range(desired):
            iid = f"i-{next(self._iid):06x}"
            inst = Instance(
                instance_id=iid,
                group=name,
                index=idx,
                chips=chips_per_worker,
                private_ip=f"10.0.{(len(self._instances) // 250) % 250}.{len(self._instances) % 250 + 2}",
            )
            group.instances.append(inst)
            self._instances[iid] = inst
            if idx in fail:
                inst.state = InstanceState.FAILED
                inst.healthy = False
                inst.private_ip = None
                events.append(
                    LifecycleEvent(
                        kind=EventKind.INSTANCE_LAUNCH_ERROR,
                        group=name,
                        instance_id=iid,
                        detail={"cause": "injected launch failure"},
                    )
                )
                continue
            self._launch_times[iid] = self.clock.now()
            if self.launch_delay_s <= 0:
                inst.state = InstanceState.RUNNING
            events.append(
                LifecycleEvent(
                    kind=EventKind.INSTANCE_LAUNCH, group=name, instance_id=iid
                )
            )
        # Launches before errors: the error handler must observe the full
        # healthy count when deciding degrade-vs-fail.
        events.sort(key=lambda e: e.kind is EventKind.INSTANCE_LAUNCH_ERROR)
        for event in events:
            self._publish(event)
        return group

    def _settle(self) -> None:
        """Promote PENDING instances whose launch delay has elapsed."""
        if self.launch_delay_s <= 0:
            return
        now = self.clock.now()
        for iid, t0 in self._launch_times.items():
            inst = self._instances[iid]
            if inst.state is InstanceState.PENDING and now - t0 >= self.launch_delay_s:
                inst.state = InstanceState.RUNNING

    def describe_group(self, name: str) -> WorkerGroup:
        self._settle()
        return self._groups[name]

    def describe_instances(self, instance_ids: list[str]) -> list[Instance]:
        self._settle()
        return [self._instances[i] for i in instance_ids if i in self._instances]

    def set_desired_capacity(self, group: str, desired: int) -> None:
        self._groups[group].desired = desired

    def suspend_replace_unhealthy(self, group: str) -> None:
        self._groups[group].replace_unhealthy_suspended = True

    def delete_group(self, name: str) -> None:
        group = self._groups.pop(name, None)
        if group:
            for inst in group.instances:
                inst.state = InstanceState.TERMINATED
                self._publish(
                    LifecycleEvent(
                        kind=EventKind.INSTANCE_TERMINATE,
                        group=name,
                        instance_id=inst.instance_id,
                    )
                )

    # --- failure injection post-provision -------------------------------
    def kill_instance(self, instance_id: str) -> None:
        inst = self._instances[instance_id]
        inst.state = InstanceState.TERMINATED
        inst.healthy = False
        self._publish(
            LifecycleEvent(
                kind=EventKind.INSTANCE_TERMINATE,
                group=inst.group,
                instance_id=instance_id,
            )
        )

    # --- storage ---------------------------------------------------------
    def create_or_reuse_storage(
        self, kind: str, existing_id: str | None, mount_point: str, retain: bool
    ) -> StorageHandle:
        if existing_id:
            if existing_id in self._storage:
                handle = self._storage[existing_id]
                return StorageHandle(
                    storage_id=handle.storage_id,
                    kind=handle.kind,
                    mount_point=mount_point,
                    created=False,
                    retain_on_delete=handle.retain_on_delete,
                )
            raise KeyError(f"storage {existing_id!r} does not exist")
        sid = f"fs-{len(self._storage) + 1:04x}"
        handle = StorageHandle(
            storage_id=sid,
            kind=kind,
            mount_point=mount_point,
            created=True,
            retain_on_delete=retain,
        )
        self._storage[sid] = handle
        return handle

    def delete_storage(self, storage_id: str, force: bool = False) -> bool:
        handle = self._storage.get(storage_id)
        if handle is None:
            return False
        if handle.retain_on_delete and not force:
            return False  # DeletionPolicy: Retain (deeplearning.template:456)
        del self._storage[storage_id]
        return True

    def storage_exists(self, storage_id: str, kind: str = "filestore") -> bool:
        return storage_id in self._storage

    # --- signaling -------------------------------------------------------
    def signal_resource(self, resource: str, signal: ResourceSignal) -> None:
        self._signals[resource] = signal

    def get_resource_signal(self, resource: str) -> ResourceSignal | None:
        return self._signals.get(resource)

    def clear_resource_signal(self, resource: str) -> None:
        self._signals.pop(resource, None)
