"""Broker-backed backend views: cross-process cluster state for real VMs.

Counterpart of ``deeplearning_cfn_tpu/cluster/broker_backend.py``, copied (the port imports
nothing of the JAX package).

Round-1's gap: the on-VM agent (`agent_main`) was handed a fresh in-memory
``LocalBackend``, so the coordinator role couldn't see group state and its
ready-signal landed in VM-local memory the controller never read.  The
reference never had this problem because both sides spoke to AWS: the master
polled ASG/EC2 APIs for instance state (dl_cfn_setup_v2.py:210-281) and
CloudFormation saw the cfn-signal (:286-298).

Here the native broker (native/broker/broker.cpp) plays the role of that
shared cloud state for everything the agents need at bootstrap time:

- **Signals** (WaitCondition / signal_resource analog): stored in the
  broker's KV under ``signal:{resource}``.  The coordinator's SUCCESS is
  visible to the controller process and vice versa.
- **Group-state snapshots** (describe-ASG / describe-instances analog): the
  controller — the only party with cloud-API credentials — polls its real
  backend and publishes each group as JSON under ``group-state:{name}``.
  Agents read the snapshot; they never need cloud credentials, exactly like
  TPU-VM workers that enumerate peers from metadata instead of calling GCE.

Two classes:

- :class:`BrokerAgentBackend` — what ``agent_main`` runs against on a VM:
  signals + group snapshots + queues, all via the broker.  Cloud mutation
  methods are unavailable by design (agents must not need credentials).
- :class:`BrokerRendezvousBackend` — the controller-side wrapper around a
  real backend (local or GCP): queues become broker queues, signals are
  written through to the broker AND the inner backend, and
  :meth:`publish_group_state` exports the inner backend's group view for
  agents to consume.
"""

from __future__ import annotations

import json
from typing import Any

from deeplearning_cfn_tpu_torch.cluster.broker_client import BrokerConnection, BrokerQueue
from deeplearning_cfn_tpu_torch.cluster.queue import RendezvousQueue
from deeplearning_cfn_tpu_torch.provision.backend import (
    Backend,
    Instance,
    InstanceState,
    ResourceSignal,
    StorageHandle,
    WorkerGroup,
)
from deeplearning_cfn_tpu_torch.utils.logging import get_logger

log = get_logger("dlcfn.broker_backend")

SIGNAL_KEY_FMT = "signal:{resource}"
GROUP_STATE_KEY_FMT = "group-state:{name}"


def serialize_group(group: WorkerGroup) -> bytes:
    return json.dumps(
        {
            "name": group.name,
            "desired": group.desired,
            "minimum": group.minimum,
            "chips_per_worker": group.chips_per_worker,
            "replace_unhealthy_suspended": group.replace_unhealthy_suspended,
            "instances": [
                {
                    "instance_id": i.instance_id,
                    "index": i.index,
                    "state": i.state.value,
                    "private_ip": i.private_ip,
                    "healthy": i.healthy,
                    "chips": i.chips,
                }
                for i in group.instances
            ],
        }
    ).encode()


def deserialize_group(raw: bytes) -> WorkerGroup:
    d = json.loads(raw.decode())
    return WorkerGroup(
        name=d["name"],
        desired=int(d["desired"]),
        minimum=int(d["minimum"]),
        chips_per_worker=int(d["chips_per_worker"]),
        replace_unhealthy_suspended=bool(d["replace_unhealthy_suspended"]),
        instances=[
            Instance(
                instance_id=i["instance_id"],
                group=d["name"],
                index=int(i["index"]),
                state=InstanceState(i["state"]),
                private_ip=i["private_ip"],
                healthy=bool(i["healthy"]),
                chips=int(i["chips"]),
            )
            for i in d["instances"]
        ],
    )


class BrokerAgentBackend(Backend):
    """The Backend view an on-VM bootstrap agent has: broker-only.

    No cloud credentials, no mutation of cloud resources — only the three
    capabilities the choreography needs on the VM side: read group
    snapshots, read/write signals, and speak to the rendezvous queues.
    """

    def __init__(self, host: str, port: int):
        self.host = host
        self.port = port
        self._conn = BrokerConnection(host, port)
        self._queues: dict[str, BrokerQueue] = {}

    # --- queues ---------------------------------------------------------
    def create_queue(self, name: str) -> RendezvousQueue:
        # Broker queues materialize on first use; create == get.
        return self.get_queue(name)

    def get_queue(self, name: str) -> RendezvousQueue:
        if name not in self._queues:
            self._queues[name] = BrokerQueue(name, self.host, self.port)
        return self._queues[name]

    # --- group state (read-only snapshots) ------------------------------
    def describe_group(self, name: str) -> WorkerGroup:
        raw = self._conn.get(GROUP_STATE_KEY_FMT.format(name=name))
        if raw is None:
            # Snapshot not published yet: return a placeholder that can
            # never satisfy the instances-active check, so the agent's
            # poll loop keeps waiting instead of crashing (the reference's
            # master likewise loops until describe succeeds,
            # dl_cfn_setup_v2.py:210-281).
            return WorkerGroup(name=name, desired=1, minimum=1, chips_per_worker=0)
        return deserialize_group(raw)

    def describe_instances(self, instance_ids: list[str]) -> list[Instance]:
        raise NotImplementedError(
            "agents read group snapshots, not instance APIs"
        )

    # --- signaling ------------------------------------------------------
    def signal_resource(self, resource: str, signal: ResourceSignal) -> None:
        self._conn.set(SIGNAL_KEY_FMT.format(resource=resource), signal.value.encode())

    def get_resource_signal(self, resource: str) -> ResourceSignal | None:
        raw = self._conn.get(SIGNAL_KEY_FMT.format(resource=resource))
        return ResourceSignal(raw.decode()) if raw is not None else None

    def close(self) -> None:
        self._conn.close()
        for q in self._queues.values():
            q.close()


class BrokerRendezvousBackend(Backend):
    """Controller-side wrapper: a real backend + broker-visible rendezvous.

    Delegates all cloud operations to ``inner`` while routing queues and
    signals through the broker so remote agents participate in the same
    choreography.  Signals are written through to BOTH stores: the inner
    backend remains the source of record for same-process reads (and, for
    the GCP backend, durable GCS markers), the broker makes them visible to
    VMs.  Reads prefer the broker (agents only ever write there).
    """

    def __init__(self, inner: Backend, host: str, port: int):
        self.inner = inner
        self.host = host
        self.port = port
        self._conn = BrokerConnection(host, port)
        self._queues: dict[str, BrokerQueue] = {}

    @property
    def events(self):  # type: ignore[override]
        return self.inner.events

    @property
    def clock(self):
        return getattr(self.inner, "clock", None)

    # --- queues: broker-hosted ------------------------------------------
    def create_queue(self, name: str) -> RendezvousQueue:
        return self.get_queue(name)

    def get_queue(self, name: str) -> RendezvousQueue:
        if name not in self._queues:
            self._queues[name] = BrokerQueue(name, self.host, self.port)
        return self._queues[name]

    # --- re-provision hygiene -------------------------------------------
    def reset_cluster_state(
        self, cluster_name: str, group_names: list[str], queue_names: list[str]
    ) -> None:
        """Clear every broker artifact a previous provision of this cluster
        name may have left behind: ready/failure signals, group signals and
        snapshots, and queued messages.  Without this, a recover() against
        a live broker would read the PREVIOUS cluster's SUCCESS signal and
        worker-setup broadcast and return a contract full of dead IPs —
        the broker, unlike CloudFormation's per-stack WaitCondition handle,
        is shared across cluster generations."""
        from deeplearning_cfn_tpu_torch.cluster.bootstrap import cluster_ready_resource

        ready = cluster_ready_resource(cluster_name)
        self._conn.unset(SIGNAL_KEY_FMT.format(resource=ready))
        self.inner.clear_resource_signal(ready)
        for g in group_names:
            self._conn.unset(SIGNAL_KEY_FMT.format(resource=f"group:{g}"))
            self.inner.clear_resource_signal(f"group:{g}")
            self._conn.unset(GROUP_STATE_KEY_FMT.format(name=g))
        for q in queue_names:
            self.get_queue(q).purge()

    # --- group state: delegate + publish --------------------------------
    def publish_group_state(self, name: str) -> WorkerGroup:
        """Export the inner backend's current group view to the broker —
        the controller's describe-loop makes cloud state visible to
        credential-less agents (run on every poll tick).  Returns the
        group so callers can reuse the describe instead of re-issuing the
        cloud API read."""
        group = self.inner.describe_group(name)
        self._conn.set(GROUP_STATE_KEY_FMT.format(name=name), serialize_group(group))
        return group

    def create_group(self, name: str, desired: int, minimum: int, chips_per_worker: int) -> WorkerGroup:
        group = self.inner.create_group(name, desired, minimum, chips_per_worker)
        self.publish_group_state(name)
        return group

    def describe_group(self, name: str) -> WorkerGroup:
        return self.inner.describe_group(name)

    def describe_instances(self, instance_ids: list[str]) -> list[Instance]:
        return self.inner.describe_instances(instance_ids)

    def set_desired_capacity(self, group: str, desired: int) -> None:
        self.inner.set_desired_capacity(group, desired)
        self.publish_group_state(group)

    def suspend_replace_unhealthy(self, group: str) -> None:
        self.inner.suspend_replace_unhealthy(group)
        self.publish_group_state(group)

    def delete_group(self, name: str) -> None:
        self.inner.delete_group(name)

    # --- storage: delegate ----------------------------------------------
    def create_or_reuse_storage(
        self, kind: str, existing_id: str | None, mount_point: str, retain: bool
    ) -> StorageHandle:
        return self.inner.create_or_reuse_storage(kind, existing_id, mount_point, retain)

    def delete_storage(self, storage_id: str, force: bool = False) -> bool:
        return self.inner.delete_storage(storage_id, force=force)

    def storage_exists(self, storage_id: str, kind: str = "filestore") -> bool:
        return self.inner.storage_exists(storage_id, kind)

    # --- signaling: write-through, broker-preferred reads ----------------
    def signal_resource(self, resource: str, signal: ResourceSignal) -> None:
        self._conn.set(SIGNAL_KEY_FMT.format(resource=resource), signal.value.encode())
        self.inner.signal_resource(resource, signal)

    def get_resource_signal(self, resource: str) -> ResourceSignal | None:
        raw = self._conn.get(SIGNAL_KEY_FMT.format(resource=resource))
        if raw is not None:
            return ResourceSignal(raw.decode())
        return self.inner.get_resource_signal(resource)

    def clear_resource_signal(self, resource: str) -> None:
        self._conn.unset(SIGNAL_KEY_FMT.format(resource=resource))
        self.inner.clear_resource_signal(resource)

    # --- passthrough for backend extras (kill_instance etc.) -------------
    def __getattr__(self, item: str) -> Any:
        return getattr(self.inner, item)
