"""Bootstrap / discovery agent — runs on every worker at startup.

TPU-native rebuild of cfn-bootstrap/dl_cfn_setup_v2.py.  Every worker VM in
a slice runs this same agent; role is decided by worker index (worker 0 is
the coordinator — the "master is also worker #1" rule, StackSetup.md:110-111)
rather than an AWS_DL_NODE_TYPE env var.

Coordinator phases (dl_cfn_setup_v2.py:389-436):

1. ``wait_for_credentials`` — poll until the platform identity is usable
   (check_instance_role_availability, :359-386).
2. ``wait_for_group_success`` — poll the coordinator queue until a
   ``group-setup`` success message is seen for EVERY registered group,
   deduping at-least-once redelivery by group name (:123-168, dedup
   :142-149); consumed messages are deleted (:150).
3. ``wait_until_instances_active`` — poll the backend until every healthy
   instance is RUNNING and has an IP (:210-281).
4. Build + publish the contract, broadcast ``worker-setup`` on the worker
   queue (:346-357), and signal the cluster WaitCondition (:286-298).

Worker phases: wait for the broadcast with ``visibility_timeout=0`` and
never delete it so one message reaches all workers (:170-208, trick
:180-190), then publish the same contract locally.

All waits draw from one :class:`TimeoutBudget`
(setup_timeout = cluster_ready - controller_launch, :411-415), and each
phase raises a typed error naming itself on exhaustion — the analog of the
per-phase error exits (:309-311, 327-329, 426-428).

Counterpart of ``deeplearning_cfn_tpu/cluster/bootstrap.py``, copied: the port imports
nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

from deeplearning_cfn_tpu_torch.cluster.contract import ClusterContract
from deeplearning_cfn_tpu_torch.cluster.elasticity import GROUP_SETUP_EVENT
from deeplearning_cfn_tpu_torch.cluster.queue import RendezvousQueue
from deeplearning_cfn_tpu_torch.provision.backend import Backend, InstanceState, ResourceSignal
from deeplearning_cfn_tpu_torch.utils.logging import get_logger
from deeplearning_cfn_tpu_torch.utils.timeouts import TimeoutBudget

log = get_logger("dlcfn.bootstrap")

def cluster_ready_resource(cluster_name: str) -> str:
    """Per-cluster WaitCondition resource name — namespaced so clusters
    sharing a backend cannot read each other's ready/failure signals."""
    return f"cluster-ready:{cluster_name}"


class BootstrapError(RuntimeError):
    def __init__(self, phase: str, message: str):
        super().__init__(f"[{phase}] {message}")
        self.phase = phase


@dataclass
class GroupSetupResult:
    group: str
    launched: int
    degraded: bool


@dataclass
class BootstrapAgent:
    backend: Backend
    cluster_name: str
    coordinator_queue: RendezvousQueue
    worker_queue: RendezvousQueue
    group_names: list[str]
    budget: TimeoutBudget
    poll_interval_s: float = 30.0
    storage_mount: str = "/mnt/dlcfn"
    contract_root: Path | None = None
    # group -> signal-resource name; must match GroupPolicy.signal_resource
    # registered with the controller (provisioner wires both sides).
    group_signal_resources: dict[str, str] | None = None
    credential_probe: Callable[[], bool] = lambda: True
    # SQS batch size from the reference (dl_cfn_setup_v2.py:36-37,139-141)
    receive_batch: int = 10
    visibility_timeout_s: float = 60.0
    # Multi-slice degrade policy: None = every group must succeed (a group
    # FAILURE aborts bootstrap); an int = the cluster proceeds as long as
    # at least this many groups (slices) succeed, DROPPING failed ones from
    # the contract — the slice-granularity shape of degrade-and-continue
    # (a TPU slice fails whole, unlike an ASG that shrinks;
    # lambda_function.py:142-169 is the per-instance original).
    min_groups: int | None = None
    failed_groups: set[str] = field(default_factory=set)

    # --- phase 1: credentials -------------------------------------------
    def wait_for_credentials(self) -> None:
        phase = "credentials"
        while not self.credential_probe():
            log.info("platform credentials not yet available; retrying")
            self.budget.sleep(self.poll_interval_s, phase)
        self.budget.check(phase)

    # --- phase 2: group success messages (coordinator) -------------------
    def wait_for_group_success(self) -> dict[str, GroupSetupResult]:
        phase = "group-success"
        pending = set(self.group_names)
        results: dict[str, GroupSetupResult] = {}
        while pending:
            self.budget.check(phase)
            # Fail fast if the controller already rendered a FAILURE verdict
            # (below-minimum capacity) — the definitive signal is on the
            # group resource; waiting out the whole budget would burn ~45
            # real minutes for an answer that is already known.
            signal_names = self.group_signal_resources or {}
            for name in list(pending):
                if (
                    self.backend.get_resource_signal(
                        signal_names.get(name, f"group:{name}")
                    )
                    is ResourceSignal.FAILURE
                ):
                    self._record_group_failure(phase, name)
                    pending.discard(name)
            messages = self.coordinator_queue.receive(
                max_messages=self.receive_batch,
                visibility_timeout_s=self.visibility_timeout_s,
            )
            for msg in messages:
                body = msg.body
                if body.get("event") != GROUP_SETUP_EVENT:
                    log.info("ignoring non-setup message: %s", body.get("event"))
                    self.coordinator_queue.delete(msg.receipt)
                    continue
                group = body.get("group")
                if group in results:
                    # At-least-once redelivery: dedup by group name
                    # (dl_cfn_setup_v2.py:142-149).
                    log.info("duplicate group-setup for %s deduped", group)
                elif group in pending:
                    if body.get("status") != "success":
                        self._record_group_failure(
                            phase,
                            str(group),
                            f"reported {body.get('status')!r}",
                        )
                        pending.discard(str(group))
                        self.coordinator_queue.delete(msg.receipt)
                        continue
                    results[group] = GroupSetupResult(
                        group=str(group),
                        launched=int(body.get("launched", 0)),
                        degraded=bool(body.get("degraded", False)),
                    )
                    pending.discard(str(group))
                    log.info(
                        "group %s ready (launched=%d degraded=%s); %d group(s) pending",
                        group,
                        results[str(group)].launched,
                        results[str(group)].degraded,
                        len(pending),
                    )
                else:
                    log.info("group-setup for unknown group %s ignored", group)
                self.coordinator_queue.delete(msg.receipt)
            if pending:
                self.budget.sleep(self.poll_interval_s, phase)
        return results

    def _record_group_failure(
        self, phase: str, name: str, cause: str = "failed to reach minimum capacity"
    ) -> None:
        """A group (slice) failed: abort unless the min_groups policy says
        the cluster can proceed without it.

        The coordinator slice (group_names[0]) is always required — it
        hosts the agent running this very choreography, so it cannot be
        dropped (the reference has the same asymmetry: the master ASG's
        CreationPolicy fails the stack if the master doesn't launch,
        deeplearning.template:669-674, while worker capacity degrades)."""
        self.failed_groups.add(name)
        surviving = len(self.group_names) - len(self.failed_groups)
        if (
            name == self.group_names[0]
            or self.min_groups is None
            or surviving < self.min_groups
        ):
            raise BootstrapError(phase, f"group {name} {cause}")
        log.warning(
            "dropping failed slice %s (%s); %d/%d slices remain (min %d)",
            name, cause, surviving, len(self.group_names), self.min_groups,
        )

    @property
    def surviving_groups(self) -> list[str]:
        return [g for g in self.group_names if g not in self.failed_groups]

    # --- phase 3: instances active ---------------------------------------
    def wait_until_instances_active(self) -> dict[str, list[str]]:
        """Poll until every healthy instance of every group is RUNNING with
        an IP; returns {group: [ips]} (dl_cfn_setup_v2.py:210-281)."""
        phase = "instances-active"
        ips: dict[str, list[str]] = {}
        while True:
            self.budget.check(phase)
            ips.clear()
            all_running = True
            for name in self.surviving_groups:
                group = self.backend.describe_group(name)
                healthy = group.healthy_instances
                running = [
                    i
                    for i in healthy
                    if i.state is InstanceState.RUNNING and i.private_ip
                ]
                if len(running) < group.desired:
                    all_running = False
                    log.info(
                        "group %s: %d/%d running", name, len(running), group.desired
                    )
                    break
                ips[name] = [i.private_ip for i in running if i.private_ip]
            if all_running:
                return ips
            self.budget.sleep(self.poll_interval_s, phase)

    # --- phase 4: contract + broadcast + signal ---------------------------
    def _publish_contract(self, contract: ClusterContract) -> None:
        contract.write(self.contract_root)

    def run_coordinator(self, my_ip: str | None = None) -> ClusterContract:
        """Run the master role.  ``my_ip=None`` resolves the coordinator's
        address from the harvested group state: worker 0 = the lowest-index
        instance of the first group (the master-is-also-worker-#1 rule,
        dl_cfn_setup_v2.py:330-342) — on a real slice that IS this VM, and
        it is the address every peer will dial, which matters more than
        what a local socket probe reports."""
        self.wait_for_credentials()
        results = self.wait_for_group_success()
        ips_by_group = self.wait_until_instances_active()
        surviving = self.surviving_groups
        if my_ip is None:
            group0 = self.backend.describe_group(surviving[0])
            me = min(
                (
                    i
                    for i in group0.healthy_instances
                    if i.state is InstanceState.RUNNING and i.private_ip
                ),
                key=lambda i: i.index,
                default=None,
            )
            if me is None or me.private_ip is None:
                raise BootstrapError(
                    "contract", "cannot resolve coordinator IP from group state"
                )
            my_ip = me.private_ip
        all_ips = [ip for name in surviving for ip in ips_by_group[name]]
        degraded = any(r.degraded for r in results.values()) or bool(
            self.failed_groups
        )
        chips = max(
            self.backend.describe_group(name).chips_per_worker
            for name in surviving
        )
        contract = ClusterContract.build(
            cluster_name=self.cluster_name,
            coordinator_ip=my_ip,
            other_worker_ips=all_ips,
            chips_per_worker=chips,
            storage_mount=self.storage_mount,
            degraded=degraded,
            # Slice topology (multi-slice only): lets compute derive the
            # hybrid ICI x DCN mesh from the contract alone.
            slices=(
                {name: ips_by_group[name] for name in surviving}
                if len(self.group_names) > 1
                else None
            ),
        )
        self._publish_contract(contract)
        self.worker_queue.send(contract.to_message())
        self.backend.signal_resource(
            cluster_ready_resource(self.cluster_name), ResourceSignal.SUCCESS
        )
        log.info(
            "cluster %s ready: %d workers x %d chips%s",
            self.cluster_name,
            contract.workers_count,
            contract.chips_per_worker,
            " (DEGRADED)" if degraded else "",
        )
        return contract

    def run_worker(self) -> ClusterContract:
        self.wait_for_credentials()
        phase = "worker-setup"
        while True:
            self.budget.check(phase)
            # visibility_timeout=0 + no delete of the broadcast: the trick
            # that lets one worker-setup message reach every worker
            # (dl_cfn_setup_v2.py:180-190).  Scan a full batch so a stray
            # message at the head of the queue cannot shadow the broadcast
            # forever; strays are deleted (worker-setup is the only message
            # type ever broadcast on this queue, so junk is junk for every
            # consumer).
            messages = self.worker_queue.receive(
                max_messages=self.receive_batch, visibility_timeout_s=0.0
            )
            for msg in messages:
                if msg.body.get("event") == "worker-setup":
                    contract = ClusterContract.from_message(msg.body)
                    self._publish_contract(contract)
                    return contract
                log.info("deleting stray message %s on worker queue", msg.body.get("event"))
                self.worker_queue.delete(msg.receipt)
            self.budget.sleep(self.poll_interval_s, phase)
