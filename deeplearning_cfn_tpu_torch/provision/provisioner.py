"""Provisioner: a validated ClusterSpec -> a live, discovered cluster.

The CloudFormation-engine analog.  Materializes resources in dependency
order exactly as the reference template does (SURVEY §3.1: IAM -> SQS ->
SNS+Lambda -> network -> EFS -> master ASG -> worker ASG,
deeplearning.template:179-901):

1. rendezvous queues (SQS analog, deeplearning.template:743-754)
2. elasticity controller subscribed to the event bus (SNS+Lambda, :755-768)
3. shared storage, create-or-reuse (EFS + EFSFileSystemId condition,
   :453-474, :95-111)
4. the worker group(s) — creating a group fires lifecycle events into the
   controller, which posts group-setup messages consumed by bootstrap
5. bootstrap agents (cfn-init running dl_cfn_setup_v2.py, :521-567)

``wait_until_ready`` is the WaitCondition (deeplearning.template:769-780):
provisioning only counts as complete when the coordinator's agent signals
success within the budget; otherwise a typed failure is raised (the
rollback analog).

Counterpart of ``deeplearning_cfn_tpu/provision/provisioner.py``, copied: the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

from deeplearning_cfn_tpu_torch.cluster.bootstrap import (
    BootstrapAgent,
    BootstrapError,
    cluster_ready_resource,
)
from deeplearning_cfn_tpu_torch.cluster.contract import ClusterContract
from deeplearning_cfn_tpu_torch.cluster.elasticity import ElasticityController, GroupPolicy
from deeplearning_cfn_tpu_torch.config.schema import ClusterSpec, ConfigError, NodePool
from deeplearning_cfn_tpu_torch.provision.backend import Backend, ResourceSignal, StorageHandle
from deeplearning_cfn_tpu_torch.utils.atomicio import atomic_write_text
from deeplearning_cfn_tpu_torch.utils.logging import get_logger
from deeplearning_cfn_tpu_torch.utils.timeouts import BudgetExhausted, TimeoutBudget

log = get_logger("dlcfn.provision")

WORKER_GROUP_SUFFIX = "workers"


def worker_group_name(cluster_name: str) -> str:
    return f"{cluster_name}-{WORKER_GROUP_SUFFIX}"


def worker_group_names(cluster_name: str, slices: int) -> list[str]:
    """One worker group per slice; the single-slice name is unchanged so
    existing clusters/tests keep their identity."""
    if slices <= 1:
        return [worker_group_name(cluster_name)]
    return [
        f"{worker_group_name(cluster_name)}-s{i}" for i in range(slices)
    ]


@dataclass
class ProvisionResult:
    spec: ClusterSpec
    contract: ClusterContract
    storage: StorageHandle
    controller: ElasticityController
    degraded: bool
    job_violation: str | None = None
    # Slices that failed bring-up but were tolerated under min_slices:
    # the cluster is live and smaller, not failed (graceful degradation).
    degraded_slices: list[str] = field(default_factory=list)

    @property
    def realized_workers(self) -> int:
        # Degrade-and-continue means the realized size can be smaller than
        # requested; the operator discovers it here rather than by counting
        # instances in the console (StackSetup.md:55-65).
        return self.contract.workers_count

    @property
    def realized_pool(self) -> NodePool:
        """The pool as it actually materialized (post-degradation)."""
        pool = self.spec.pool
        return NodePool(
            accelerator_type=pool.accelerator_type,
            workers=self.contract.workers_count,
            min_workers=pool.min_workers,
            placement_policy=pool.placement_policy,
            runtime_version=pool.runtime_version,
        )


class ProvisionFailure(RuntimeError):
    pass


class Provisioner:
    def __init__(
        self,
        backend: Backend,
        spec: ClusterSpec,
        contract_root: Path | None = None,
        remote_agents: bool = False,
        progress: "Callable[[float, str], None] | None" = None,
    ):
        """``remote_agents=True`` is the production topology: bootstrap
        agents run on the VMs themselves (``agent_main`` processes reached
        via the broker) and this process only publishes cloud state and
        waits for the coordinator's ready signal — the CloudFormation
        engine's role.  ``False`` runs the agents inline against the
        backend (the fake-cloud simulation used by unit tests).

        ``progress(elapsed_s, status)`` is called once per poll tick during
        any slow wait — the stack drivers' poll-every-30s-printing-elapsed
        behavior (mask-rcnn-stack.sh:84-92)."""
        self.backend = backend
        # Every lifecycle event the backend fires lands in the flight
        # journal alongside the controller's own records (obs plane).
        from deeplearning_cfn_tpu_torch.obs.recorder import get_recorder

        get_recorder().attach_event_bus(backend.events)
        self.spec = spec.validate()
        self.contract_root = contract_root
        self.remote_agents = remote_agents
        self.progress = progress
        self._storage: StorageHandle | None = None
        self._controller = None
        if remote_agents and not hasattr(backend, "publish_group_state"):
            raise ValueError(
                "remote_agents requires a broker-connected backend "
                "(wrap it in BrokerRendezvousBackend)"
            )

    # -- resource names ---------------------------------------------------
    @property
    def group_name(self) -> str:
        return worker_group_name(self.spec.name)

    @property
    def group_names(self) -> list[str]:
        return worker_group_names(self.spec.name, self.spec.pool.slices)

    @property
    def coordinator_queue_name(self) -> str:
        return f"{self.spec.name}-coordinator-queue"

    @property
    def worker_queue_name(self) -> str:
        return f"{self.spec.name}-worker-queue"

    @property
    def ready_queue_name(self) -> str:
        return f"{self.spec.name}-ready-queue"

    # -- create -----------------------------------------------------------
    def provision(self) -> ProvisionResult:
        spec = self.spec
        pool = spec.pool

        if self.remote_agents:
            # A shared broker outlives cluster generations; scrub any
            # signals/broadcasts a previous provision of this name left
            # behind before agents can read them.
            self.backend.reset_cluster_state(
                spec.name,
                self.group_names,
                [
                    self.coordinator_queue_name,
                    self.worker_queue_name,
                    self.ready_queue_name,
                ],
            )
        coord_q = self.backend.create_queue(self.coordinator_queue_name)
        worker_q = self.backend.create_queue(self.worker_queue_name)

        controller = ElasticityController(
            backend=self.backend,
            coordinator_queue_name=self.coordinator_queue_name,
        )
        for i, gname in enumerate(self.group_names):
            controller.register(
                GroupPolicy(
                    name=gname,
                    minimum=pool.min_workers or pool.num_workers,
                    signal_resource=f"group:{gname}",
                    coordinator=(i == 0),
                )
            )
        controller.attach()
        self._controller = controller

        self._storage = self.backend.create_or_reuse_storage(
            kind=spec.storage.kind,
            existing_id=spec.storage.existing_id,
            mount_point=spec.storage.mount_point,
            retain=spec.storage.retain_on_delete,
        )
        log.info(
            "storage %s %s at %s",
            self._storage.storage_id,
            "created" if self._storage.created else "reused",
            self._storage.mount_point,
        )
        # Record the binding as soon as the storage exists — a crash later
        # in provisioning must not leave retained storage undiscoverable
        # by a fresh-process recover().
        self._record_storage()

        # Creating the group(s) fires INSTANCE_LAUNCH / INSTANCE_LAUNCH_ERROR
        # events into the controller (the ASG -> SNS -> Lambda path).  One
        # group per slice: on GCP each is its own queued resource.
        for gname in self.group_names:
            self.backend.create_group(
                gname,
                desired=pool.num_workers,
                minimum=pool.min_workers or pool.num_workers,
                chips_per_worker=pool.chips_per_worker,
            )

        if self.remote_agents:
            contract = self._await_remote_bootstrap(worker_q)
        else:
            if self._inline_bootstrap_is_simulation():
                log.warning(
                    "inline bootstrap over the GCP backend simulates "
                    "worker agents in-process; use --broker for a real "
                    "deployment so on-VM agents prove readiness"
                )
            contract = self._run_bootstrap(coord_q, worker_q)
        # Non-coordinator slices that rendered FAILURE but were tolerated
        # under min_slices: mark them degraded (journaled, queryable on the
        # result) instead of failing the whole bring-up.
        degraded_slices = [
            g
            for g in self.group_names
            if self.backend.get_resource_signal(f"group:{g}")
            is ResourceSignal.FAILURE
        ]
        if degraded_slices:
            from deeplearning_cfn_tpu_torch.obs.recorder import get_recorder

            for g in degraded_slices:
                get_recorder().record(
                    "slice_degraded", cluster=spec.name, group=g
                )
            log.warning(
                "cluster %s came up degraded: slice(s) %s below minimum",
                spec.name,
                degraded_slices,
            )
        result = ProvisionResult(
            spec=spec,
            contract=contract,
            storage=self._storage,
            controller=controller,
            degraded=contract.degraded or bool(degraded_slices),
            degraded_slices=degraded_slices,
        )
        if result.degraded:
            # A shrunken cluster can violate job invariants the original
            # spec satisfied (batch divisibility, even-worker rule).  The
            # cluster still comes up — degrade-and-continue is the contract —
            # but the violation is surfaced here and enforced at launch time,
            # mirroring run.sh:43-44 checking invariants just before mpirun.
            try:
                spec.job.validate(result.realized_pool)
            except ConfigError as e:
                result.job_violation = str(e)
                log.warning(
                    "degraded cluster violates job invariants: %s — adjust the "
                    "job before launch",
                    e,
                )
        self.wait_until_ready()
        return result

    def _inline_bootstrap_is_simulation(self) -> bool:
        """True when inline bootstrap would assert "provisioned" against a
        REAL cloud by simulating workers in this process — the hazard is
        the transport being real, not the backend class (fake/refusing
        transports are the test/dev paths inline exists for)."""
        from deeplearning_cfn_tpu_torch.provision.gcp import (
            FakeGCPTransport,
            GCPBackend,
            NoNetworkTransport,
        )

        return isinstance(self.backend, GCPBackend) and not isinstance(
            self.backend.transport, (FakeGCPTransport, NoNetworkTransport)
        )

    def _run_bootstrap(self, coord_q, worker_q) -> ClusterContract:
        spec = self.spec
        clock = getattr(self.backend, "clock", None)
        budget = (
            TimeoutBudget(spec.timeouts.bootstrap_budget_s, clock=clock)
            if clock is not None
            else TimeoutBudget(spec.timeouts.bootstrap_budget_s)
        )
        # Coordinator = lowest-index healthy instance of slice 0 (the
        # coordinator slice is always required; its wholesale failure is a
        # provisioning failure, matching the on-VM agent's policy).
        group = self.backend.describe_group(self.group_names[0])
        candidates = group.healthy_instances  # includes PENDING
        if not candidates:
            raise ProvisionFailure(
                "no healthy instances launched in the coordinator slice"
            )
        agent = BootstrapAgent(
            backend=self.backend,
            cluster_name=spec.name,
            coordinator_queue=coord_q,
            worker_queue=worker_q,
            group_names=self.group_names,
            budget=budget,
            poll_interval_s=spec.timeouts.poll_interval_s,
            storage_mount=spec.storage.mount_point,
            contract_root=self.contract_root,
            group_signal_resources={
                g: f"group:{g}" for g in self.group_names
            },
            min_groups=spec.pool.min_slices,
        )
        # Worker 0 (lowest index healthy instance) runs the coordinator role.
        coordinator = min(candidates, key=lambda i: i.index)
        coordinator_ip = coordinator.private_ip
        if coordinator_ip is None:
            # It may still be PENDING; the active-wait inside the coordinator
            # role resolves IPs, but we need ours first.
            refreshed = self.backend.describe_instances([coordinator.instance_id])
            coordinator_ip = refreshed[0].private_ip if refreshed else None
        if coordinator_ip is None:
            raise ProvisionFailure("coordinator instance has no IP")
        try:
            contract = agent.run_coordinator(coordinator_ip)
        except (BootstrapError, BudgetExhausted) as e:
            # The reference's master exits 1 and the WaitCondition times out,
            # rolling the stack back (dl_cfn_setup_v2.py:426-428,
            # deeplearning.template:769-780).
            self.backend.signal_resource(
                cluster_ready_resource(spec.name), ResourceSignal.FAILURE
            )
            raise ProvisionFailure(str(e)) from e
        # Remaining workers consume the broadcast (in a real deployment each
        # runs in its own VM; the local backend runs them inline).
        for _ in range(contract.workers_count - 1):
            worker_agent = BootstrapAgent(
                backend=self.backend,
                cluster_name=spec.name,
                coordinator_queue=coord_q,
                worker_queue=worker_q,
                group_names=self.group_names,
                budget=budget,
                poll_interval_s=spec.timeouts.poll_interval_s,
                storage_mount=spec.storage.mount_point,
                contract_root=self.contract_root,
            )
            worker_agent.run_worker()
        return contract

    def _await_remote_bootstrap(self, worker_q) -> ClusterContract:
        """The CloudFormation-engine side of a real deployment: agents run
        on the VMs; this process publishes cloud state for them and blocks
        on the cluster-ready signal (the WaitCondition,
        deeplearning.template:769-780).

        Each poll tick re-publishes the group snapshot so agents see
        instance-state transitions (the describe-loop the reference's
        master ran against EC2 itself, dl_cfn_setup_v2.py:210-281 — here
        run controller-side because only the controller has credentials).
        On SUCCESS the contract is read from the coordinator's worker-setup
        broadcast, which visibility-0/no-delete semantics leave in place
        for late consumers (dl_cfn_setup_v2.py:180-190)."""
        spec = self.spec
        budget = TimeoutBudget(spec.timeouts.cluster_ready_s)
        resource = cluster_ready_resource(spec.name)
        min_groups = spec.pool.min_slices or len(self.group_names)
        phase = "remote-bootstrap"
        while True:
            groups = [
                self.backend.publish_group_state(g) for g in self.group_names
            ]
            signal = self.backend.get_resource_signal(resource)
            if signal is ResourceSignal.SUCCESS:
                break
            if signal is ResourceSignal.FAILURE:
                raise ProvisionFailure(
                    f"cluster {spec.name!r} signaled FAILURE during bootstrap"
                )
            # Fail fast when enough groups rendered a below-minimum verdict
            # that the min_slices policy can no longer be met: if no
            # coordinator VM ever booted, nobody translates group FAILUREs
            # into a cluster-ready FAILURE — the controller must read the
            # verdicts it already rendered instead of burning the budget.
            failed = [
                g
                for g in self.group_names
                if self.backend.get_resource_signal(f"group:{g}")
                is ResourceSignal.FAILURE
            ]
            # The coordinator slice is always required (it hosts the
            # bootstrap choreography — the master-ASG CreationPolicy
            # analog); min_slices governs the rest.
            if (
                self.group_names[0] in failed
                or len(self.group_names) - len(failed) < min_groups
            ):
                self.backend.signal_resource(resource, ResourceSignal.FAILURE)
                raise ProvisionFailure(
                    f"group(s) {failed} failed to reach minimum capacity "
                    f"({len(self.group_names) - len(failed)} surviving, "
                    f"min {min_groups}, coordinator slice required)"
                )
            if self.progress is not None:
                running = sum(
                    1
                    for g in groups
                    for i in g.healthy_instances
                    if i.private_ip
                )
                desired = sum(g.desired for g in groups)
                self.progress(
                    budget.elapsed_s, f"{running}/{desired} workers up"
                )
            try:
                budget.sleep(spec.timeouts.poll_interval_s, phase)
            except BudgetExhausted as e:
                self.backend.signal_resource(resource, ResourceSignal.FAILURE)
                raise ProvisionFailure(
                    f"cluster {spec.name!r} did not become ready within "
                    f"{spec.timeouts.cluster_ready_s:.0f}s"
                ) from e
        # Non-destructive read of the broadcast (late consumers still see it).
        contract: ClusterContract | None = None
        for msg in worker_q.receive(max_messages=10, visibility_timeout_s=0.0):
            if msg.body.get("event") == "worker-setup":
                contract = ClusterContract.from_message(msg.body)
                break
        if contract is None:
            raise ProvisionFailure(
                "cluster signaled ready but no worker-setup broadcast found"
            )
        self._await_worker_acks(contract, budget)
        contract.write(self.contract_root)
        return contract

    def _await_worker_acks(
        self, contract: ClusterContract, budget: TimeoutBudget
    ) -> None:
        """Require a positive worker-ready acknowledgment from every
        non-coordinator worker before declaring the cluster usable.

        The coordinator's SUCCESS only proves instances were RUNNING; a
        worker process that died before publishing its contract would
        otherwise surface as a hang at jax.distributed.initialize.  (The
        reference shipped exactly that trap — only the master signaled the
        WaitCondition; worker health was asserted by ASG instance state
        alone.)"""
        expected = contract.workers_count - 1
        if expected <= 0:
            return
        ready_q = self.backend.get_queue(self.ready_queue_name)
        # Keyed by (group, index): per-slice worker indices restart at 0,
        # so index alone under-counts on multi-slice clusters.
        seen: set[tuple[str, int]] = set()
        phase = "worker-acks"
        while len(seen) < expected:
            for msg in ready_q.receive(max_messages=10, visibility_timeout_s=60.0):
                if msg.body.get("event") == "worker-ready":
                    seen.add(
                        (
                            str(msg.body.get("group", "")),
                            int(msg.body.get("index", -1)),
                        )
                    )
                ready_q.delete(msg.receipt)
            if len(seen) >= expected:
                return
            try:
                budget.sleep(self.spec.timeouts.poll_interval_s, phase)
            except BudgetExhausted as e:
                raise ProvisionFailure(
                    f"only {len(seen)}/{expected} workers acknowledged "
                    "readiness within budget"
                ) from e

    # -- WaitCondition ----------------------------------------------------
    def wait_until_ready(self) -> None:
        signal = self.backend.get_resource_signal(cluster_ready_resource(self.spec.name))
        if signal is not ResourceSignal.SUCCESS:
            raise ProvisionFailure(
                f"cluster {self.spec.name!r} did not signal ready "
                f"(signal={signal}); provisioning rolled back"
            )

    # -- describe / delete (C11-equivalent operations) ---------------------
    def describe(self) -> dict[str, object]:
        groups = [self.backend.describe_group(g) for g in self.group_names]
        out: dict[str, object] = {
            "name": self.spec.name,
            "workers": {
                "desired": sum(g.desired for g in groups),
                "healthy": sum(len(g.healthy_instances) for g in groups),
                "frozen": all(g.replace_unhealthy_suspended for g in groups),
            },
            "storage": self._storage.storage_id if self._storage else None,
            "ready": self.backend.get_resource_signal(
                cluster_ready_resource(self.spec.name)
            )
            is ResourceSignal.SUCCESS,
        }
        if len(groups) > 1:
            out["slices"] = {
                g.name: {
                    "desired": g.desired,
                    "healthy": len(g.healthy_instances),
                }
                for g in groups
            }
        return out

    def delete(self, force_storage: bool = False) -> dict[str, object]:
        if self._controller is not None:
            # A retired controller must not answer lifecycle events for a
            # later cluster with the same name (recover()).
            self._controller.detach()
            self._controller = None
        for gname in self.group_names:
            try:
                self.backend.delete_group(gname)
            except KeyError:
                pass  # never created (e.g. recover of a failed provision)
        storage_deleted = False
        if self._storage is not None:
            storage_deleted = self.backend.delete_storage(
                self._storage.storage_id, force=force_storage
            )
            if not storage_deleted:
                log.info(
                    "storage %s retained (DeletionPolicy: Retain analog; "
                    "checkpoints survive cluster deletion)",
                    self._storage.storage_id,
                )
        return {"storage_deleted": storage_deleted}

    # -- storage record (durable; what recover() reads cross-process) -----
    def _storage_record_path(self) -> Path:
        root = self.contract_root or ClusterContract.root_dir()
        return Path(root) / "storage.json"

    def _record_storage(self) -> None:
        """Persist the storage binding next to the cluster contract so a
        LATER process (the disaster-recovery scenario: the provisioning
        process is gone) can find the retained storage to reuse."""
        if self._storage is None:
            return
        path = self._storage_record_path()
        path.parent.mkdir(parents=True, exist_ok=True)
        # Atomic: recover() in a fresh process must never read a torn
        # record — that would silently abandon retained storage.
        atomic_write_text(
            path,
            json.dumps(
                {
                    "cluster": self.spec.name,
                    "storage_id": self._storage.storage_id,
                    "kind": self._storage.kind,
                    "mount_point": self._storage.mount_point,
                    "retain_on_delete": self._storage.retain_on_delete,
                }
            ),
        )

    def _read_storage_record(self) -> str | None:
        path = self._storage_record_path()
        try:
            record = json.loads(path.read_text())
        except (FileNotFoundError, json.JSONDecodeError):
            return None
        if record.get("cluster") != self.spec.name:
            log.warning(
                "storage record at %s is for cluster %r, not %r; ignoring",
                path, record.get("cluster"), self.spec.name,
            )
            return None
        return record.get("storage_id")

    # -- recover ----------------------------------------------------------
    def recover(self) -> "ProvisionResult":
        """Delete the cluster, recreate it reusing the retained storage,
        and return the fresh provision result — ready to resume from the
        checkpoints that survived on storage.

        Automates the reference's documented (manual) recovery story:
        "delete the stack, recreate it reusing the EFS file system,
        restart training from the last checkpoint"
        (examples/distributed-tensorflow/README.md:85-87; retention via
        DeletionPolicy: Retain, deeplearning.template:456).
        """
        import dataclasses as _dc

        # Priority: live handle (same-process) > durable record written at
        # provision time (cross-process, the real disaster scenario) >
        # spec-pinned existing_id.
        retained = (
            self._storage.storage_id
            if self._storage is not None
            else (self._read_storage_record() or self.spec.storage.existing_id)
        )
        self.delete(force_storage=False)
        if retained is not None and self.backend.storage_exists(
            retained, self.spec.storage.kind
        ):
            self.spec = _dc.replace(
                self.spec,
                storage=_dc.replace(self.spec.storage, existing_id=retained),
            )
            log.info("recovering cluster %s reusing storage %s", self.spec.name, retained)
        else:
            log.warning(
                "recover: no retained storage to reuse (fresh storage will "
                "be created; checkpoints from the previous cluster are gone)"
            )
        return self.provision()
