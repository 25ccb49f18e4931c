"""On-VM bootstrap agent entry point — what every TPU VM runs at boot.

Counterpart of ``deeplearning_cfn_tpu/cluster/agent_main.py``, copied (the port imports
nothing of the JAX package), with the same environment contract and exit codes.

The cfn-init/UserData analog (deeplearning.template:490-516): the queued
resource's startup-script (cluster/startup.py) execs this module on every
worker VM with the cluster identity in env:

  DLCFN_CLUSTER          cluster name (required)
  DLCFN_ROLE             coordinator | worker (default: coordinator iff
                         DLCFN_WORKER_INDEX == 0)
  DLCFN_WORKER_INDEX     this VM's index in its slice
  DLCFN_SLICE            this VM's slice ordinal (default 0); worker 0 of
                         slice 0 is the default coordinator, and the
                         readiness ack carries the slice's group name so
                         per-slice indices stay globally unique
  DLCFN_BROKER_TOKEN     shared-secret for the broker AUTH handshake
                         (stamped into VM metadata at provision; consumed
                         ambiently by every BrokerConnection)
  DLCFN_BROKER           host:port of the rendezvous broker (required —
                         without it the agent has no control plane)
  DLCFN_GROUPS           comma-separated worker-group names
  DLCFN_STORAGE_MOUNT    shared storage mount point
  DLCFN_BOOTSTRAP_BUDGET_S  wallclock budget (default 2700, the
                            reference's 3300-600; dl_cfn_setup_v2.py:411-415)
  DLCFN_POLL_INTERVAL_S  poll cadence (default 30, dl_cfn_setup_v2.py:36)
  DLCFN_MY_IP            coordinator address override; unset = resolve from
                         the harvested group state (worker 0's instance IP)
  DLCFN_ROOT             contract publication dir (default /opt/deeplearning)

The agent runs against :class:`BrokerAgentBackend`: group snapshots,
signals, and queues all come from the broker — a VM needs no cloud
credentials, mirroring how the reference's workers needed only SQS while
the master alone called EC2/ASG (dl_cfn_setup_v2.py:170-208 vs :210-281);
here even the coordinator's "describe" is served by controller-published
snapshots.  Worker 0 runs the coordinator role (waits for group-success,
reads harvested IPs, broadcasts the contract, signals ready); everyone else
waits for the broadcast.  Both end by writing the cluster contract locally,
after which the training job can `source env.sh` and
`torch.distributed.init_process_group`.

The agent's import graph holds no ``torch``: it is a VM's boot process and
never touches the card.  ``DLCFN_BLACKBOX_DIR`` (default
``<tempdir>/dlcfn-blackbox``) is where a failed bootstrap's crash bundle goes.
"""

from __future__ import annotations

import os
import sys
import tempfile

from deeplearning_cfn_tpu_torch.cluster.bootstrap import (
    BootstrapAgent,
    BootstrapError,
    cluster_ready_resource,
)
from deeplearning_cfn_tpu_torch.cluster.broker_backend import BrokerAgentBackend
from deeplearning_cfn_tpu_torch.cluster.broker_client import BrokerError
from deeplearning_cfn_tpu_torch.obs.aggregator import telemetry_source
from deeplearning_cfn_tpu_torch.obs.blackbox import BlackBox
from deeplearning_cfn_tpu_torch.obs.heartbeat import Heartbeater
from deeplearning_cfn_tpu_torch.obs.recorder import get_recorder
from deeplearning_cfn_tpu_torch.provision.backend import ResourceSignal
from deeplearning_cfn_tpu_torch.utils.logging import get_logger
from deeplearning_cfn_tpu_torch.utils.timeouts import BudgetExhausted, TimeoutBudget

log = get_logger("dlcfn.agent")


def main() -> int:
    cluster = os.environ.get("DLCFN_CLUSTER")
    if not cluster:
        log.error("DLCFN_CLUSTER not set; refusing to bootstrap")
        return 2
    broker = os.environ.get("DLCFN_BROKER")
    if not broker or ":" not in broker:
        log.error("DLCFN_BROKER not set (need host:port); refusing to bootstrap")
        return 2
    index = int(os.environ.get("DLCFN_WORKER_INDEX", "0"))
    slice_idx = int(os.environ.get("DLCFN_SLICE", "0") or "0")
    role = os.environ.get("DLCFN_ROLE") or (
        "coordinator" if index == 0 and slice_idx == 0 else "worker"
    )
    host, port = broker.rsplit(":", 1)
    groups = os.environ.get("DLCFN_GROUPS", f"{cluster}-workers").split(",")
    if not (0 <= slice_idx < len(groups)):
        # A silent fallback here would collide readiness acks across
        # slices and mask the misconfiguration; refuse to boot instead.
        log.error(
            "DLCFN_SLICE=%d out of range for DLCFN_GROUPS (%d groups); "
            "refusing to bootstrap", slice_idx, len(groups),
        )
        return 2
    # This VM's own group (slice): worker indices restart at 0 in every
    # slice, so the readiness ack must carry the group to stay unique.
    my_group = groups[slice_idx]
    min_slices_env = os.environ.get("DLCFN_MIN_SLICES", "").strip()
    min_slices = int(min_slices_env) if min_slices_env else None
    budget_s = float(os.environ.get("DLCFN_BOOTSTRAP_BUDGET_S", "2700"))
    poll_s = float(os.environ.get("DLCFN_POLL_INTERVAL_S", "30"))

    budget = TimeoutBudget(budget_s)
    # The broker (on the controller or coordinator host) may come up after
    # this VM boots; retry within the bootstrap budget instead of dying on
    # the first refused connection — the same discipline the reference
    # applied to IAM-credential availability (check_instance_role_availability,
    # dl_cfn_setup_v2.py:359-386).
    backend = None
    while True:
        try:
            backend = BrokerAgentBackend(host, int(port))
            coordinator_queue = backend.get_queue(f"{cluster}-coordinator-queue")
            worker_queue = backend.get_queue(f"{cluster}-worker-queue")
            break
        except OSError as e:
            if backend is not None:
                backend.close()
                backend = None
            log.info("broker at %s not reachable yet (%s); retrying", broker, e)
            try:
                budget.sleep(poll_s, "broker-connect")
            except BudgetExhausted:
                log.error("broker at %s unreachable within budget", broker)
                return 1

    # Liveness: beat at the broker from the moment the control plane is
    # reachable until the agent exits.  The supervisor's liveness watcher
    # (broker_service.BrokerLivenessWatcher) turns sustained silence into
    # an INSTANCE_TERMINATE — so a VM that wedges after connect is
    # detected even though it never reports an error.  Every beat also
    # piggybacks a TELEM snapshot (obs/aggregator.py) so the controller's
    # fleet merge and SLO rules see this host without any extra dial.
    worker_id = f"{my_group}/{index}"
    heartbeater = Heartbeater(
        host,
        int(port),
        worker_id=worker_id,
        telemetry_source=telemetry_source(
            worker_id,
            gauges=lambda: {"dlcfn_mesh_workers": 1.0},
        ),
    )
    heartbeater.start()

    # Crash blackbox: freeze the journal tail + resolved identity on a
    # fatal bootstrap error so `dlcfn postmortem` can reconstruct the
    # cross-host timeline even when this VM is reaped seconds later.
    blackbox = BlackBox(
        out_dir=os.environ.get("DLCFN_BLACKBOX_DIR")
        or os.path.join(tempfile.gettempdir(), "dlcfn-blackbox"),
        host=os.environ.get("DLCFN_WORKER") or worker_id.replace("/", "-"),
        worker=worker_id,
        config={
            "cluster": cluster,
            "group": my_group,
            "index": index,
            "role": role,
            "broker": broker,
        },
    )

    agent = BootstrapAgent(
        backend=backend,
        cluster_name=cluster,
        coordinator_queue=coordinator_queue,
        worker_queue=worker_queue,
        group_names=groups,
        budget=budget,
        poll_interval_s=poll_s,
        storage_mount=os.environ.get("DLCFN_STORAGE_MOUNT", "/mnt/dlcfn"),
        group_signal_resources={g: f"group:{g}" for g in groups},
        min_groups=min_slices,
    )
    try:
        if role == "coordinator":
            contract = agent.run_coordinator(os.environ.get("DLCFN_MY_IP"))
        else:
            contract = agent.run_worker()
            # Positive acknowledgment: the controller counts these so a
            # worker that silently died cannot be declared part of a ready
            # cluster.  (The reference never verified workers — only the
            # master signaled; StackSetup.md:107-108 documents the
            # resulting stale-metadata trap.  This closes it.)
            backend.get_queue(f"{cluster}-ready-queue").send(
                {
                    "event": "worker-ready",
                    "index": index,
                    "group": my_group,
                    "cluster": cluster,
                }
            )
    except (BootstrapError, BudgetExhausted) as e:
        log.error("bootstrap failed: %s", e)
        try:
            blackbox.capture(f"bootstrap-failed: {e}")
        except OSError:
            log.error("blackbox capture failed (disk?)")
        if role == "coordinator":
            # Fail the WaitCondition NOW so the controller rolls back within
            # one poll tick instead of burning the full cluster_ready budget
            # — the exit-1-drives-rollback semantics of the reference's
            # master (dl_cfn_setup_v2.py:426-428, deeplearning.template:769-780).
            try:
                backend.signal_resource(
                    cluster_ready_resource(cluster), ResourceSignal.FAILURE
                )
            except (OSError, BrokerError):
                log.error("could not signal FAILURE to broker")
        return 1
    finally:
        heartbeater.stop()
        backend.close()
    get_recorder().record(
        "bootstrap_complete",
        cluster=cluster,
        group=my_group,
        index=index,
        role=role,
        workers=contract.workers_count,
    )
    log.info(
        "bootstrap complete: %d workers, I am process %d (%s)",
        contract.workers_count,
        index,
        role,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
