"""Command line of the port — counterpart of ``deeplearning_cfn_tpu/cli.py``.

Run as ``python -m deeplearning_cfn_tpu_torch.cli <command>``.  Ported so
far, each the counterpart of the ``dlcfn`` command of its name:

  validate <template.json> [-P k=v ...]     render + validate only
  create   <template.json> [-P k=v ...]     provision a cluster
  describe <template.json> [-P k=v ...]     realized state
  delete   <template.json> [--force-storage]
  recover  <template.json>                  recreate on the retained storage
  plan     <template.json>                  render the launch plan
  run      <template.json> [--auto-recover N]  provision + run the job
  startup-script, stage, gen-scripts        worker boot script, staging,
                                            per-host launch scripts
  serve, convert, events, status, trace, postmortem
  sched --ledger PATH [--init s0=4,...] [--submit NAME ...]
                                            the fleet arbiter's ledger
  chaos --scenario NAME | --all | --list     the chaos catalog (JAX's 15 scenarios)
  gauntlet [--seed N] [--sweep N]           composed multi-fault incidents
  lint [--concurrency --protocol --sharding --comms --determinism]
       [--baseline [PATH]] [--select RULES]  dlcfn-lint over the port's tree

The local backend executes everything in-process (the fake cloud) and
``run`` trains the template's job in this process, on the card unless the
template's job args say ``device: cpu``; the gcp backend renders the TPU API
calls (``--print-requests``).  ``--broker HOST:PORT|auto`` on create/run/
recover is the production topology: bootstrap agents
(``python -m deeplearning_cfn_tpu_torch.cluster.agent_main``) run on the
VMs and rendezvous through the native broker, which ``auto`` builds and
starts as part of the stack and ``delete`` tears down.  Templates name the
JAX package's job modules; ``cluster/launcher.resolve_job_module`` maps them
onto the port's.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time
from pathlib import Path

# --- the operator commands: template -> cluster -> job -------------------------


def _parse_params(pairs: list[str]) -> dict[str, str]:
    out = {}
    for pair in pairs or []:
        if "=" not in pair:
            raise SystemExit(f"-P expects key=value, got {pair!r}")
        k, v = pair.split("=", 1)
        out[k] = v
    return out


def _load_spec(args):
    from deeplearning_cfn_tpu_torch.config.schema import ConfigError
    from deeplearning_cfn_tpu_torch.config.template import render_template_file

    try:
        return render_template_file(args.template, _parse_params(args.param))
    except FileNotFoundError as e:
        raise SystemExit(f"template not found: {args.template}") from e
    except json.JSONDecodeError as e:
        raise SystemExit(f"template is not valid JSON: {e}") from e
    except ConfigError as e:
        raise SystemExit(f"template error: {e}") from e


def _parse_broker(broker: str) -> tuple[str, int]:
    host, _, port_str = broker.rpartition(":")
    try:
        port = int(port_str)
    except ValueError:
        port = -1
    if not host or not (0 < port < 65536):
        raise SystemExit(f"--broker expects HOST:PORT or 'auto', got {broker!r}")
    return host, port


def _resolve_broker(spec, args) -> str | None:
    """Resolve --broker, provisioning the broker itself for ``auto`` — the
    control plane is a stack resource (deeplearning.template:743-754), not
    an operator-managed prerequisite.  Returns HOST:PORT or None."""
    broker = getattr(args, "broker", None)
    if broker != "auto":
        return broker
    from deeplearning_cfn_tpu_torch.cluster.broker_client import BrokerError
    from deeplearning_cfn_tpu_torch.cluster.broker_service import (
        broker_token,
        detect_host_ip,
        ensure_broker,
    )

    advertise = getattr(args, "broker_advertise", None)
    if advertise is None:
        # Loopback for the in-process dev backend; a routable address for
        # real clusters (the VMs must dial back to this host).
        advertise = "127.0.0.1" if spec.backend == "local" else detect_host_ip()
    try:
        host, port, started = ensure_broker(spec.name, advertise=advertise)
    except (BrokerError, OSError) as e:
        # OSError: e.g. no write access to $DLCFN_ROOT for the record.
        raise SystemExit(f"broker provisioning failed: {e}") from e
    # Publish the broker's AUTH token ambiently: every BrokerConnection
    # this process opens (rendezvous backend, status) authenticates via
    # $DLCFN_BROKER_TOKEN, and _backend_for stamps it into VM metadata.
    # Operator-managed brokers (--broker HOST:PORT) export it themselves.
    token = broker_token(spec.name)
    if token:
        os.environ["DLCFN_BROKER_TOKEN"] = token
    print(
        f"broker for {spec.name!r}: {host}:{port} "
        f"({'started' if started else 'reused'})",
        file=sys.stderr,
    )
    return f"{host}:{port}"


class _DryRun:
    """--print-requests state for one lifecycle command: a recording
    transport over fake responses, a throwaway contract root, and the
    transcript emission — one implementation shared by all four commands
    so their dry-run behavior cannot drift."""

    def __init__(self, spec, broker: str | None):
        import tempfile

        if spec.backend != "gcp":
            raise SystemExit(
                "--print-requests is only meaningful for backend 'gcp'"
            )
        if broker:
            raise SystemExit(
                "--print-requests dry-runs inline (no VMs, no broker); "
                "drop --broker"
            )
        from deeplearning_cfn_tpu_torch.provision.gcp import (
            FakeGCPTransport,
            RecordingTransport,
        )

        self.recorder = RecordingTransport(
            FakeGCPTransport(workers=spec.pool.num_workers, provision_polls=1),
            project=spec.project or "example-project",
        )
        self._tmp = tempfile.TemporaryDirectory(prefix="dlcfn-dryrun-")
        self.contract_root = Path(self._tmp.name)

    def seed(self, backend, spec):
        """Provision into the fake first (requests discarded) so describe/
        delete transcripts show the wire protocol against an EXISTING
        cluster — what those ops actually do in production — and return
        the seeded provisioner."""
        from deeplearning_cfn_tpu_torch.provision.provisioner import Provisioner

        prov = Provisioner(backend, spec, contract_root=self.contract_root)
        prov.provision()
        self.recorder.requests.clear()
        return prov

    def emit(self, op: str) -> int:
        print(
            json.dumps({"op": op, "requests": self.recorder.requests}, indent=2)
        )
        self._tmp.cleanup()
        return 0


def _maybe_dryrun(args, spec) -> "_DryRun | None":
    if not getattr(args, "print_requests", False):
        return None
    return _DryRun(spec, getattr(args, "broker", None))


def _backend_for(spec, broker: str | None = None, recorder=None):
    broker_addr = _parse_broker(broker) if broker else None
    if spec.backend == "local":
        from deeplearning_cfn_tpu_torch.provision.local import LocalBackend

        backend = LocalBackend()
    else:
        from deeplearning_cfn_tpu_torch.cluster.startup import render_startup_script
        from deeplearning_cfn_tpu_torch.provision.gcp import GCPBackend

        extra = {}
        if recorder is not None:
            from deeplearning_cfn_tpu_torch.utils.timeouts import FakeClock

            # Dry-run: recorded fake transport + an instant clock (the
            # 30 s-style poll sleeps would otherwise run on wallclock).
            extra = {"transport": recorder, "clock": FakeClock()}
        backend = GCPBackend(
            project=spec.project,
            zone=spec.zone,
            accelerator_type=spec.pool.accelerator_type,
            runtime_version=spec.pool.image_override or spec.pool.runtime_version,
            network=spec.network.network,
            subnetwork=spec.network.subnetwork,
            external_ips=spec.network.external_ips,
            disk_size_gb=spec.pool.disk_size_gb,
            disk_type=spec.pool.disk_type,
            spot=spec.pool.spot,
            startup_script=render_startup_script(spec),
            # Stamped into VM metadata (dlcfn-broker) so the startup
            # script can hand agents their control plane; the AUTH token
            # rides the same channel (dlcfn-broker-token), the metadata
            # analog of the reference's IAM-scoped credentials.
            broker_host=broker_addr[0] if broker_addr else None,
            broker_port=broker_addr[1] if broker_addr else 8477,
            broker_token=os.environ.get("DLCFN_BROKER_TOKEN") or None,
            storage_namespace=spec.name,
            **extra,
        )
    if broker_addr:
        # Production topology: agents run on the VMs and rendezvous through
        # the broker; this process is the CloudFormation-engine side.
        from deeplearning_cfn_tpu_torch.cluster.broker_backend import (
            BrokerRendezvousBackend,
        )

        try:
            backend = BrokerRendezvousBackend(backend, *broker_addr)
        except OSError as e:
            raise SystemExit(f"cannot reach broker at {broker}: {e}") from e
    return backend


def _progress_printer(elapsed_s: float, status: str) -> None:
    # The stack drivers' poll loop printing elapsed time every 30 s
    # (mask-rcnn-stack.sh:84-92).
    print(f"  CREATE_IN_PROGRESS {elapsed_s:.0f}s elapsed: {status}", file=sys.stderr)


def cmd_validate(args) -> int:
    spec = _load_spec(args)
    print(json.dumps(spec.to_dict(), indent=2, default=str))
    slices = (
        f"{spec.pool.slices} slices x " if spec.pool.slices > 1 else ""
    )
    print(
        f"OK: {slices}{spec.pool.num_workers} workers x "
        f"{spec.pool.chips_per_worker} chips ({spec.pool.accelerator_type}, "
        f"{spec.pool.total_chips} chips total) on backend {spec.backend}",
        file=sys.stderr,
    )
    return 0


def cmd_create(args) -> int:
    from deeplearning_cfn_tpu_torch.provision.provisioner import ProvisionFailure, Provisioner

    spec = _load_spec(args)
    dry = _maybe_dryrun(args, spec)
    broker = None if dry else _resolve_broker(spec, args)
    backend = _backend_for(spec, broker, recorder=dry.recorder if dry else None)
    prov = Provisioner(
        backend,
        spec,
        remote_agents=bool(broker),
        progress=_progress_printer,
        # Dry runs must not touch the real contract dir.
        contract_root=dry.contract_root if dry else None,
    )
    t0 = time.monotonic()
    print(f"creating cluster {spec.name!r}...", file=sys.stderr)
    try:
        # Inline (local) backends provision synchronously; with --broker the
        # provisioner polls, calling _progress_printer each tick.
        result = prov.provision()
    except ProvisionFailure as e:
        print(f"CREATE FAILED after {time.monotonic() - t0:.0f}s: {e}", file=sys.stderr)
        return 1
    if dry is not None:
        return dry.emit("create")
    elapsed = time.monotonic() - t0
    print(
        json.dumps(
            {
                "cluster": spec.name,
                "elapsed_s": round(elapsed, 1),
                "workers": result.realized_workers,
                "chips": result.contract.total_chips,
                "degraded": result.degraded,
                "storage": result.storage.storage_id,
                "contract_root": str(result.contract.root_dir()),
            },
            indent=2,
        )
    )
    return 0


def cmd_describe(args) -> int:
    from deeplearning_cfn_tpu_torch.provision.provisioner import Provisioner

    spec = _load_spec(args)
    dry = _maybe_dryrun(args, spec)
    backend = _backend_for(spec, recorder=dry.recorder if dry else None)
    if dry is not None:
        # Seed a cluster into the fake, then describe from a FRESH
        # provisioner — the post-crash/fresh-process path (group-record
        # adoption + TPU API reads), the sequence a real describe issues.
        dry.seed(backend, spec)
    prov = Provisioner(backend, spec)
    try:
        desc = prov.describe()
    except KeyError:
        print(f"cluster {spec.name!r} not found on this backend", file=sys.stderr)
        return 1
    if dry is not None:
        return dry.emit("describe")
    print(json.dumps(desc, indent=2))
    return 0


def cmd_delete(args) -> int:
    from deeplearning_cfn_tpu_torch.cluster.broker_service import teardown_broker
    from deeplearning_cfn_tpu_torch.provision.provisioner import Provisioner

    spec = _load_spec(args)
    dry = _maybe_dryrun(args, spec)
    backend = _backend_for(spec, recorder=dry.recorder if dry else None)
    if dry is not None:
        # Seeded provisioner: delete of an EXISTING cluster, including the
        # storage retain/delete decision — the real production sequence.
        prov = dry.seed(backend, spec)
        prov.delete(force_storage=args.force_storage)
        return dry.emit("delete")
    prov = Provisioner(backend, spec)
    # The broker is a stack resource: delete tears it down with the
    # cluster (a no-op when none was auto-provisioned).  finally: broker
    # teardown is independent of cloud-resource deletion — a transport
    # error mid-teardown must not leave the detached broker running with
    # no cleanup path besides re-running delete.
    try:
        out = prov.delete(force_storage=args.force_storage)
    finally:
        broker_out = teardown_broker(spec.name)
    out.update(broker_out)
    print(json.dumps(out, indent=2))
    return 0


def cmd_recover(args) -> int:
    """Automates the reference's manual recovery runbook (delete stack,
    recreate reusing the retained file system, resume from checkpoint —
    examples/distributed-tensorflow/README.md:85-87)."""
    from deeplearning_cfn_tpu_torch.provision.provisioner import ProvisionFailure, Provisioner

    spec = _load_spec(args)
    dry = _maybe_dryrun(args, spec)
    broker = None if dry else _resolve_broker(spec, args)
    backend = _backend_for(spec, broker, recorder=dry.recorder if dry else None)
    prov = Provisioner(
        backend,
        spec,
        remote_agents=bool(broker),
        progress=_progress_printer,
        contract_root=dry.contract_root if dry else None,
    )
    t0 = time.monotonic()
    print(f"recovering cluster {spec.name!r}...", file=sys.stderr)
    try:
        result = prov.recover()
    except ProvisionFailure as e:
        print(f"RECOVER FAILED after {time.monotonic() - t0:.0f}s: {e}", file=sys.stderr)
        return 1
    if dry is not None:
        return dry.emit("recover")
    print(
        json.dumps(
            {
                "cluster": spec.name,
                "elapsed_s": round(time.monotonic() - t0, 1),
                "workers": result.realized_workers,
                "storage": result.storage.storage_id,
                "storage_reused": not result.storage.created,
                "degraded": result.degraded,
                "resume_hint": (
                    "checkpoints on the reused storage restore automatically "
                    "via Checkpointer.restore_latest"
                    if not result.storage.created
                    else "no retained storage found; training restarts fresh"
                ),
            },
            indent=2,
        )
    )
    return 0


def cmd_plan(args) -> int:
    from deeplearning_cfn_tpu_torch.cluster.launcher import build_launch_plan

    spec = _load_spec(args)
    # Render against a hypothetical full-size contract (no cloud calls).
    plan = build_launch_plan(_hypothetical_contract(spec), spec.job)
    print(f"# job {plan.job_name}: NUM_PARALLEL={plan.num_parallel} "
          f"steps/epoch={plan.steps_per_epoch}")
    for w in plan.workers:
        print(f"# --- worker {w.process_id} ({w.host}) ---")
        print(plan.render_script(w.process_id))
    return 0


def _hypothetical_contract(spec):
    """A full-size placeholder contract (10.0.0.x IPs) for rendering
    plans/scripts without a live cluster."""
    from deeplearning_cfn_tpu_torch.cluster.contract import ClusterContract
    from deeplearning_cfn_tpu_torch.provision.provisioner import worker_group_names

    ips = [f"10.0.0.{i + 2}" for i in range(spec.pool.total_workers)]
    per_slice = spec.pool.num_workers
    groups = worker_group_names(spec.name, spec.pool.slices)
    return ClusterContract.build(
        cluster_name=spec.name,
        coordinator_ip=ips[0],
        other_worker_ips=ips[1:],
        chips_per_worker=spec.pool.chips_per_worker,
        storage_mount=spec.storage.mount_point,
        # Placeholder slice topology so a multi-slice plan renders the
        # same DEEPLEARNING_SLICES_COUNT (and thus mesh) the live
        # contract will.
        slices=(
            {
                g: ips[i * per_slice : (i + 1) * per_slice]
                for i, g in enumerate(groups)
            }
            if spec.pool.slices > 1
            else None
        ),
    )


def cmd_gen_scripts(args) -> int:
    """Write one {host}.sh per worker to a shared dir — the
    generate_trainer.py analog (its gen_scripts wrote per-host scripts to
    EFS, generate_trainer.py:64-76); here each script carries the worker's
    env (DLCFN_PROCESS_ID etc.) and the single SPMD command."""
    from deeplearning_cfn_tpu_torch.cluster.contract import ClusterContract
    from deeplearning_cfn_tpu_torch.cluster.launcher import LaunchError, build_launch_plan

    spec = _load_spec(args)
    contract = None
    try:
        contract = ClusterContract.read()
    except FileNotFoundError:
        pass
    except (ValueError, TypeError, KeyError) as e:
        # Corrupt or version-skewed contract.json (interrupted write, older
        # schema): degrade to placeholders like the missing-file path.
        print(f"WARNING: unreadable cluster contract ({e})", file=sys.stderr)
    if contract is not None and contract.cluster_name != spec.name:
        print(
            f"WARNING: live contract is for cluster "
            f"{contract.cluster_name!r}, not {spec.name!r}; ignoring it",
            file=sys.stderr,
        )
        contract = None
    if contract is None:
        print(
            "WARNING: no usable cluster contract; scripts use "
            "placeholder 10.0.0.x addresses and are NOT deployable until "
            "regenerated on a provisioned cluster",
            file=sys.stderr,
        )
        contract = _hypothetical_contract(spec)
    try:
        plan = build_launch_plan(contract, spec.job)
    except LaunchError as e:
        print(f"GEN-SCRIPTS FAILED: {e}", file=sys.stderr)
        return 1
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    written = []
    for w in plan.workers:
        path = out_dir / f"{w.host}.sh"
        path.write_text(plan.render_script(w.process_id))
        path.chmod(0o755)
        written.append(str(path))
    print(json.dumps({"scripts": written, "num_parallel": plan.num_parallel}))
    return 0


def cmd_startup_script(args) -> int:
    from deeplearning_cfn_tpu_torch.cluster.startup import render_startup_script

    print(render_startup_script(_load_spec(args)), end="")
    return 0


def cmd_stage(args) -> int:
    """Stage dataset/code artifacts — the prepare-s3-bucket.sh analog."""
    from deeplearning_cfn_tpu_torch.provision.objectstore import LocalObjectStore, Stager

    spec = _load_spec(args)
    if not spec.staging.bucket:
        raise SystemExit("template has no staging.bucket configured")
    if spec.backend != "local":
        # Fail BEFORE tarring multi-GB artifacts: the CLI has no
        # authenticated GCS transport of its own; from a shell, gsutil is
        # the direct route.
        raise SystemExit(
            "staging to GCS from the CLI requires an authenticated "
            "transport; either use the library "
            "(Stager(GCSObjectStore(bucket, transport))) or upload with "
            f"`gsutil -m cp ... gs://{spec.staging.bucket}/{spec.staging.prefix}/`"
        )
    root = Path(os.environ.get("DLCFN_ROOT", "/opt/deeplearning"))
    stager = Stager(LocalObjectStore(root / "buckets" / spec.staging.bucket),
                    prefix=spec.staging.prefix)
    for path in args.data or []:
        stager.stage_path(path)
    for path in args.code or []:
        stager.stage_path(path)
    print(
        json.dumps(
            {
                "bucket": spec.staging.bucket,
                "prefix": spec.staging.prefix,
                "artifacts": [vars(a) for a in stager.manifest],
            },
            indent=2,
        )
    )
    return 0


def cmd_run(args) -> int:
    """Provision the template's cluster and run its job.  On the local
    backend the job's ``main`` runs in this process (``LocalJobRunner``),
    on the device its args name (the port's examples default to ``cuda``);
    ``--auto-recover N`` recreates the cluster on an instance loss, reusing
    the retained storage, and reruns the job, which resumes from its
    checkpoints, up to N times.  With ``--broker`` the bootstrap agents run
    as processes of their own (the VMs' ``agent_main``) and this process
    publishes group state and waits for their ready signal.  Other backends
    print the launch scripts."""
    from deeplearning_cfn_tpu_torch.cluster.launcher import (
        LaunchError,
        LocalJobRunner,
        build_launch_plan,
    )
    from deeplearning_cfn_tpu_torch.provision.provisioner import ProvisionFailure, Provisioner

    t0 = time.monotonic()
    spec = _load_spec(args)
    broker = _resolve_broker(spec, args)
    prov = Provisioner(
        _backend_for(spec, broker), spec, remote_agents=bool(broker), progress=_progress_printer
    )
    try:
        result = prov.provision()
        plan = build_launch_plan(result.contract, spec.job, result.job_violation)
    except (ProvisionFailure, LaunchError) as e:
        print(f"RUN FAILED: {e}", file=sys.stderr)
        return 1
    if spec.backend != "local":
        for w in plan.workers:
            print(f"# worker {w.process_id} launch script:")
            print(plan.render_script(w.process_id))
        return 0
    module = importlib.import_module(plan.module)
    job_args = []
    for k, v in sorted(spec.job.args.items()):
        job_args += [f"--{k}", str(v)]
    t_provisioned = time.monotonic()
    if args.auto_recover:
        # provision -> train -> (on instance loss: recover -> resume) as one
        # operator command; the job must checkpoint (checkpoint_dir in the
        # template's job args) for the resumed episode to continue rather
        # than restart.
        from deeplearning_cfn_tpu_torch.cluster.recovery import RecoveryManager

        manager = RecoveryManager(prov)
        manager.attach(result)
        recoveries = 0
        while True:
            out = LocalJobRunner(plan).run(module.main, job_args)
            if not manager.needs_recovery:
                break
            if recoveries >= args.auto_recover:
                # Same exhaustion semantics as run_with_recovery: an episode
                # that ended with losses still pending is NOT a success (its
                # metrics ran on a lost cluster).
                print(
                    f"RUN FAILED: instance loss after {recoveries} "
                    f"recoveries (pending: "
                    f"{[e.instance_id for e in manager.losses]})",
                    file=sys.stderr,
                )
                return 1
            recoveries += 1
            result = manager.recover()
            plan = build_launch_plan(result.contract, spec.job, result.job_violation)
        record = {"job": spec.job.name, "result": out, "recoveries": recoveries}
    else:
        out = LocalJobRunner(plan).run(module.main, job_args)
        record = {"job": spec.job.name, "result": out}
    # The end-to-end metric: template submission to the first completed
    # training step (the analog of the reference's 55-minute stack-creation
    # budget, README.md:80, measured not budgeted).
    if isinstance(out, dict) and out.get("first_step_s") is not None:
        record["template_to_first_step_s"] = round(
            (t_provisioned - t0) + float(out["first_step_s"]), 2
        )
    print(json.dumps(record, default=str))
    return 0


def cmd_serve(args) -> int:
    """Run the serving plane under deterministic synthetic traffic and print
    the load report.

    ``--replicas`` continuous-batching engines behind a least-loaded
    front-end, driven by seeded Poisson traffic on a virtual clock: the
    smoke of the whole plane (admission, paging, continuous batching,
    metrics) on a toy model, as ``dlcfn serve`` runs it.  ``--disaggregate``
    prefills on a device of its own where there are two CUDA devices or
    more.  With ``--broker HOST:PORT`` each replica registers in the
    broker's KV table (``serve/<group>/<name>``) and beats its liveness
    table every scheduler step, exactly like a training worker (the AUTH
    token from ``$DLCFN_BROKER_TOKEN``).  ``--journal`` (or
    ``$DLCFN_FLIGHT_JOURNAL``) records the ``serve_load`` and per-replica
    ``serve_metrics`` events."""
    import torch

    from deeplearning_cfn_tpu_torch.analysis.schedules import VirtualClock
    from deeplearning_cfn_tpu_torch.device import resolve_device
    from deeplearning_cfn_tpu_torch.models.llama import LlamaConfig, init_model
    from deeplearning_cfn_tpu_torch.serve import (
        ContinuousBatchingEngine,
        ServeConfig,
        ServeFrontEnd,
        ServeReplica,
        TrafficConfig,
        plan_placement,
        run_load,
    )

    if args.journal:
        os.environ["DLCFN_FLIGHT_JOURNAL"] = args.journal
    device = resolve_device(args.device)
    # The demo model: the flagship transformer at toy scale, as dlcfn serve's.
    cfg = LlamaConfig.tiny(vocab_size=64, seq_len=64, dtype=torch.float32)
    model = init_model(cfg, seed=0, device=device)
    scfg = ServeConfig(num_slots=args.slots, block_size=4, blocks_per_slot=8, prefill_len=16)
    placement = None
    if args.disaggregate:
        placement = plan_placement(None if device.type == "cuda" else [device])
    clock = VirtualClock()
    conn = None
    if args.serve_broker:
        from deeplearning_cfn_tpu_torch.cluster.broker_client import BrokerConnection

        host, _, port = args.serve_broker.partition(":")
        conn = BrokerConnection(host, int(port))
    replicas = []
    for i in range(args.replicas):
        replica = ServeReplica(
            ContinuousBatchingEngine(model, scfg, clock=clock, name=f"rep{i}",
                                     placement=placement),
            f"rep{i}",
            group=args.group,
            connection_factory=(lambda: conn) if conn is not None else None,
        )
        if conn is not None:
            replica.register(conn)
        replicas.append(replica)
    frontend = ServeFrontEnd(replicas)
    traffic = TrafficConfig(requests=args.requests, seed=args.seed)

    def beat_all(_step: int) -> None:
        for replica in frontend.replicas.values():
            replica.beat()

    report = run_load(frontend, traffic, clock,
                      on_step=beat_all if conn is not None else None, journal=True)
    for replica in frontend.replicas.values():
        replica.engine.journal_metrics()
    print(json.dumps(report.to_dict(), indent=2))
    return 0 if report.completed == traffic.requests else 1


def cmd_convert(args) -> int:
    """Convert a public dataset in its standard on-disk layout into DLC1
    record files (``train/datasets.py``) and print the converter's summary as
    JSON.  The output directory is what the examples' ``--data_dir`` reads.
    A source in the wrong format prints ``CONVERT FAILED`` and returns 1."""
    from deeplearning_cfn_tpu_torch.train import datasets

    try:
        if args.format == "text":
            out = datasets.convert_text(args.src, args.out, seq_len=args.seq_len,
                                        tokenizer_dir=args.tokenizer, split=args.split)
        elif args.format == "imagefolder":
            out = datasets.convert_imagefolder(args.src, args.out, size=args.size,
                                               split=args.split, margin=args.margin)
        elif args.format == "coco":
            if not args.annotations:
                raise SystemExit("--format coco requires --annotations")
            out = datasets.convert_coco(args.src, args.annotations, args.out, size=args.size,
                                        max_boxes=args.max_boxes, split=args.split,
                                        masks=args.masks_coco, mask_stride=args.mask_stride)
        else:
            out = datasets.CONVERTERS[args.format](args.src, args.out)
    except datasets.DatasetFormatError as e:
        print(f"CONVERT FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps(out, indent=2))
    return 0


def _status_liveness(args) -> dict | None:
    """Per-worker liveness from a broker, or None when none was asked for.

    ``--broker HOST:PORT`` dials directly (token from the ambient
    $DLCFN_BROKER_TOKEN); ``--cluster NAME`` resolves the recorded broker
    and its token from the contract root."""
    from deeplearning_cfn_tpu_torch.obs.liveness import LivenessConfig

    if not (args.cluster or args.status_broker):
        return None
    config = LivenessConfig(
        suspect_after_s=args.suspect_after, dead_after_s=args.dead_after
    )
    if args.status_broker:
        from deeplearning_cfn_tpu_torch.cluster.broker_client import (
            BrokerConnection,
            BrokerError,
        )
        from deeplearning_cfn_tpu_torch.obs.liveness import LivenessTable

        host, port = _parse_broker(args.status_broker)
        try:
            conn = BrokerConnection(host, port)
        except OSError as e:
            raise SystemExit(f"cannot reach broker at {host}:{port}: {e}") from e
        try:
            beats = conn.heartbeats()
        except BrokerError as e:
            raise SystemExit(f"heartbeat dump failed: {e}") from e
        finally:
            conn.close()
        table = LivenessTable(config=config)
        for worker, (age_s, count) in beats.items():
            table.observe(worker, age_s=age_s, count=count)
        table.sweep()
        return table.snapshot()
    from deeplearning_cfn_tpu_torch.cluster.broker_service import cluster_liveness

    return cluster_liveness(args.cluster, config=config)


def _status_broker_role(args) -> dict | None:
    """Control-plane role / epoch / replication lag, or None.

    ``--cluster`` reads the recorded replicated pair (primary plus warm
    standby, with lag in entries and seconds) — or, when a shard map is
    recorded (ensure_sharded_broker), the per-shard replication table
    with a degraded flag per pair.  ``--broker HOST:PORT`` asks the
    dialed node directly via the ROLE and SHARD verbs.  A cluster with
    no recorded broker, or a dial failure, yields None — status stays
    usable against legacy single-process brokers."""
    if args.cluster:
        from deeplearning_cfn_tpu_torch.cluster.broker_service import (
            broker_replication_status,
            broker_shard_replication_status,
            broker_status,
        )

        sharded = broker_shard_replication_status(args.cluster)
        if sharded is not None:
            return sharded
        if broker_status(args.cluster) is None:
            return None
        return broker_replication_status(args.cluster)
    if args.status_broker:
        from deeplearning_cfn_tpu_torch.cluster.broker_client import (
            BrokerConnection,
            BrokerError,
        )

        host, port = _parse_broker(args.status_broker)
        try:
            conn = BrokerConnection(host, port)
            try:
                role_name, epoch, seq = conn.role()
                shard, n_shards = conn.shard()
            finally:
                conn.close()
        except (OSError, BrokerError):
            return None
        primary = {
            "host": host,
            "port": port,
            "alive": True,
            "role": role_name,
            "epoch": epoch,
            "seq": seq,
        }
        if n_shards > 1:
            primary["shard"] = shard
            primary["n_shards"] = n_shards
        return {
            "primary": primary,
            "standby": None,
            "lag_entries": None,
            "lag_seconds": None,
        }
    return None


def _status_fleet(args, liveness) -> dict | None:
    """Fleet-merged agent telemetry from the broker's TELEM table, or
    None (``--fleet`` not passed / no broker source / dial failure).

    Snapshots are whatever each agent's Heartbeater piggybacked on its
    last beat; the merge (obs/aggregator.FleetAggregator) folds gauges
    as sum/max/last-per-worker and summaries as fleet-wide quantiles
    over the concatenated samples.  ``liveness`` (already computed for
    the status view) contributes the dead-fraction."""
    if not getattr(args, "fleet", False):
        return None
    from deeplearning_cfn_tpu_torch.cluster.broker_client import (
        BrokerConnection,
        BrokerError,
    )

    token = None  # --broker: the ambient $DLCFN_BROKER_TOKEN
    if args.status_broker:
        host, port = _parse_broker(args.status_broker)
    elif args.cluster:
        from deeplearning_cfn_tpu_torch.cluster.broker_service import broker_status

        record = broker_status(args.cluster)
        if record is None or not record.get("alive"):
            return None
        # Loopback, same rationale as the liveness probe: the recorded
        # host may be a NAT address not locally routable.  The record's
        # token, as the liveness view uses (deliberate difference: the JAX
        # command dials with the ambient token only, and without one reads
        # no fleet from an AUTH-required broker).
        host, port = "127.0.0.1", int(record["port"])
        token = record.get("token") or None
    else:
        raise SystemExit("dlcfn status --fleet needs --broker or --cluster")
    try:
        conn = BrokerConnection(host, port, token=token)
        try:
            table = conn.telemetry()
        finally:
            conn.close()
    except (OSError, BrokerError):
        return None
    from deeplearning_cfn_tpu_torch.obs.aggregator import FleetAggregator

    return FleetAggregator().merge(table, liveness=liveness)


def _status_spans(args) -> dict | None:
    """Span aggregates folded from a flight journal, or None; each span
    with p50/p95/p99 over the journal's most recent samples."""
    if not args.journal:
        return None
    from deeplearning_cfn_tpu_torch.obs.profiler import RollingQuantiles
    from deeplearning_cfn_tpu_torch.obs.recorder import read_journal
    from deeplearning_cfn_tpu_torch.obs.tracing import SpanStats

    stats: dict[str, SpanStats] = {}
    quantiles: dict[str, RollingQuantiles] = {}
    for event in read_journal(args.journal, kind="span"):
        name = event.get("span")
        seconds = event.get("seconds")
        if not isinstance(name, str) or not isinstance(seconds, (int, float)):
            continue
        agg = stats.setdefault(name, SpanStats())
        agg.fold(float(seconds), bool(event.get("ok", True)))
        quantiles.setdefault(name, RollingQuantiles()).add(float(seconds))
    out = {}
    for name, agg in sorted(stats.items()):
        row = agg.as_dict()
        for key, value in quantiles[name].quantiles().items():
            row[f"{key}_s"] = round(value, 6)
        out[name] = row
    return out


def _status_mesh(args) -> dict | None:
    """The current mesh shape straight from the published cluster
    contract (slices/workers/chips and the degraded flag) — after a live
    reshard the surviving topology shows up here."""
    if not args.cluster:
        return None
    from deeplearning_cfn_tpu_torch.cluster.contract import ClusterContract

    try:
        contract = ClusterContract.read()
    except (OSError, TypeError, ValueError, KeyError):
        return None
    if contract.cluster_name != args.cluster:
        return None
    return {
        "cluster": contract.cluster_name,
        "slices": contract.slices_count,
        "workers": contract.workers_count,
        "chips_total": contract.total_chips,
        "degraded": contract.degraded,
        "slice_groups": {
            g: len(ips) for g, ips in (contract.slices or {}).items()
        },
    }


def _journal_fold(args, fold, kind: str | None = None, flag: str | None = None,
                  by_name: bool = False) -> dict | None:
    """``fold`` over the flight journal's events (those of ``kind``), or
    None: no ``--journal``, the section's ``flag`` not passed, or nothing
    folded.  ``by_name`` sorts a per-name fold (pipelines, replicas,
    programs) by name, as ``status`` prints it."""
    if not args.journal or (flag is not None and not getattr(args, flag, False)):
        return None
    from deeplearning_cfn_tpu_torch.obs.recorder import read_journal

    folded = fold(read_journal(args.journal, kind=kind))
    return (dict(sorted(folded.items())) if by_name else folded) or None


def _status_profile(args) -> dict | None:
    """Step-profile snapshots and straggler table from the journal, or
    None (``--profile`` not passed / no journal / no profile events).

    ``step_profile`` events carry a StepProfiler snapshot (the latest
    per profiler name wins — it aggregates everything before it);
    ``step_time`` events from two or more hosts feed the slowest-host-
    per-step table (obs/trace_export.straggler_table)."""
    if not getattr(args, "profile", False) or not args.journal:
        return None
    from deeplearning_cfn_tpu_torch.obs.recorder import read_journal
    from deeplearning_cfn_tpu_torch.obs.trace_export import straggler_table

    profilers: dict[str, dict] = {}
    for event in read_journal(args.journal, kind="step_profile"):
        name = event.get("name")
        if isinstance(name, str):
            profilers[name] = {
                key: event[key]
                for key in (
                    "steps",
                    "data_wait_ms",
                    "h2d_ms",
                    "dispatch_ms",
                    "compute_ms",
                    "host_ms",
                    "step_ms",
                    "phases",
                )
                if key in event
            }
    step_events = list(read_journal(args.journal, kind="step_time"))
    hosts = {
        e.get("worker") or e.get("host")
        for e in step_events
        if e.get("worker") or e.get("host")
    }
    stragglers = straggler_table(step_events) if len(hosts) >= 2 else None
    out: dict = {}
    if profilers:
        out["profilers"] = dict(sorted(profilers.items()))
    if stragglers and stragglers["steps"]:
        out["stragglers"] = stragglers
    return out or None


def _status_metrics(base: str) -> list | None:
    """Latest per-worker train/eval records from the JSONL metrics stream
    (``train.metrics.JsonlMetricsSink`` files on the shared mount),
    machine-read instead of tailing per-rank logs."""
    import glob as _glob

    files = sorted(_glob.glob(str(Path(base) / "*" / "worker*.jsonl")))
    if not files:
        return None
    out = []
    for path in files:
        run = Path(path).parent.name
        last_step, last_eval = None, None
        with open(path) as fh:
            for line in fh:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn tail write on shared storage
                if rec.get("event") == "train_step":
                    last_step = rec
                elif rec.get("event") == "eval":
                    last_eval = rec
        entry = {"run": run, "worker": Path(path).stem}
        if last_step:
            entry.update(
                step=last_step.get("step"),
                loss=last_step.get("loss"),
                examples_per_sec=round(last_step.get("examples_per_sec", 0), 1),
            )
            if "mfu" in last_step:
                entry["mfu"] = round(last_step["mfu"], 4)
        if last_eval:
            entry["eval"] = {
                k: v
                for k, v in last_eval.items()
                if k not in ("ts", "process", "event", "run")
            }
        out.append(entry)
    return out


def cmd_status(args) -> int:
    """Cluster status from any of four sources (at least one required):
    per-worker training metrics (``--metrics-dir``), broker-driven liveness
    plus the control plane's role/epoch/replication lag (``--cluster`` /
    ``--broker``), fleet-merged agent telemetry (``--fleet``), and the
    folds of a flight journal (``--journal``: spans, the input pipeline,
    reshards, the broker's lifecycle, with ``--profile`` the step profiles
    and the straggler table, with ``--serve`` the replicas' snapshots, and
    the comms, replay, data-plane, gauntlet and scheduler sections).
    ``--format prom`` renders them as Prometheus text."""
    if not (args.metrics_dir or args.cluster or args.status_broker or args.journal):
        raise SystemExit(
            "status needs a source: --metrics-dir, --cluster, --broker, and/or --journal"
        )
    from deeplearning_cfn_tpu_torch.obs import exporter
    from deeplearning_cfn_tpu_torch.train.pipeline import fold_pipeline_events

    liveness = _status_liveness(args)
    broker = _status_broker_role(args)
    # The broker's promotions and self-heals, beside its live replication.
    broker_events = _journal_fold(args, exporter.fold_broker_events)
    if broker_events is not None:
        broker = {**(broker or {}), "events": broker_events}
    spans = _status_spans(args)
    pipeline = _journal_fold(args, fold_pipeline_events, "input_pipeline", by_name=True)
    reshard = _journal_fold(args, exporter.fold_reshard_events)
    mesh = _status_mesh(args)
    profile = _status_profile(args)
    serve = _journal_fold(args, exporter.fold_serve_events, "serve_metrics", "serve",
                          by_name=True)
    comms = _journal_fold(args, exporter.fold_comms_events, "comms_audit", by_name=True)
    replay = _journal_fold(args, exporter.fold_replay_events, "replay_audit")
    datastream = _journal_fold(args, exporter.fold_datastream_events, "datastream")
    gauntlet = _journal_fold(args, exporter.fold_gauntlet_events, "gauntlet")
    # The arbiter's counters: JAX's status leaves this fold to callers of
    # render_prometheus(sched=).
    sched = _journal_fold(args, exporter.fold_sched_events)
    fleet = _status_fleet(args, liveness)
    workers = _status_metrics(args.metrics_dir) if args.metrics_dir else None
    if args.metrics_dir and workers is None:
        print(f"no metrics under {args.metrics_dir}", file=sys.stderr)
        return 1
    if args.format == "prom":
        print(
            exporter.render_prometheus(
                liveness,
                spans,
                cluster=args.cluster or "",
                pipeline=pipeline,
                reshard=reshard,
                mesh=mesh,
                profile=profile,
                serve=serve,
                broker=broker,
                comms=comms,
                fleet=fleet,
                datastream=datastream,
                sched=sched,
                replay=replay,
                gauntlet=gauntlet,
            ),
            end="",
        )
        return 0
    sections = {
        "liveness": liveness,
        "broker": broker,
        "mesh": mesh,
        "reshard": reshard,
        "spans": spans,
        "input_pipeline": pipeline,
        "profile": profile,
        "serve": serve,
        "comms": comms,
        "replay": replay,
        "datastream": datastream,
        "gauntlet": gauntlet,
        "fleet": fleet,
        "sched": sched,
    }
    if all(v is None for v in sections.values()):
        # Metrics only: the bare list of workers, as JAX's status prints it.
        print(json.dumps(workers, indent=2))
        return 0
    out = {k: v for k, v in sections.items() if v is not None}
    if workers is not None:
        out["workers"] = workers
    print(json.dumps(out, indent=2))
    return 0


def cmd_events(args) -> int:
    """Tail the flight journal: the last N structured events, as JSONL.
    ``--follow`` prints everything already journaled (``-n`` is ignored),
    then polls for appends across the recorder's ``<path>.1`` rotation —
    ``tail -F`` for the journal; Ctrl-C exits cleanly."""
    from deeplearning_cfn_tpu_torch.obs.recorder import ENV_JOURNAL, follow_journal, read_journal

    path = args.journal or os.environ.get(ENV_JOURNAL)
    if not path:
        raise SystemExit(
            f"events needs --journal (or ${ENV_JOURNAL}) pointing at a flight journal"
        )
    if args.follow:
        try:
            for event in follow_journal(path, kind=args.kind, poll_s=args.poll):
                print(json.dumps(event, allow_nan=False, default=str), flush=True)
        except KeyboardInterrupt:
            pass
        return 0
    if not Path(path).exists() and not Path(path + ".1").exists():
        print(f"no journal at {path}", file=sys.stderr)
        return 1
    count = 0
    for event in read_journal(path, limit=args.last, kind=args.kind):
        print(json.dumps(event, allow_nan=False, default=str))
        count += 1
    if count == 0:
        print("journal is empty (no matching events)", file=sys.stderr)
    return 0


def cmd_trace(args) -> int:
    """Merge per-host flight journals into one Chrome/Perfetto timeline.

    Clock alignment (on by default) recovers per-host offsets from the
    heartbeat_sent / heartbeat_observed pairs both sides already journal
    (obs/trace_export.py); the offsets and the straggler table go to
    stderr, the trace JSON to ``--out`` (or stdout).  Load the JSON in
    chrome://tracing or https://ui.perfetto.dev."""
    from deeplearning_cfn_tpu_torch.obs.trace_export import (
        chrome_trace,
        merge_journals,
        straggler_table,
    )

    paths = [p for p in args.journal or []]
    if not paths:
        raise SystemExit(
            "trace needs --journal PATH (repeat once per host)"
        )
    missing = [
        p for p in paths
        if not Path(p).exists() and not Path(p + ".1").exists()
    ]
    if missing:
        print(f"no journal at {', '.join(missing)}", file=sys.stderr)
        return 1
    events, meta = merge_journals(paths, align=not args.no_align)
    trace = chrome_trace(events)
    payload = json.dumps(trace, allow_nan=False, default=str)
    if args.out:
        Path(args.out).write_text(payload + "\n", encoding="utf-8")
        print(
            f"wrote {len(trace['traceEvents'])} trace events to {args.out}",
            file=sys.stderr,
        )
    else:
        print(payload)
    summary: dict = {"clock": meta}
    stragglers = straggler_table(events)
    if stragglers["steps"]:
        summary["stragglers"] = stragglers
    print(json.dumps(summary, indent=2, default=str), file=sys.stderr)
    return 0


def cmd_postmortem(args) -> int:
    """Merge per-host blackbox bundles into one causal timeline.

    Bundles are what obs/blackbox.py captured at each host's death
    (journal tail, profiler state, config, budgets); clocks are aligned
    with the heartbeat pairs inside the bundles' journals, ties break
    deterministically by (host, seq), and SLO alert transitions are
    overlaid so "what fired" reads next to "what happened"."""
    from deeplearning_cfn_tpu_torch.obs.blackbox import (
        merge_bundles,
        read_bundle,
        render_timeline,
    )

    paths: list[Path] = []
    for raw in args.bundle or []:
        p = Path(raw)
        if p.is_dir():
            paths.extend(sorted(p.glob("blackbox-*.json")))
        else:
            paths.append(p)
    if not paths:
        raise SystemExit(
            "postmortem needs bundle files or a directory of "
            "blackbox-*.json captures"
        )
    missing = [str(p) for p in paths if not p.exists()]
    if missing:
        print(f"no bundle at {', '.join(missing)}", file=sys.stderr)
        return 1
    bundles = []
    for p in paths:
        try:
            bundles.append(read_bundle(p))
        except (ValueError, OSError) as e:
            print(f"skipping unreadable bundle {p}: {e}", file=sys.stderr)
    if not bundles:
        return 1
    merged = merge_bundles(bundles)
    if args.format == "json":
        print(json.dumps(merged, indent=2, default=str))
    else:
        print(render_timeline(merged, last_n=args.last or None), end="")
    return 0


class _FileLedger:
    """File-backed stand-in for the broker KV (``set``/``get`` duck type)
    so ``sched`` works against a plain JSON file — the production
    path stores the same ledger through a BrokerConnection."""

    def __init__(self, path: Path):
        self.path = path

    def get(self, key: str) -> str | None:
        if not self.path.exists():
            return None
        table = json.loads(self.path.read_text() or "{}")
        return table.get(key)

    def set(self, key: str, value: str) -> None:
        table = {}
        if self.path.exists():
            table = json.loads(self.path.read_text() or "{}")
        table[key] = value
        self.path.write_text(json.dumps(table, sort_keys=True))


def cmd_sched(args) -> int:
    """Inspect or build the fleet arbiter's ledger (``sched/``).  ``--init``
    seeds a fresh ledger from a slice inventory; ``--submit`` admits a job
    and places it; with neither, prints the resumed arbiter's status."""
    from deeplearning_cfn_tpu_torch.sched import FleetArbiter, JobSpec, SchedError

    store = _FileLedger(args.ledger)
    try:
        if args.init:
            inventory = {}
            for part in args.init.split(","):
                name, _, chips = part.partition("=")
                if not name or not chips:
                    print(f"dlcfn sched: bad --init entry {part!r} "
                          "(want slice=chips, e.g. s0=4)")
                    return 2
                inventory[name.strip()] = int(chips)
            arbiter = FleetArbiter(inventory, store=store)
            arbiter.persist()
        else:
            arbiter = FleetArbiter.resume(store)
        if args.submit:
            arbiter.submit(
                JobSpec(
                    name=args.submit,
                    kind=args.kind,
                    priority=args.priority,
                    min_slices=args.min_slices,
                    max_slices=args.max_slices,
                )
            )
    except SchedError as exc:
        print(f"dlcfn sched: {exc}")
        return 2
    print(json.dumps(arbiter.status(), indent=2, sort_keys=True))
    return 0


def cmd_chaos(args) -> int:
    """Run named fault-injection scenarios (``chaos/scenarios.py``): each
    drives real components through seeded faults and checks its recovery
    invariants; the report is deterministic per (scenario, seed).  One
    scenario prints one report dict, ``--all`` a list.  Exit 1 if any
    invariant was violated, 2 on a bad name."""
    from deeplearning_cfn_tpu_torch.chaos import SCENARIO_FAULTS, SCENARIOS, run_scenario

    if args.list_scenarios:
        width = max(len(name) for name in SCENARIOS)
        for name in sorted(SCENARIOS):
            doc = (SCENARIOS[name].__doc__ or "").strip().split("\n")[0]
            faults = ", ".join(SCENARIO_FAULTS.get(name, ())) or "-"
            print(f"{name:<{width}}  {doc}")
            print(f"{'':<{width}}  faults: {faults}")
        return 0
    names = sorted(SCENARIOS) if args.all else [args.scenario]
    if names == [None]:
        print("chaos: pass --scenario NAME, --all, or --list")
        return 2
    unknown = [n for n in names if n not in SCENARIOS]
    if unknown:
        print(f"chaos: unknown scenario(s) {unknown}; available: {sorted(SCENARIOS)}")
        return 2
    reports = [run_scenario(name, args.seed, args.device) for name in names]
    payload = [r.to_dict() for r in reports]
    print(json.dumps(payload[0] if len(payload) == 1 else payload, indent=2))
    return 0 if all(r.passed for r in reports) else 1


_BASELINE_DEFAULT_SENTINEL = "<default-baseline>"


def cmd_lint(args) -> int:
    """dlcfn-lint over the port (``analysis/``, README "Static analysis").

    Runs the DLC0xx per-file AST rules over the port's package and
    ``chip_smoke.py`` and the
    DLC1xx cross-language broker-contract checker; ``--concurrency`` adds
    the DLC2xx lockset rules, ``--protocol`` the DLC3xx message-shape
    checkers, ``--sharding`` the DLC4xx CUDA-graph capture-safety rules,
    ``--comms`` the DLC5xx DTensor/FSDP2 communication rules, ``--determinism``
    the DLC6xx nondeterminism rules.
    Exit 1 on findings not covered by ``--baseline`` (no value: the port's
    ``analysis/lint_baseline.json``), 2 on an unreadable baseline."""
    from deeplearning_cfn_tpu_torch.analysis.runner import (
        DEFAULT_BASELINE,
        DYNAMIC_AUDIT_RULE_IDS,
        apply_baseline,
        load_baseline,
        render_json,
        render_text,
        run_lint,
        write_baseline,
    )

    select = None
    if args.select:
        select = {r.strip() for s in args.select for r in s.split(",") if r.strip()}
    violations = run_lint(
        targets=args.paths or None,
        select=select,
        concurrency=args.concurrency,
        protocol_pass=args.protocol,
        sharding=args.sharding,
        comms=args.comms,
        determinism=args.determinism,
    )

    baseline_path = args.baseline
    if baseline_path is _BASELINE_DEFAULT_SENTINEL:
        baseline_path = DEFAULT_BASELINE
    if args.write_baseline:
        path = Path(baseline_path) if baseline_path else DEFAULT_BASELINE
        write_baseline(violations, path)
        print(f"dlcfn-lint: wrote {len(violations)} entr(ies) to {path}")
        return 0

    stale: list = []
    if baseline_path:
        try:
            baseline = load_baseline(baseline_path)
        except (OSError, ValueError, KeyError, TypeError) as exc:
            print(f"dlcfn-lint: unreadable baseline {baseline_path}: {exc}")
            return 2
        violations, stale = apply_baseline(violations, baseline)
        # Dynamic-sentinel entries (DLC41x/DLC51x) are ratcheted by
        # their own stages; the static pass can't see those findings,
        # so reporting them stale here would be a standing false nag.
        stale = [e for e in stale if e[0] not in DYNAMIC_AUDIT_RULE_IDS]
    if args.format == "json":
        print(render_json(violations))
    else:
        print(render_text(violations))
    for rule, rel, message in stale:
        # Stale entries don't fail the build, but they do nag: the
        # baseline is a ratchet and should only ever shrink.
        print(f"dlcfn-lint: stale baseline entry: {rule} {rel}: {message}")
    return 1 if violations else 0


def cmd_gauntlet(args) -> int:
    """Composed multi-fault incidents over the real end-to-end stack
    (``chaos/gauntlet.py``), the trainer's ranks on ``--device``.

    Default runs the pinned 3-fault schedule for --seed and prints the
    report; ``--sweep N`` runs the seeded incident explorer over N
    perturbed schedules, shrinking any failure to a minimal reproducer.
    Exit 1 on any invariant violation / failing schedule, 2 on a sweep of
    fewer than one seed.  A sweep's last line on stderr is the kernel
    launches its runs' ranks made, summed (``{"kernel_launches": {...}}``);
    stdout holds the summary alone."""
    from deeplearning_cfn_tpu_torch.chaos import pinned_schedule, run_gauntlet, run_gauntlet_sweep

    if args.sweep is not None:
        if args.sweep < 1:
            print("gauntlet: --sweep needs at least 1 seed")
            return 2
        launches: dict[str, int] = {}

        def runner(schedule):
            report = run_gauntlet(schedule, args.device)
            for k, n in report.observed.get("kernel_launches", {}).items():
                launches[k] = launches.get(k, 0) + n
            return report

        summary = run_gauntlet_sweep(n_seeds=args.sweep, base_seed=args.seed, runner=runner)
        print(json.dumps(summary, indent=2))
        print(json.dumps({"kernel_launches": launches}), file=sys.stderr)
        return 0 if not summary["failures"] else 1
    report = run_gauntlet(pinned_schedule(args.seed), args.device)
    print(json.dumps(report.to_dict(), indent=2))
    return 0 if report.passed else 1


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m deeplearning_cfn_tpu_torch.cli",
        description="the PyTorch/CUDA port of deeplearning_cfn_tpu",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    for name, fn in [
        ("validate", cmd_validate),
        ("create", cmd_create),
        ("describe", cmd_describe),
        ("delete", cmd_delete),
        ("recover", cmd_recover),
        ("plan", cmd_plan),
        ("run", cmd_run),
        ("startup-script", cmd_startup_script),
        ("stage", cmd_stage),
        ("gen-scripts", cmd_gen_scripts),
    ]:
        p = sub.add_parser(name)
        p.add_argument("template", type=Path)
        p.add_argument("-P", "--param", action="append", default=[],
                       help="template parameter override key=value (repeatable)")
        if name in ("create", "run", "recover"):
            p.add_argument("--broker", default=None, metavar="HOST:PORT|auto",
                           help="rendezvous broker address; bootstrap agents run on the VMs "
                                "(production topology) instead of inline.  'auto' provisions "
                                "the broker as part of the stack (detached on this host, torn "
                                "down by delete)")
            p.add_argument("--broker-advertise", default=None, dest="broker_advertise",
                           metavar="HOST",
                           help="with --broker auto: the address VMs dial (default: loopback "
                                "for the local backend, this host's routable IP otherwise)")
        if name == "run":
            p.add_argument("--auto-recover", type=int, default=0, dest="auto_recover",
                           metavar="N",
                           help="on instance loss, recreate the cluster (reusing retained "
                                "storage) and rerun the job, up to N times; the job resumes "
                                "from its checkpoints")
        if name in ("create", "describe", "delete", "recover"):
            p.add_argument("--print-requests", action="store_true", dest="print_requests",
                           help="dry-run (gcp backend): drive the full flow against recorded "
                                "fake responses and print the exact ordered HTTP requests the "
                                "real Google APIs would receive")
        if name == "delete":
            p.add_argument("--force-storage", action="store_true")
        if name == "stage":
            p.add_argument("--data", action="append", default=[],
                           help="dataset file/dir to tar+upload (repeatable)")
            p.add_argument("--code", action="append", default=[],
                           help="code file/dir to tar+upload (repeatable)")
        if name == "gen-scripts":
            p.add_argument("--out", default=".",
                           help="shared dir to write {host}.sh scripts into")
        p.set_defaults(fn=fn)
    pv = sub.add_parser(
        "serve", help="continuous-batching inference replicas under synthetic traffic"
    )
    pv.add_argument("--requests", type=int, default=200, help="synthetic requests to serve")
    pv.add_argument("--seed", type=int, default=0,
                    help="traffic seed; the run is deterministic per seed")
    pv.add_argument("--replicas", type=int, default=1, help="engines behind the front-end")
    pv.add_argument("--slots", type=int, default=4, help="decode slots per replica")
    pv.add_argument("--group", default="serve",
                    help="worker-group name for registration/liveness")
    pv.add_argument("--broker", default=None, dest="serve_broker", metavar="HOST:PORT",
                    help="register replicas and beat liveness at this broker")
    pv.add_argument("--disaggregate", action="store_true",
                    help="prefill on a dedicated device when >= 2 devices")
    pv.add_argument("--journal", default=None,
                    help="flight journal path for serve_metrics events")
    pv.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu, which runs only when asked for")
    pv.set_defaults(fn=cmd_serve)
    pc = sub.add_parser("convert", help="dataset -> DLC1 records")
    pc.add_argument("--format", required=True,
                    choices=["cifar10", "mnist", "imagefolder", "coco", "text"])
    pc.add_argument("--src", required=True, help="dataset source dir")
    pc.add_argument("--out", required=True, help="output dir for .dlc files")
    pc.add_argument("--size", type=int, default=224,
                    help="image size for imagefolder/coco records")
    pc.add_argument("--margin", type=int, default=0,
                    help="imagefolder: extra pixels stored per side so training can "
                         "random-crop --size windows (train splits e.g. --margin 32; eval 0)")
    pc.add_argument("--split", default="train",
                    help="output split name for imagefolder/coco/text")
    pc.add_argument("--annotations", default=None, help="COCO instances_*.json path")
    pc.add_argument("--max-boxes", type=int, default=50, dest="max_boxes")
    pc.add_argument("--mask-stride", type=int, default=8, dest="mask_stride",
                    help="instance-mask raster stride for --format coco --masks: 8 (the "
                         "prototype training resolution) for train splits, 1 or 2 for val "
                         "splits scored at image resolution")
    pc.add_argument("--masks", action="store_true", dest="masks_coco",
                    help="coco: also rasterize instance-mask bitmaps into the records (for "
                         "detection_train --masks)")
    pc.add_argument("--seq-len", type=int, default=2048, dest="seq_len",
                    help="token window length for --format text")
    pc.add_argument("--tokenizer", default=None,
                    help="local HF tokenizer dir for --format text (default: byte-level)")
    pc.set_defaults(fn=cmd_convert)
    ps = sub.add_parser("status", help="worker metrics, liveness, the broker, the mesh and "
                                       "the flight journal's folds")
    ps.add_argument("--cluster", default=None,
                    help="cluster name: per-worker liveness from its recorded broker's "
                         "HEARTBEAT table, the replicated pair's role/epoch/replication lag, "
                         "and the mesh from its published contract ($DLCFN_ROOT)")
    ps.add_argument("--journal", default=None,
                    help="flight journal (JSONL) to fold spans, reshards, profiles and "
                         "serving snapshots from")
    ps.add_argument("--format", choices=["json", "prom"], default="json",
                    help="prom = Prometheus text exposition")
    ps.add_argument("--metrics-dir", dest="metrics_dir", default=None,
                    help="shared metrics dir: the latest train/eval record of every "
                         "worker's JSONL stream (<dir>/<run>/worker*.jsonl)")
    ps.add_argument("--broker", default=None, dest="status_broker", metavar="HOST:PORT",
                    help="dial a broker directly for the liveness table and its ROLE "
                         "(role/epoch/applied-seq); AUTH token from $DLCFN_BROKER_TOKEN")
    ps.add_argument("--suspect-after", type=float, default=15.0, dest="suspect_after",
                    metavar="S", help="heartbeat age (s) before a worker is SUSPECT")
    ps.add_argument("--dead-after", type=float, default=60.0, dest="dead_after",
                    metavar="S", help="heartbeat age (s) before a worker is DEAD")
    ps.add_argument("--profile", action="store_true",
                    help="with --journal: step-profiler snapshots (per-phase p50/p95/p99) "
                         "and, when step_time events span 2+ hosts, the slowest-host-per-step "
                         "straggler table")
    ps.add_argument("--serve", action="store_true",
                    help="with --journal: per-replica serving snapshots (slots, queue depth, "
                         "TTFT quantiles, tokens/s) folded from serve_metrics events")
    ps.add_argument("--fleet", action="store_true",
                    help="with --broker/--cluster: fleet-merged agent telemetry from the "
                         "broker's TELEM table (gauge sum/max/last per worker, fleet-wide "
                         "summary quantiles, dead fraction)")
    ps.set_defaults(fn=cmd_status)
    pe = sub.add_parser("events", help="tail the obs flight journal")
    pe.add_argument("--journal", default=None,
                    help="journal path (default: $DLCFN_FLIGHT_JOURNAL)")
    pe.add_argument("-n", "--last", type=int, default=50, dest="last",
                    help="how many trailing events to print")
    pe.add_argument("--kind", default=None,
                    help="only events of this kind (e.g. span, reshard)")
    pe.add_argument("--follow", action="store_true",
                    help="live mode: print existing events then poll for appends, across "
                         "journal rotation (tail -F)")
    pe.add_argument("--poll", type=float, default=0.5, metavar="S",
                    help="--follow poll interval in seconds")
    pe.set_defaults(fn=cmd_events)
    pt = sub.add_parser("trace", help="merge flight journals into a Chrome/Perfetto trace "
                                      "timeline")
    pt.add_argument("--journal", action="append", default=[], metavar="PATH",
                    help="flight journal to merge (repeat once per host)")
    pt.add_argument("--out", default=None,
                    help="write trace JSON here (default: stdout; the clock-offset/straggler "
                         "summary always goes to stderr)")
    pt.add_argument("--no-align", action="store_true", dest="no_align",
                    help="skip heartbeat-based cross-host clock alignment (merge on raw "
                         "per-host timestamps)")
    pt.set_defaults(fn=cmd_trace)
    pm = sub.add_parser("postmortem",
                        help="merge blackbox bundles into one causal cross-host timeline")
    pm.add_argument("bundle", nargs="*", metavar="PATH",
                    help="bundle file (blackbox-<host>.json) or a directory of them; repeat "
                         "once per host")
    pm.add_argument("--format", choices=["text", "json"], default="text",
                    help="text = aligned timeline with alerts overlaid; json = the full "
                         "merged structure")
    pm.add_argument("-n", "--last", type=int, default=0, dest="last",
                    help="only the last N timeline events (0 = all)")
    pm.set_defaults(fn=cmd_postmortem)
    pd = sub.add_parser("sched", help="fleet arbiter: inspect or build the scheduling ledger")
    pd.add_argument("--ledger", required=True, type=Path, metavar="PATH",
                    help="JSON ledger file (file-backed stand-in for the broker KV the "
                         "arbiter persists through)")
    pd.add_argument("--init", default=None, metavar="SPEC",
                    help="seed a fresh ledger with this slice inventory, e.g. s0=4,s1=4,s2=4 "
                         "(slice=chips, comma-separated)")
    pd.add_argument("--submit", default=None, metavar="NAME",
                    help="admit a job and place it on free slices")
    pd.add_argument("--kind", default="train", choices=["train", "serve"],
                    help="job kind for --submit")
    pd.add_argument("--priority", default="batch",
                    choices=["prod-serve", "prod-train", "batch"],
                    help="priority class for --submit")
    pd.add_argument("--min-slices", type=int, default=1, dest="min_slices",
                    help="quota floor: fewer than this and the job is unplaced, never "
                         "partially placed")
    pd.add_argument("--max-slices", type=int, default=1, dest="max_slices",
                    help="quota ceiling for opportunistic fill")
    pd.set_defaults(fn=cmd_sched)
    px = sub.add_parser("chaos", help="run seeded fault-injection scenarios (resilience soak)")
    px.add_argument("--scenario", default=None,
                    help="scenario name (see --list): silent-death, partition, flaky-rpc, "
                         "slow-disk, slice-loss-live, data-reshard-live, straggler, "
                         "serve-replica-loss, broker-failover, split-brain, shard-failover, "
                         "degraded-pair-heal, alert-storm, sched-flash-crowd, gauntlet")
    px.add_argument("--seed", type=int, default=0,
                    help="fault-schedule seed; reports are deterministic per (scenario, seed)")
    px.add_argument("--all", action="store_true", help="run every scenario in the catalog")
    px.add_argument("--list", action="store_true", dest="list_scenarios",
                    help="list scenarios and exit")
    px.add_argument("--device", default="cuda",
                    help="where the scenarios' trainers and engines run: cuda (default) or cpu")
    px.set_defaults(fn=cmd_chaos)
    pg = sub.add_parser("gauntlet", help="run composed multi-fault incidents with "
                                         "cross-subsystem invariants (chaos gauntlet)")
    pg.add_argument("--seed", type=int, default=0,
                    help="schedule seed (pinned run) or sweep base seed; reports are the "
                         "same per seed")
    pg.add_argument("--sweep", type=int, default=None, metavar="N",
                    help="explore N perturbed fault schedules instead of the pinned 3-fault "
                         "incident, shrinking any failure to a minimal reproducer")
    pg.add_argument("--device", default="cuda",
                    help="where the trainer's ranks run: cuda (default) or cpu")
    pg.set_defaults(fn=cmd_gauntlet)
    # lint needs no template: it analyzes the repo's own source.
    pl = sub.add_parser("lint", help="repo-native static analysis (dlcfn-lint)")
    pl.add_argument("paths", nargs="*",
                    help="files/dirs to lint (default: the package, "
                         "scripts/, and bench.py)")
    pl.add_argument("--format", choices=["text", "json"], default="text")
    pl.add_argument("--select", action="append", default=[],
                    metavar="RULES",
                    help="comma-separated rule ids to run (e.g. "
                         "DLC001,DLC100); default: all ungated rules. "
                         "Naming a gated id (DLC2xx/DLC3xx/DLC4xx/DLC5xx/"
                         "DLC6xx) enables it.")
    pl.add_argument("--concurrency", action="store_true",
                    help="also run the DLC2xx lockset/thread-escape rules")
    pl.add_argument("--protocol", action="store_true",
                    help="also run the DLC3xx broker message-shape and "
                         "lifecycle-kind checkers")
    pl.add_argument("--sharding", action="store_true",
                    help="also run the DLC4xx CUDA-graph capture-safety rules "
                         "(frozen values/in-place state/mesh-axis/host-sync)")
    pl.add_argument("--comms", action="store_true",
                    help="also run the DLC5xx communication/memory rules "
                         "(placement consistency/unplaced DTensor chains/"
                         "host gathers/cross-mesh replays/local reductions)")
    pl.add_argument("--determinism", action="store_true",
                    help="also run the DLC6xx determinism rules (unsorted "
                         "fs enumeration/ambient entropy/set-order folds/"
                         "hash() escapes/seed-plumbing breaks)")
    pl.add_argument("--baseline", nargs="?", metavar="PATH", default=None,
                    const=_BASELINE_DEFAULT_SENTINEL,
                    help="suppress findings recorded in this baseline file "
                         "(no value: the port's analysis/lint_baseline.json); new "
                         "findings still fail, stale entries are reported")
    pl.add_argument("--write-baseline", action="store_true",
                    dest="write_baseline",
                    help="write the current findings to the baseline file "
                         "instead of failing (the one ratchet-reset tool)")
    pl.set_defaults(fn=cmd_lint)
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
