"""Job launcher — from a ready cluster to a running SPMD training job.

Replaces the reference's two launch paths (SURVEY §3.5): the Horovod/mpirun
path (run.sh builds a hostfile, SSH-warms every node, computes
NUM_PARALLEL = workers x gpus, then execs ``mpirun -np`` with transport
tuning, run.sh:46-95) and the TF-PS path (generate_trainer.py writing
per-host scripts with ps/worker topology, generate_trainer.py:19-76).

TPU-native, both collapse into one shape: **every worker runs the same
program**.  The launcher's job is therefore (a) enforcing invariants up
front exactly where run.sh:43-44 did, (b) rendering the per-worker launch
plan (command + env derived from the cluster contract — no SSH fan-out,
workers pick it up from their metadata/startup script), and (c) for the
local backend, executing the program in-process over a virtual mesh.

Counterpart of ``deeplearning_cfn_tpu/cluster/launcher.py``, copied: the port imports
nothing of the JAX package.  Templates name the JAX package's job modules
(``deeplearning_cfn_tpu.examples.lenet_mnist``); :func:`resolve_job_module`
maps them onto the port's, for the rendered command and for ``run``'s import.
"""

from __future__ import annotations

import importlib.util
import shlex
from dataclasses import dataclass, field

from deeplearning_cfn_tpu_torch.cluster.contract import ClusterContract
from deeplearning_cfn_tpu_torch.config.schema import JobSpec
from deeplearning_cfn_tpu_torch.utils.logging import get_logger

log = get_logger("dlcfn.launch")


JAX_PACKAGE = "deeplearning_cfn_tpu"
PORT_PACKAGE = "deeplearning_cfn_tpu_torch"


class LaunchError(RuntimeError):
    pass


def resolve_job_module(module: str) -> str:
    """The module the port runs for a template's job ``module``: one under
    the JAX package maps to the same path under the port's, which must
    exist (``LaunchError`` names a module with no counterpart); any other
    module runs as named."""
    if module != JAX_PACKAGE and not module.startswith(JAX_PACKAGE + "."):
        return module
    mapped = PORT_PACKAGE + module[len(JAX_PACKAGE):]
    try:
        found = importlib.util.find_spec(mapped) is not None
    except ModuleNotFoundError:  # a parent package the port does not have
        found = False
    if not found:
        raise LaunchError(
            f"job module {module!r} has no counterpart in the PyTorch port "
            f"({mapped!r} does not exist)"
        )
    return mapped


@dataclass
class WorkerLaunch:
    process_id: int
    host: str
    command: str
    env: dict[str, str]


@dataclass
class LaunchPlan:
    job_name: str
    module: str  # the job module as the port runs it (resolve_job_module)
    workers: list[WorkerLaunch]
    num_parallel: int  # workers x chips — NUM_PARALLEL (run.sh:56)
    steps_per_epoch: int | None

    def render_script(self, process_id: int) -> str:
        """A per-worker launch script — the {host}.sh analog
        (generate_trainer.py:64-76), env-driven instead of SSH-pushed."""
        w = self.workers[process_id]
        lines = ["#!/bin/bash", "set -euo pipefail"]
        lines += [f"export {k}={shlex.quote(v)}" for k, v in sorted(w.env.items())]
        lines.append(w.command)
        return "\n".join(lines) + "\n"


def build_launch_plan(
    contract: ClusterContract,
    job: JobSpec,
    job_violation: str | None = None,
) -> LaunchPlan:
    """Validate invariants and render the all-workers launch plan."""
    # Invariants checked just before launch, as run.sh:43-44 checked the
    # worker count right before mpirun.
    if job_violation:
        raise LaunchError(
            f"job invalid on the realized cluster: {job_violation}. "
            "Adjust global_batch_size or recreate the cluster at full size."
        )
    n = contract.workers_count
    if job.require_even_workers and n != 1 and n % 2:
        raise LaunchError(f"worker count must be 1 or even, got {n}")
    if job.global_batch_size % contract.total_chips:
        raise LaunchError(
            f"global_batch_size {job.global_batch_size} not divisible by "
            f"{contract.total_chips} chips"
        )

    num_parallel = contract.total_chips
    steps = (
        max(1, job.steps_per_epoch_numerator // num_parallel)
        if job.steps_per_epoch_numerator
        else None
    )

    module = resolve_job_module(job.module)
    args = " ".join(
        f"--{k} {shlex.quote(str(v))}" for k, v in sorted(job.args.items())
    )
    workers = []
    for pid, host in enumerate(contract.hostnames()):
        env = dict(contract.env())
        env["DLCFN_PROCESS_ID"] = str(pid)
        env["DLCFN_JOB_NAME"] = job.name
        workers.append(
            WorkerLaunch(
                process_id=pid,
                host=host,
                command=f"python -m {module} {args}".strip(),
                env=env,
            )
        )
    plan = LaunchPlan(
        job_name=job.name,
        module=module,
        workers=workers,
        num_parallel=num_parallel,
        steps_per_epoch=steps,
    )
    log.info(
        "launch plan %s: %d workers, NUM_PARALLEL=%d, steps/epoch=%s",
        job.name,
        n,
        num_parallel,
        steps,
    )
    return plan


@dataclass
class LocalJobRunner:
    """Executes a launch plan in-process over the virtual device mesh —
    the local backend's stand-in for every TPU VM running its copy."""

    plan: LaunchPlan
    results: list = field(default_factory=list)

    def run(self, entrypoint, *args, **kwargs):
        """Run the job's entrypoint once (single-controller semantics:
        the virtual mesh spans all 'workers')."""
        return entrypoint(*args, **kwargs)
