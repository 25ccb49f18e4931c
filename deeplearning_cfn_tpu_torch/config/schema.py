"""Typed cluster/job configuration schema.

One schema replaces the reference's four configuration mechanisms (SURVEY §5):
CloudFormation Parameters with AllowedValues/constraints
(deeplearning.template:4-108), the AWS_DL_*/DEEPLEARNING_* env-var contract
(deeplearning.template:551-563, dl_cfn_setup_v2.py:104-109), editable header
variables in the stack scripts (mask-rcnn-stack.sh:3-60), and trainer
argparse flags (generate_trainer.py:4-15).

The schema is plain dataclasses with explicit validation so it can render to
provisioner requests, worker env contracts, and trainer configs from a single
source of truth.

Counterpart of ``deeplearning_cfn_tpu/config/schema.py``, copied: the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field, asdict
from typing import Any

# TPU accelerator types the provisioner accepts — the analog of the 56-entry
# EC2 InstanceType AllowedValues list (deeplearning.template:19-77).  The
# per-type entry records (chips per worker VM, total chips) so discovery can
# derive device inventory without probing, replacing the GPU-count
# instance-type whitelist + nvidia-smi probe (dl_cfn_setup_v2.py:51,76-90).
ALLOWED_ACCELERATOR_TYPES: dict[str, dict[str, int]] = {
    # v4: 4 chips/VM
    "v4-8": {"chips_per_worker": 4, "chips": 4},
    "v4-16": {"chips_per_worker": 4, "chips": 8},
    "v4-32": {"chips_per_worker": 4, "chips": 16},
    "v4-64": {"chips_per_worker": 4, "chips": 32},
    "v4-128": {"chips_per_worker": 4, "chips": 64},
    "v4-256": {"chips_per_worker": 4, "chips": 128},
    "v4-512": {"chips_per_worker": 4, "chips": 256},
    # v5e: 1 chip/core VM topologies (common slices)
    "v5litepod-1": {"chips_per_worker": 1, "chips": 1},
    "v5litepod-4": {"chips_per_worker": 4, "chips": 4},
    "v5litepod-8": {"chips_per_worker": 8, "chips": 8},
    "v5litepod-16": {"chips_per_worker": 4, "chips": 16},
    "v5litepod-32": {"chips_per_worker": 4, "chips": 32},
    "v5litepod-64": {"chips_per_worker": 4, "chips": 64},
    "v5litepod-128": {"chips_per_worker": 4, "chips": 128},
    "v5litepod-256": {"chips_per_worker": 4, "chips": 256},
    # v5p: 4 chips/VM ("-N" counts TensorCores; chips = N/2)
    "v5p-8": {"chips_per_worker": 4, "chips": 4},
    "v5p-16": {"chips_per_worker": 4, "chips": 8},
    "v5p-32": {"chips_per_worker": 4, "chips": 16},
    "v5p-64": {"chips_per_worker": 4, "chips": 32},
    "v5p-128": {"chips_per_worker": 4, "chips": 64},
    "v5p-256": {"chips_per_worker": 4, "chips": 128},
    "v5p-512": {"chips_per_worker": 4, "chips": 256},
    "v6e-1": {"chips_per_worker": 1, "chips": 1},
    "v6e-4": {"chips_per_worker": 4, "chips": 4},
    "v6e-8": {"chips_per_worker": 8, "chips": 8},
    "v6e-16": {"chips_per_worker": 4, "chips": 16},
    "v6e-32": {"chips_per_worker": 4, "chips": 32},
    "v6e-64": {"chips_per_worker": 4, "chips": 64},
    "v6e-128": {"chips_per_worker": 4, "chips": 128},
    "v6e-256": {"chips_per_worker": 4, "chips": 256},
    # local/testing backend: arbitrary CPU "chips"
    "local-1": {"chips_per_worker": 1, "chips": 1},
    "local-2": {"chips_per_worker": 1, "chips": 2},
    "local-4": {"chips_per_worker": 1, "chips": 4},
    "local-8": {"chips_per_worker": 1, "chips": 8},
}

_NAME_RE = re.compile(r"^[a-z][a-z0-9-]{0,62}$")


class ConfigError(ValueError):
    """Raised when a spec fails validation (the AllowedValues analog)."""


def accelerator_workers(accelerator_type: str) -> int:
    info = ALLOWED_ACCELERATOR_TYPES[accelerator_type]
    return max(1, info["chips"] // info["chips_per_worker"])


def accelerator_chips_per_worker(accelerator_type: str) -> int:
    return ALLOWED_ACCELERATOR_TYPES[accelerator_type]["chips_per_worker"]


@dataclass
class StorageSpec:
    """Shared-storage config: the EFS/FSx/EBS triad, TPU-native.

    ``existing_id`` gives create-or-reuse semantics like the reference's
    EFSFileSystemId parameter + condition (deeplearning.template:95-111);
    ``retain_on_delete`` mirrors EFS DeletionPolicy: Retain (:456).
    ``data_sources`` is an ordered probe list — the launcher picks the first
    available source, like run.sh:21-35 probing FSx -> EFS -> EBS.
    """

    kind: str = "gcs"  # gcs | filestore | local
    existing_id: str | None = None
    mount_point: str = "/mnt/dlcfn"
    retain_on_delete: bool = True
    data_sources: list[str] = field(default_factory=list)

    def validate(self) -> None:
        if self.kind not in ("gcs", "filestore", "local"):
            raise ConfigError(f"storage.kind must be gcs|filestore|local, got {self.kind!r}")
        if not self.mount_point.startswith("/"):
            raise ConfigError(f"storage.mount_point must be absolute, got {self.mount_point!r}")


@dataclass
class NodePool:
    """A pool of identical workers — the ASG analog.

    The reference uses two ASGs (master: 1 instance, workers: N;
    deeplearning.template:666-742).  On TPU a slice is symmetric, so a pool
    describes one slice; ``min_workers`` powers degrade-and-continue: if at
    least this many workers come up healthy the cluster proceeds at reduced
    size (lambda_function.py:142-169, README.md:49).

    ``disk_size_gb``/``disk_type`` are the EBS volume sizing params of the
    Mask R-CNN stack (mask-rcnn-cfn.yaml:54-73,190-198), mapped to the TPU
    VM boot/data disk.
    """

    accelerator_type: str = "v5p-32"
    workers: int | None = None  # PER-SLICE workers; derived when None
    min_workers: int | None = None  # None => must reach full size
    # Multi-slice scale-out (SURVEY §7 hard part 5): ``slices`` identical
    # TPU slices composed over DCN (parallel/mesh.py:build_hybrid_mesh is
    # the compute-side pairing).  A slice is all-or-nothing in a way an
    # ASG is not, so degrade-and-continue at this level means DROPPING a
    # failed slice when at least ``min_slices`` remain — the TPU shape of
    # lambda_function.py:142-169's shrink-the-ASG policy.
    slices: int = 1
    min_slices: int | None = None  # None => all slices required
    placement_policy: str = "compact"  # placement-group analog (mask-rcnn-cfn.yaml:313-316)
    runtime_version: str = "tpu-ubuntu2204-base"  # the AMI/ImageType analog
    image_override: str | None = None  # AMIOverride analog (mask-rcnn-cfn.yaml:155-160)
    reserved: bool = False
    spot: bool = False
    disk_size_gb: int = 100
    disk_type: str = "pd-balanced"

    def validate(self) -> None:
        if self.disk_size_gb < 10:
            raise ConfigError(f"disk_size_gb must be >= 10, got {self.disk_size_gb}")
        if self.disk_type not in ("pd-standard", "pd-balanced", "pd-ssd"):
            raise ConfigError(f"unknown disk_type {self.disk_type!r}")
        if self.accelerator_type not in ALLOWED_ACCELERATOR_TYPES:
            raise ConfigError(
                f"accelerator_type {self.accelerator_type!r} not in allowed set "
                f"({len(ALLOWED_ACCELERATOR_TYPES)} types); e.g. v5p-32, v5litepod-16, local-8"
            )
        if self.spot and self.reserved:
            raise ConfigError("node pool cannot be both spot and reserved")
        n = self.num_workers
        if n < 1:
            raise ConfigError(f"workers must be >= 1, got {n}")
        if self.min_workers is not None and not (1 <= self.min_workers <= n):
            raise ConfigError(
                f"min_workers must be in [1, {n}], got {self.min_workers}"
            )
        if self.slices < 1:
            raise ConfigError(f"slices must be >= 1, got {self.slices}")
        if self.min_slices is not None and not (1 <= self.min_slices <= self.slices):
            raise ConfigError(
                f"min_slices must be in [1, {self.slices}], got {self.min_slices}"
            )

    @property
    def num_workers(self) -> int:
        """Workers per slice."""
        if self.workers is not None:
            return self.workers
        return accelerator_workers(self.accelerator_type)

    @property
    def total_workers(self) -> int:
        return self.num_workers * self.slices

    @property
    def chips_per_worker(self) -> int:
        return accelerator_chips_per_worker(self.accelerator_type)

    @property
    def total_chips(self) -> int:
        return self.total_workers * self.chips_per_worker


@dataclass
class NetworkSpec:
    """Networking: create-a-network vs bring-your-own.

    The core template builds the whole network layer (VPC + public/private
    subnets + IGW/NAT, deeplearning.template:785-901); the private Mask
    R-CNN variant instead takes MyVpcId/PrivateSubnetId parameters and
    creates nothing (private-mask-rcnn-cfn.yaml, SURVEY C10).  ``create``
    selects between the two; ``external_ips=False`` is the
    AssociatePublicIpAddress:false analog (private-mask-rcnn-cfn.yaml:1248).
    """

    create: bool = True
    network: str | None = None  # existing VPC name when create=False
    subnetwork: str | None = None
    external_ips: bool = False

    def validate(self) -> None:
        if not self.create and not (self.network and self.subnetwork):
            raise ConfigError(
                "network.create=false requires existing network and "
                "subnetwork names (the MyVpcId/PrivateSubnetId analog); the "
                "subnet must already route to the TPU and storage APIs"
            )


@dataclass
class StagingSpec:
    """Dataset/code staging — the S3 bucket choreography of SURVEY C8/C9.

    ``bucket``/``prefix`` name the artifact store (prepare-s3-bucket.sh
    uploads to s3://$S3_BUCKET/$S3_PREFIX); ``datasets``/``code`` list the
    artifact names every worker fetches at boot (mask-rcnn-cfn.yaml:790-827
    tar download+extract steps).  ``data_on_shared_storage`` is the
    EFSServesData condition (mask-rcnn-cfn.yaml:226-228): True places
    datasets on the shared mount once (marker-file guarded), False places
    them on every worker's local disk.
    """

    bucket: str | None = None
    prefix: str = "dlcfn"
    datasets: list[str] = field(default_factory=list)
    code: list[str] = field(default_factory=list)
    data_on_shared_storage: bool = True

    def validate(self) -> None:
        if (self.datasets or self.code) and not self.bucket:
            raise ConfigError("staging artifacts listed but no staging bucket set")


@dataclass
class SetupSpec:
    """Per-node environment setup — the setup.sh analog (SURVEY C7):
    pinned Python deps and arbitrary post-boot commands, plus the
    ActivateCondaEnv-style auto-activation (mask-rcnn-cfn.yaml:199-221)."""

    pip_packages: list[str] = field(default_factory=list)
    commands: list[str] = field(default_factory=list)
    activate_env: str | None = None  # venv path auto-activated in login shells

    def validate(self) -> None:
        for pkg in self.pip_packages:
            if any(c in pkg for c in ";|&`$"):
                raise ConfigError(f"suspicious pip package spec {pkg!r}")


@dataclass
class TimeoutSpec:
    """Wallclock budgets for provisioning phases.

    Mirrors the reference's timeout ladder: WaitCondition 3300 s
    (deeplearning.template:174,769-780), master launch 600 s (:669-674),
    Mask R-CNN stack 3600/1200 s (mask-rcnn-cfn.yaml:304-306), 30 s poll
    cadence (dl_cfn_setup_v2.py:36-37).
    """

    cluster_ready_s: float = 3300.0
    controller_launch_s: float = 600.0
    poll_interval_s: float = 30.0

    def validate(self) -> None:
        if self.cluster_ready_s <= self.controller_launch_s:
            raise ConfigError(
                "cluster_ready_s must exceed controller_launch_s "
                f"({self.cluster_ready_s} <= {self.controller_launch_s})"
            )
        if self.poll_interval_s <= 0:
            raise ConfigError("poll_interval_s must be positive")

    @property
    def bootstrap_budget_s(self) -> float:
        # setup_timeout = WAITCONDITION_TIMEOUT - MASTERLAUNCH_TIMEOUT
        # (dl_cfn_setup_v2.py:411-415)
        return self.cluster_ready_s - self.controller_launch_s


@dataclass
class JobSpec:
    """A training job: what run.sh header vars + trainer flags configured.

    ``steps_per_epoch_numerator`` encodes the linear-scaling contract
    STEPS_PER_EPOCH = N / (workers * chips) from run.sh:56,66.
    """

    name: str = "train"
    module: str = "deeplearning_cfn_tpu.train.trainer"
    args: dict[str, Any] = field(default_factory=dict)
    global_batch_size: int = 256
    steps_per_epoch_numerator: int | None = None
    require_even_workers: bool = False  # run.sh:43-44 invariant
    log_dir: str | None = None
    checkpoint_dir: str | None = None
    checkpoint_interval_s: float = 60.0  # cifar10_multi_machine_train.py:103-107

    def validate(self, pool: NodePool) -> None:
        if self.global_batch_size % max(pool.total_chips, 1) != 0:
            raise ConfigError(
                f"global_batch_size {self.global_batch_size} not divisible by "
                f"total chips {pool.total_chips}"
            )
        if (
            self.require_even_workers
            and pool.total_workers not in (1,)
            and pool.total_workers % 2
        ):
            raise ConfigError(
                f"worker count must be 1 or even, got {pool.total_workers}"
            )

    def steps_per_epoch(self, pool: NodePool) -> int | None:
        if self.steps_per_epoch_numerator is None:
            return None
        return max(1, self.steps_per_epoch_numerator // max(pool.total_chips, 1))


@dataclass
class ClusterSpec:
    """Top-level cluster description — the deeplearning.template analog."""

    name: str = "deeplearning"
    backend: str = "local"  # local | gcp
    project: str | None = None
    zone: str | None = None
    pool: NodePool = field(default_factory=NodePool)
    storage: StorageSpec = field(default_factory=StorageSpec)
    network: NetworkSpec = field(default_factory=NetworkSpec)
    staging: StagingSpec = field(default_factory=StagingSpec)
    setup: SetupSpec = field(default_factory=SetupSpec)
    timeouts: TimeoutSpec = field(default_factory=TimeoutSpec)
    job: JobSpec = field(default_factory=JobSpec)
    ssh_source_cidr: str = "0.0.0.0/0"  # SSHLocation analog (deeplearning.template:87-94)
    tags: dict[str, str] = field(default_factory=dict)

    def validate(self) -> "ClusterSpec":
        if not _NAME_RE.match(self.name):
            raise ConfigError(
                f"cluster name must match {_NAME_RE.pattern}, got {self.name!r}"
            )
        if self.backend not in ("local", "gcp"):
            raise ConfigError(f"backend must be local|gcp, got {self.backend!r}")
        if self.backend == "gcp" and not (self.project and self.zone):
            raise ConfigError("gcp backend requires project and zone")
        self.pool.validate()
        self.storage.validate()
        self.network.validate()
        self.staging.validate()
        self.setup.validate()
        self.timeouts.validate()
        self.job.validate(self.pool)
        return self

    # ---- serialization -------------------------------------------------
    def to_dict(self) -> dict[str, Any]:
        return asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ClusterSpec":
        d = dict(d)
        if "pool" in d and isinstance(d["pool"], dict):
            d["pool"] = NodePool(**d["pool"])
        if "storage" in d and isinstance(d["storage"], dict):
            d["storage"] = StorageSpec(**d["storage"])
        if "network" in d and isinstance(d["network"], dict):
            d["network"] = NetworkSpec(**d["network"])
        if "staging" in d and isinstance(d["staging"], dict):
            d["staging"] = StagingSpec(**d["staging"])
        if "setup" in d and isinstance(d["setup"], dict):
            d["setup"] = SetupSpec(**d["setup"])
        if "timeouts" in d and isinstance(d["timeouts"], dict):
            d["timeouts"] = TimeoutSpec(**d["timeouts"])
        if "job" in d and isinstance(d["job"], dict):
            d["job"] = JobSpec(**d["job"])
        spec = cls(**d)
        return spec.validate()
