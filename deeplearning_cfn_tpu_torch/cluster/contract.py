"""The cluster contract: what discovery publishes for training jobs.
Counterpart of ``deeplearning_cfn_tpu/cluster/contract.py``, copied: the
files ``write`` publishes are byte-equal to the JAX package's.

The reference's bootstrap ends by writing three artifacts every trainer
consumes (dl_cfn_setup_v2.py:92-116, documented README.md:89-97):

1. ``/etc/hosts`` names ``deeplearning-master`` / ``deeplearning-workerN``
   (dl_cfn_setup_v2.py:95-101) — consumed by run.sh's hostfile (run.sh:46-53).
2. ``/opt/deeplearning/workers`` — one hostname per line.
3. ``/etc/profile.d/deeplearning.sh`` exporting DEEPLEARNING_WORKERS_COUNT,
   DEEPLEARNING_WORKERS_PATH, DEEPLEARNING_WORKER_GPU_COUNT, EFS_MOUNT.

This module reproduces that contract (chips instead of GPUs) and extends it
with the field JAX actually needs that MPI got from mpirun: the coordinator
address + process count + process id for ``jax.distributed.initialize``.
The master-is-also-worker-0 rule and deterministic IP ordering are kept:
the coordinator's IP is prepended and the remainder sorted
(dl_cfn_setup_v2.py:330-342), so every node derives the identical worker
list independently.
"""

from __future__ import annotations

import json
import os
import shlex
from dataclasses import dataclass, field, asdict
from pathlib import Path

from deeplearning_cfn_tpu_torch.utils.atomicio import atomic_write_text

COORDINATOR_HOSTNAME = "deeplearning-master"
WORKER_HOSTNAME_FMT = "deeplearning-worker{index}"
DEFAULT_COORDINATOR_PORT = 8476

# The broker wire protocol's canonical verb set — the single source of
# truth the cross-language contract checker (analysis/contract_check.py,
# DLC100) enforces against broker_client.py, broker_service.py, and the
# C++ dispatch chain in native/broker/broker.cpp.  Adding a verb to any
# one layer without the others fails `dlcfn lint`.
BROKER_PROTOCOL_VERBS = (
    "AUTH",   # AUTH <token>                     authenticate the connection
    "PING",   # PING                             liveness probe
    "SEND",   # SEND <queue> <nbytes>\n<body>    enqueue a message
    "RECV",   # RECV <queue> <max> <vis_ms>      lease up to max messages
    "DEL",    # DEL <queue> <receipt>            ack a leased message
    "DEPTH",  # DEPTH <queue>                    visible + in-flight counts
    "PURGE",  # PURGE <queue>                    drop all messages
    "SET",    # SET <key> <nbytes>\n<value>      kv store write
    "GET",    # GET <key>                        kv store read
    "UNSET",  # UNSET <key>                      kv store delete
    # HEARTBEAT <worker>                         record a liveness beat
    # HEARTBEAT                                  dump table: N <n> then HB lines
    "HEARTBEAT",
    # TELEM <worker> <nbytes>\n<snapshot>        record a telemetry snapshot
    # TELEM                                      dump snapshots: N <n> then TM frames
    "TELEM",
    # -- replication / leader handover (docs/RESILIENCE.md "Broker
    #    failover"): a warm standby replays the primary's journal and is
    #    promoted with a higher epoch; epoch fencing rejects the deposed
    #    primary's stale stream.
    "SENDID",   # SENDID <queue> <rid> <nbytes>\n<body>  enqueue, idempotent by rid
    "ROLE",     # ROLE                             report role, epoch, repl seq
    "PROMOTE",  # PROMOTE <epoch>                  fence to epoch, become primary
    "SYNC",     # SYNC <epoch> <seq> <nbytes>\n<entry>   replicate one journal frame
    # -- keyspace sharding (docs/RESILIENCE.md "Sharded broker"): each
    #    primary/standby pair owns one consistent-hash shard of the
    #    queue/KV/heartbeat keyspace; SHARD lets a router verify it
    #    dialed the owner of the keys it routes there.
    "SHARD",    # SHARD                            report shard index, total shards
)


@dataclass
class ClusterContract:
    cluster_name: str
    coordinator_ip: str
    worker_ips: list[str]  # coordinator first, rest sorted
    chips_per_worker: int
    storage_mount: str
    coordinator_port: int = DEFAULT_COORDINATOR_PORT
    degraded: bool = False
    tags: dict[str, str] = field(default_factory=dict)
    # Multi-slice topology: group name -> that slice's worker IPs, in
    # slice order (None/absent = single slice).  Lets compute build the
    # hybrid ICI x DCN mesh from the contract alone
    # (parallel/mesh.py:hybrid_mesh_for_slices).
    slices: dict[str, list[str]] | None = None

    @classmethod
    def build(
        cls,
        cluster_name: str,
        coordinator_ip: str,
        other_worker_ips: list[str],
        chips_per_worker: int,
        storage_mount: str,
        degraded: bool = False,
        slices: dict[str, list[str]] | None = None,
    ) -> "ClusterContract":
        # Coordinator doubles as worker 0 (StackSetup.md:110-111); its IP is
        # prepended and the rest sorted for a stable order (dl_cfn_setup_v2.py:330-342).
        #
        # Multi-slice: process ids follow worker_ips order, and
        # build_hybrid_mesh's process-granule fallback reshapes CONSECUTIVE
        # process blocks into the DCN axes (parallel/mesh.py) — so each
        # slice's IPs must stay contiguous (a global lexicographic sort
        # would interleave slices and silently put per-step ICI collectives
        # over DCN).  Coordinator's slice comes first (it holds process 0);
        # the stored ``slices`` is normalized so its concatenation IS
        # worker_ips.
        if slices:
            coord_slices = [
                g for g, ips in slices.items() if coordinator_ip in ips
            ]
            if not coord_slices:
                # Prepending the coordinator outside the topology would
                # shift every process id by one relative to the slices —
                # the exact misalignment this ordering exists to prevent.
                raise ValueError(
                    f"coordinator {coordinator_ip} is not in any slice"
                )
            n_coord = sum(
                ips.count(coordinator_ip) for ips in slices.values()
            )
            if n_coord > 1:
                # Silently stripping the extra occurrences would publish a
                # slice smaller than discovery reported and shift the
                # process-id -> slice mapping.
                raise ValueError(
                    f"coordinator {coordinator_ip} appears {n_coord} times "
                    f"in the slice topology (slices {sorted(coord_slices)})"
                )
            coord_slice = coord_slices[0]
            names = sorted(slices, key=lambda g: (g != coord_slice, g))
            norm: dict[str, list[str]] = {}
            for g in names:
                members = sorted(ip for ip in slices[g] if ip != coordinator_ip)
                if g == coord_slice:
                    members = [coordinator_ip] + members
                norm[g] = members
            worker_ips = [ip for ips in norm.values() for ip in ips]
            covered = set(worker_ips)
            if len(worker_ips) != len(covered):
                dupes = sorted(
                    {ip for ip in worker_ips if worker_ips.count(ip) > 1}
                )
                raise ValueError(f"duplicate IPs in slice topology: {dupes}")
            known = set(other_worker_ips) | {coordinator_ip}
            leftover = sorted(known - covered)
            if leftover:
                raise ValueError(
                    f"worker IPs missing from slice topology: {leftover}"
                )
            phantom = sorted(covered - known)
            if phantom:
                raise ValueError(
                    f"slice topology names IPs discovery never reported: {phantom}"
                )
            slices = norm
        else:
            rest = sorted(ip for ip in other_worker_ips if ip != coordinator_ip)
            worker_ips = [coordinator_ip] + rest
        return cls(
            cluster_name=cluster_name,
            coordinator_ip=coordinator_ip,
            worker_ips=worker_ips,
            chips_per_worker=chips_per_worker,
            storage_mount=storage_mount,
            degraded=degraded,
            slices=slices,
        )

    def surviving(self, lost_groups) -> "ClusterContract":
        """The post-loss contract: the same cluster minus the dead slices.

        This is the topology half of live elastic resharding
        (docs/RESILIENCE.md): when the liveness plane declares a slice
        dead, the trainer re-forms its mesh from THIS derivation instead
        of waiting for a reprovision.  Raises ``ValueError`` when a live
        reshard is structurally impossible — no slice topology at all,
        none of the named groups are slices here (idempotence against
        duplicate/stale loss notifications is the caller's job), nothing
        survives, or the coordinator's own slice died (process 0 is gone;
        only the restart-provision path can help).  Goes through
        :meth:`build` so the survivor ordering invariants (coordinator's
        slice first, contiguous slices) are re-validated, and is marked
        ``degraded`` — the same flag the launch-error path sets.
        """
        if not self.slices:
            raise ValueError(
                "contract has no slice topology; cannot derive survivors"
            )
        lost = {g for g in lost_groups if g in self.slices}
        if not lost:
            raise ValueError(
                f"none of {sorted(set(lost_groups))} are slices of this "
                f"contract (slices: {sorted(self.slices)})"
            )
        keep = {g: list(ips) for g, ips in self.slices.items() if g not in lost}
        if not keep:
            raise ValueError("no surviving slices; full reprovision required")
        survivors = [ip for ips in keep.values() for ip in ips]
        if self.coordinator_ip not in survivors:
            raise ValueError(
                f"coordinator {self.coordinator_ip}'s slice was lost; live "
                "reshard impossible (process 0 is gone) — use the "
                "recreate-and-restore path"
            )
        contract = ClusterContract.build(
            cluster_name=self.cluster_name,
            coordinator_ip=self.coordinator_ip,
            other_worker_ips=[ip for ip in survivors if ip != self.coordinator_ip],
            chips_per_worker=self.chips_per_worker,
            storage_mount=self.storage_mount,
            degraded=True,
            slices=keep,
        )
        contract.coordinator_port = self.coordinator_port
        contract.tags = dict(self.tags)
        return contract

    def restored(
        self, regained: dict[str, list[str]], degraded: bool = False
    ) -> "ClusterContract":
        """The grow-back derivation — ``surviving()``'s inverse: the same
        cluster plus slices returning to it (a lent slice coming home
        after a scheduler preemption resolves, or a reprovisioned slice
        rejoining).  Goes through :meth:`build` so the ordering
        invariants (coordinator's slice first, contiguous slices) are
        re-validated on the grown topology; ``degraded`` defaults to
        False — a restore is the cluster returning to strength.  Raises
        ``ValueError`` when there is no slice topology, a regained group
        is already present, or a regained IP is already a worker.
        """
        if not self.slices:
            raise ValueError(
                "contract has no slice topology; cannot restore slices into it"
            )
        if not regained:
            raise ValueError("no slices to restore")
        already = sorted(set(regained) & set(self.slices))
        if already:
            raise ValueError(f"slices already present: {already}")
        merged = {g: list(ips) for g, ips in self.slices.items()}
        merged.update({g: list(ips) for g, ips in regained.items()})
        contract = ClusterContract.build(
            cluster_name=self.cluster_name,
            coordinator_ip=self.coordinator_ip,
            other_worker_ips=[
                ip
                for ips in merged.values()
                for ip in ips
                if ip != self.coordinator_ip
            ],
            chips_per_worker=self.chips_per_worker,
            storage_mount=self.storage_mount,
            degraded=degraded,
            slices=merged,
        )
        contract.coordinator_port = self.coordinator_port
        contract.tags = dict(self.tags)
        return contract

    # --- derived views ----------------------------------------------------
    @property
    def workers_count(self) -> int:
        return len(self.worker_ips)

    @property
    def slices_count(self) -> int:
        return len(self.slices) if self.slices else 1

    @property
    def total_chips(self) -> int:
        return self.workers_count * self.chips_per_worker

    def slice_inventory(self) -> dict[str, int]:
        """Slice name -> chips: the fleet scheduler's placement currency
        (sched/placer.py).  A single-slice contract exposes its whole
        capacity under the one name the arbiter can reason about."""
        if self.slices:
            return {
                g: len(ips) * self.chips_per_worker
                for g, ips in self.slices.items()
            }
        return {"all": self.total_chips}

    def hostnames(self) -> list[str]:
        # worker0 answers to both names, as in the reference where the master
        # appears in /etc/hosts as deeplearning-master AND heads the list.
        return [COORDINATOR_HOSTNAME] + [
            WORKER_HOSTNAME_FMT.format(index=i + 1) for i in range(self.workers_count - 1)
        ]

    def hosts_entries(self) -> list[tuple[str, str]]:
        return list(zip(self.worker_ips, self.hostnames()))

    def datastream_hosts(self) -> tuple[str, ...]:
        """The data plane's host ordering (train/datastream): shard
        assignment is positional over this tuple, so it must be the
        contract's canonical worker order — coordinator's slice first,
        slices contiguous (``build()`` normalizes exactly that).  A
        ``surviving()`` contract preserves relative order, which is what
        keeps reassignment deterministic across a live reshard."""
        return tuple(self.worker_ips)

    def env(self, root: Path | None = None) -> dict[str, str]:
        """The DEEPLEARNING_* contract (dl_cfn_setup_v2.py:104-109), chips
        instead of GPUs, plus the jax.distributed coordination triple.

        ``root`` must be the directory the contract was (or will be)
        published to, so DEEPLEARNING_WORKERS_PATH points at the workers
        file that actually exists."""
        root = root or self.root_dir()
        return {
            "DEEPLEARNING_WORKERS_COUNT": str(self.workers_count),
            "DEEPLEARNING_WORKERS_PATH": str(root / "workers"),
            "DEEPLEARNING_WORKER_CHIP_COUNT": str(self.chips_per_worker),
            "DEEPLEARNING_STORAGE_MOUNT": self.storage_mount,
            "DEEPLEARNING_COORDINATOR": f"{self.coordinator_ip}:{self.coordinator_port}",
            "DEEPLEARNING_CLUSTER_NAME": self.cluster_name,
            "DEEPLEARNING_DEGRADED": "1" if self.degraded else "0",
            "DEEPLEARNING_SLICES_COUNT": str(self.slices_count),
        }

    def jax_initialize_kwargs(self, process_id: int) -> dict[str, object]:
        """Arguments for jax.distributed.initialize — the rendezvous MPI's
        mpirun provided in the reference (run.sh:72-77), without SSH."""
        return {
            "coordinator_address": f"{self.coordinator_ip}:{self.coordinator_port}",
            "num_processes": self.workers_count,
            "process_id": process_id,
        }

    # --- filesystem publication ------------------------------------------
    @staticmethod
    def root_dir() -> Path:
        return Path(os.environ.get("DLCFN_ROOT", "/opt/deeplearning"))

    def workers_file_path(self) -> Path:
        return self.root_dir() / "workers"

    def write(self, root: Path | None = None) -> Path:
        # Atomic per file: on-VM agents read these while the coordinator
        # (re)publishes them — a torn contract.json must be impossible.
        root = root or self.root_dir()
        root.mkdir(parents=True, exist_ok=True)
        atomic_write_text(
            root / "workers", "".join(f"{h}\n" for h in self.hostnames())
        )
        atomic_write_text(
            root / "hosts",
            "".join(f"{ip} {host}\n" for ip, host in self.hosts_entries()),
        )
        atomic_write_text(
            root / "env.sh",
            "".join(
                f"export {k}={shlex.quote(v)}\n" for k, v in self.env(root).items()
            ),
        )
        atomic_write_text(
            root / "contract.json", json.dumps(asdict(self), indent=2)
        )
        return root

    @classmethod
    def read(cls, root: Path | None = None) -> "ClusterContract":
        root = root or cls.root_dir()
        return cls(**json.loads((root / "contract.json").read_text()))

    def to_message(self) -> dict[str, object]:
        """The worker-setup broadcast body (dl_cfn_setup_v2.py:346-357)."""
        return {
            "event": "worker-setup",
            "status": "success",
            "coordinator-ip": self.coordinator_ip,
            "worker-ips": self.worker_ips,
            "chips-per-worker": self.chips_per_worker,
            "storage-mount": self.storage_mount,
            "degraded": self.degraded,
            "cluster": self.cluster_name,
            "coordinator-port": self.coordinator_port,
            "tags": self.tags,
            "slices": self.slices,
        }

    @classmethod
    def from_message(cls, body: dict[str, object]) -> "ClusterContract":
        return cls(
            cluster_name=str(body["cluster"]),
            coordinator_ip=str(body["coordinator-ip"]),
            worker_ips=list(body["worker-ips"]),  # type: ignore[arg-type]
            chips_per_worker=int(body["chips-per-worker"]),  # type: ignore[arg-type]
            storage_mount=str(body["storage-mount"]),
            degraded=bool(body.get("degraded", False)),
            coordinator_port=int(body.get("coordinator-port", DEFAULT_COORDINATOR_PORT)),  # type: ignore[arg-type]
            tags=dict(body.get("tags", {})),  # type: ignore[arg-type]
            slices=body.get("slices"),  # type: ignore[arg-type]
        )
