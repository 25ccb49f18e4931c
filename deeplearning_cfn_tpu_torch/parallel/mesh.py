"""Device meshes — counterpart of ``deeplearning_cfn_tpu/parallel/mesh.py``.

The same six named axes, outermost to innermost: ``dp`` (data parallel,
replicated parameters), ``fsdp`` (data parallel with sharded parameters and
optimizer state), ``pp``, ``sp``, ``tp`` and ``ep`` (experts).  A mesh is a
``torch.distributed`` ``DeviceMesh`` over the ranks of the default process
group, one rank a device; axes of size 1 are kept, as the JAX mesh keeps
them, so every sharding rule reads the same six names whatever the layout.

``tp`` and ``sp`` may be larger than 1 (``parallel/tensor_parallel.py``,
``parallel/ring_attention.py``); ``pp`` and the multi-slice (hybrid ICI x
DCN) meshes come with a later part of the parallelism slice and raise
``NotImplementedError``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXIS_ORDER = ("dp", "fsdp", "pp", "sp", "tp", "ep")

SLICE_5B = ("a later slice of the PyTorch port (slice 5b: pipeline stages, comms overlap "
            "and hybrid meshes)")


class MeshError(ValueError):
    pass


@dataclass
class MeshSpec:
    """Logical parallelism layout; sizes of 1 are kept in the mesh."""

    dp: int = 1
    fsdp: int = 1
    pp: int = 1
    sp: int = 1
    tp: int = 1
    ep: int = 1

    @property
    def total(self) -> int:
        return self.dp * self.fsdp * self.pp * self.sp * self.tp * self.ep

    def axis_sizes(self) -> dict[str, int]:
        return {name: getattr(self, name) for name in AXIS_ORDER}

    @classmethod
    def data_parallel(cls, n_devices: int) -> "MeshSpec":
        return cls(dp=n_devices)

    @classmethod
    def fsdp_parallel(cls, n_devices: int) -> "MeshSpec":
        return cls(fsdp=n_devices)

    def validate(self, n_devices: int) -> "MeshSpec":
        for name, size in self.axis_sizes().items():
            if size < 1:
                raise MeshError(f"axis {name} must be >= 1, got {size}")
        if self.total != n_devices:
            raise MeshError(
                f"mesh axes multiply to {self.total} but {n_devices} devices "
                f"are available ({self.axis_sizes()})"
            )
        return self


def build_mesh(spec: MeshSpec, device_type: str | None = None) -> DeviceMesh:
    """The ranks of the default process group as a ``DeviceMesh`` over
    ``AXIS_ORDER``, row-major, so ``ep`` (then ``tp``, ``sp``) varies
    fastest, as the JAX mesh lays its innermost axes on nearest neighbours.
    ``device_type`` defaults to ``cuda`` when the group's backend is NCCL
    and ``cpu`` otherwise.  ``pp`` must be 1."""
    if not dist.is_initialized():
        raise MeshError("build_mesh needs torch.distributed initialised "
                        "(examples.common.maybe_init_distributed, or init_process_group)")
    spec.validate(dist.get_world_size())
    if spec.pp > 1:
        raise NotImplementedError(f"mesh axis pp > 1 is ported in {SLICE_5B}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(spec.axis_sizes()[a] for a in AXIS_ORDER),
                            mesh_dim_names=AXIS_ORDER)


def mesh_spec(mesh: DeviceMesh) -> MeshSpec:
    """The ``MeshSpec`` a mesh was built from."""
    return MeshSpec(**{a: mesh.size(mesh.mesh_dim_names.index(a)) for a in AXIS_ORDER})


def axis_rank(mesh: DeviceMesh, axis: str) -> int:
    return mesh.get_local_rank(axis)


def data_group(mesh: DeviceMesh):
    """One process group over the ``("dp", "fsdp")`` ranks holding this
    rank: those that split the batch between them (the ranks along ``ep``
    hold the same tokens)."""
    sizes = mesh_spec(mesh)
    if sizes.fsdp == 1:
        return mesh.get_group("dp")
    if sizes.dp == 1:
        return mesh.get_group("fsdp")
    return mesh["dp", "fsdp"]._flatten().get_group()


def data_rank(mesh: DeviceMesh) -> tuple[int, int]:
    """``(index, count)`` of this rank's shard of the batch: ``dp`` major,
    ``fsdp`` minor, as ``P(("dp", "fsdp"))`` splits it."""
    sizes = mesh_spec(mesh)
    return axis_rank(mesh, "dp") * sizes.fsdp + axis_rank(mesh, "fsdp"), sizes.dp * sizes.fsdp


@dataclass
class AutoLayout:
    """Heuristic mesh for a model size and device count: FSDP once the model
    stops fitting replicated, then tp for very large models."""

    n_devices: int
    param_bytes: int = 0
    hbm_bytes_per_chip: int = 16 << 30
    max_tp: int = 8

    def choose(self) -> MeshSpec:
        if self.n_devices == 1:
            return MeshSpec()
        # params + grads + adam moments with an f32 master ~ 16x param bytes;
        # if a replica fits in half of the device memory, plain DP.
        if self.param_bytes and self.param_bytes * 16 < self.hbm_bytes_per_chip // 2:
            return MeshSpec.data_parallel(self.n_devices)
        if self.param_bytes * 16 < self.hbm_bytes_per_chip * self.n_devices // 2:
            return MeshSpec.fsdp_parallel(self.n_devices)
        tp = min(self.max_tp, self.n_devices)
        while self.n_devices % tp:  # a power of two dividing n_devices
            tp //= 2
        tp = max(tp, 1)
        return MeshSpec(fsdp=self.n_devices // tp, tp=tp)


def largest_pow2_dp(n_devices: int) -> int:
    return 1 << int(math.log2(max(n_devices, 1)))


def build_hybrid_mesh(ici_spec: MeshSpec, dcn_spec: MeshSpec, devices=None):
    raise NotImplementedError(f"multi-slice (hybrid) meshes are ported in {SLICE_5B}")


def hybrid_mesh_for_slices(n_slices: int, ici_spec: MeshSpec | None = None,
                           dcn_axis: str = "dp", devices=None):
    raise NotImplementedError(f"multi-slice (hybrid) meshes are ported in {SLICE_5B}")

