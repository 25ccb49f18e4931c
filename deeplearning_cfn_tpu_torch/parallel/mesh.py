"""Device meshes — counterpart of ``deeplearning_cfn_tpu/parallel/mesh.py``.

The same six named axes, outermost to innermost: ``dp`` (data parallel,
replicated parameters), ``fsdp`` (data parallel with sharded parameters and
optimizer state), ``pp``, ``sp``, ``tp`` and ``ep`` (experts).  A mesh is a
``torch.distributed`` ``DeviceMesh`` over the ranks of the default process
group, one rank a device; axes of size 1 are kept, as the JAX mesh keeps
them, so every sharding rule reads the same six names whatever the layout.

``tp`` and ``sp`` may be larger than 1 (``parallel/tensor_parallel.py``,
``parallel/ring_attention.py``), and so may ``pp`` (``parallel/pipeline.py``:
each rank along it holds one stage of the layers).

A multi-slice mesh (:func:`build_hybrid_mesh`) is a ``DeviceMesh`` over an
explicit grid of ranks.  On an H100 cluster a "slice" is one NVLink node and
DCN is the network between the nodes; a node's ranks are consecutive in the
cluster contract's order (``DLCFN_PROCESS_ID``), the grouping JAX's
process-granule branch assumes.  Each combined axis is ``dcn x ici`` with the
DCN part varying slowest, as the JAX package lays devices out.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXIS_ORDER = ("dp", "fsdp", "pp", "sp", "tp", "ep")

# What the parallelism slices have not ported yet (ROADMAP queue 1).
LATER_PARALLELISM = "a later slice of the PyTorch port (ROADMAP queue 1)"


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
    and ``cpu`` otherwise."""
    _require_initialised("build_mesh")
    spec.validate(dist.get_world_size())
    return init_device_mesh(_device_type(device_type),
                            tuple(spec.axis_sizes()[a] for a in AXIS_ORDER),
                            mesh_dim_names=AXIS_ORDER)


def _require_initialised(what: str) -> None:
    if not dist.is_initialized():
        raise MeshError(f"{what} needs torch.distributed initialised "
                        "(examples.common.maybe_init_distributed, or init_process_group)")


def _device_type(device_type: str | None) -> str:
    if device_type is not None:
        return device_type
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


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


def data_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """The 1-D mesh of :func:`data_group`'s ranks, ``dp`` major."""
    sizes = mesh_spec(mesh)
    if sizes.fsdp == 1:
        return mesh["dp"]
    if sizes.dp == 1:
        return mesh["fsdp"]
    return mesh["dp", "fsdp"]._flatten()


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


def hybrid_rank_grid(ici_spec: MeshSpec, dcn_spec: MeshSpec, n_ranks: int) -> np.ndarray:
    """The ranks ``0 .. n_ranks-1`` laid out over ``AXIS_ORDER`` as
    :func:`build_hybrid_mesh` lays them: each DCN granule (node) a block of
    consecutive ranks, each axis ``dcn x ici`` with the DCN part slowest."""
    for axis in ("sp", "tp", "ep"):
        if dcn_spec.axis_sizes()[axis] > 1:
            raise MeshError(
                f"axis {axis!r} exchanges activations every layer and "
                "cannot span DCN; put it in the ICI spec"
            )
    for name, spec in (("ici", ici_spec), ("dcn", dcn_spec)):
        for axis, size in spec.axis_sizes().items():
            if size < 1:
                raise MeshError(f"{name} axis {axis} must be >= 1, got {size}")
    MeshSpec(**{a: ici_spec.axis_sizes()[a] * dcn_spec.axis_sizes()[a]
                for a in AXIS_ORDER}).validate(n_ranks)
    ici_shape = [ici_spec.axis_sizes()[a] for a in AXIS_ORDER]
    dcn_shape = [dcn_spec.axis_sizes()[a] for a in AXIS_ORDER]
    n_axes = len(AXIS_ORDER)
    grid = np.arange(n_ranks).reshape(*dcn_shape, *ici_shape)
    order = [i + off for i in range(n_axes) for off in (0, n_axes)]
    return grid.transpose(order).reshape(*(d * i for d, i in zip(dcn_shape, ici_shape)))


def build_hybrid_mesh(ici_spec: MeshSpec, dcn_spec: MeshSpec,
                      device_type: str | None = None) -> DeviceMesh:
    """Multi-slice mesh: ICI axes within a node x DCN axes across nodes.

    Only axes that communicate once a step or between stages (dp, fsdp,
    pp) may span DCN; tp, sp and ep exchange activations inside every layer
    and are refused there.  Per axis, size = dcn x ici with the DCN part
    varying slowest: ici ``fsdp=4`` x dcn ``dp=2`` shards within each node
    and replicates across the two (:func:`hybrid_rank_grid`)."""
    _require_initialised("build_hybrid_mesh")
    grid = hybrid_rank_grid(ici_spec, dcn_spec, dist.get_world_size())
    return DeviceMesh(_device_type(device_type), torch.from_numpy(grid),
                      mesh_dim_names=AXIS_ORDER)


def hybrid_mesh_for_slices(n_slices: int, ici_spec: MeshSpec | None = None,
                           dcn_axis: str = "dp", device_type: str | None = None) -> DeviceMesh:
    """Mesh for an ``n_slices`` cluster straight from the contract's
    topology (``DEEPLEARNING_SLICES_COUNT``): ICI axes within each node
    (default: data parallel over its ranks), one DCN axis of size
    ``n_slices`` across them."""
    _require_initialised("hybrid_mesh_for_slices")
    n = dist.get_world_size()
    if n_slices <= 1:
        return build_mesh(ici_spec or MeshSpec.data_parallel(n), device_type)
    return build_hybrid_mesh(*slice_specs(n, n_slices, ici_spec, dcn_axis), device_type)


def slice_specs(n_ranks: int, n_slices: int, ici_spec: MeshSpec | None = None,
                dcn_axis: str = "dp") -> tuple[MeshSpec, MeshSpec]:
    """``(ici, dcn)`` of :func:`hybrid_mesh_for_slices` for ``n_ranks``
    ranks in ``n_slices`` nodes."""
    if n_ranks % n_slices:
        raise MeshError(f"{n_ranks} devices do not divide into {n_slices} slices")
    ici = ici_spec or MeshSpec.data_parallel(n_ranks // n_slices)
    if dcn_axis not in AXIS_ORDER:
        raise MeshError(f"unknown dcn axis {dcn_axis!r}")
    return ici, MeshSpec(**{dcn_axis: n_slices})
