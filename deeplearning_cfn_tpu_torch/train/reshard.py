"""Resharding — the part of ``deeplearning_cfn_tpu/train/reshard.py`` that the
checkpoint envelope needs: :func:`mesh_topology` and :class:`ReshardError`.

Restoring onto another mesh is the slow path: checkpoint, then restore on
the new mesh (``train/checkpoint.Checkpointer`` reshards through
``torch.distributed.checkpoint``).  The live path — the
``LiveReshardCoordinator`` that the cluster plane drives at a step boundary,
with ``state_shardings_for``, ``ensure_hostable``, ``migrate_state`` and
``rescale_grad_accum`` — comes with that plane in slice 7 and raises
``NotImplementedError`` here.
"""

from __future__ import annotations

from typing import Any

SLICE_7 = ("a later slice of the PyTorch port (slice 7: the cluster plane that drives "
           "a live reshard)")


class ReshardError(RuntimeError):
    """The surviving mesh cannot host the state live (indivisible shapes,
    unmappable explicit specs, ...) — the coordinator degrades to the
    checkpoint/restore fallback instead of crashing mid-step."""


def mesh_topology(mesh: Any) -> dict:
    """Canonical JSON-safe topology descriptor: device count plus the
    non-trivial axis sizes, in the mesh's axis order.  Size-1 axes are
    dropped so a ``dp=1,fsdp=4`` mesh and a pure ``fsdp=4`` mesh over the
    same devices compare equal — they host identical shardings.  ``mesh``
    is a ``DeviceMesh`` with named dims (``parallel/mesh.build_mesh``), or
    None for one device.  Used by the checkpoint envelope."""
    if mesh is None:
        return {"devices": 1, "axes": {}}
    names = mesh.mesh_dim_names
    return {
        "devices": int(mesh.size()),
        "axes": {str(n): int(mesh.size(i)) for i, n in enumerate(names) if int(mesh.size(i)) > 1},
    }


def _live(name: str):
    def unported(*args, **kwargs):
        raise NotImplementedError(f"{name} (live reshard) is ported in {SLICE_7}")

    unported.__name__ = name
    return unported


state_shardings_for = _live("state_shardings_for")
ensure_hostable = _live("ensure_hostable")
migrate_state = _live("migrate_state")
rescale_grad_accum = _live("rescale_grad_accum")
LiveReshardCoordinator = _live("LiveReshardCoordinator")
