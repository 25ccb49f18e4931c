"""Live elastic resharding — counterpart of ``deeplearning_cfn_tpu/train/reshard.py``.

A slice dies; the trainer pauses at a step boundary (the ``reshard`` seam
of ``Trainer.fit``), moves its state onto the survivors and trains on, with
no restart.  The coordinator here:

1. takes the surviving topology (``ClusterContract.surviving``) from the
   coordinator rank, which the contract guarantees survives a live reshard,
2. re-forms the mesh from it (caller-supplied ``mesh_for``: a mesh over the
   survivors' ranks, ``parallel/mesh.py``),
3. recomputes each leaf's spec with the SAME rules ``Trainer.init`` used
   (explicit specs name for name, the FSDP rule re-inferred from the
   unchanged shapes, optimizer moments following their parameters),
4. migrates parameters and optimizer state — pure data movement, so the
   result is a fresh shard of the same values, byte for byte,
5. rescales grad accumulation so the global batch is kept while the
   per-device microbatch stays the same size, and
6. rebinds the trainer (``Trainer.rebind_mesh``) so the next step runs on
   the survivors, on the same batch iterator, with no step lost or repeated.

The JAX coordinator is one controller that sees every device; here every
rank is a process running its own ``fit``, so the port keeps the JAX
semantics with these mechanisms:

- One decision for all ranks: at each boundary the coordinator rank
  (process 0) pulls the debounced flush and broadcasts whether to pause,
  then the surviving contract, over a gloo group of the current ranks
  (:meth:`LiveReshardCoordinator.pending`).  Every rank pauses at the same
  boundary even when only process 0 saw the terminate events.
- The departing ranks are still there at the boundary (the terminate
  notice precedes the loss): they take part in the decision and hand over
  their shards where the survivors need them, then leave (``"leave"``).
  After the boundary nothing of the survivors' touches the default group:
  their mesh and groups are made among themselves
  (``use_local_synchronization``), and the old groups are left alone (a
  gloo teardown with peers gone may block).
- Migration: on a multi-slice mesh (dp over slices x fsdp within a slice)
  every surviving slice already holds a whole replica, each survivor's
  local shards are its shards on the new mesh, and no byte crosses a link;
  otherwise (a pure fsdp mesh shrinking) the ranks gather each sharded leaf
  over the old mesh, departing ranks included, and each survivor keeps its
  part.  The two modes are agreed over the old ranks before any byte moves.
- The optimizer state follows the new parameters: FSDP2 makes new parameter
  tensors on the new mesh, so the state is rebuilt at zeros on them and
  filled from the old state's global views (AdamW, LAMB, Adafactor's
  factored ``v_row``/``v_col``).  A state with no global view raises
  :class:`ReshardError`.

Failure in 2-4 (``ReshardError``, ``MeshError``, ``ValueError``, and
``force_fallback``) degrades to the checkpoint/restore path: the coordinator
journals ``reshard_fallback`` and returns ``"stop"``, and the caller
restores on the surviving mesh.  The catch is not widened: a CUDA, NCCL or
gloo error propagates.  Live migration keeps to the data axes (dp, fsdp); a
mesh split over pp, sp, tp or ep, and the bucketed sync's per-rank
residuals, take the fallback.

Growing the mesh (``arm_restore``, the scheduler's restore of a slice it
lent away) is where the JAX design cannot carry over: JAX re-meshes devices
inside one process, and ``torch.distributed`` cannot add a rank to a running
process group.  So a rank comes back only if it never left the group:

- The ranks of a slice that leaves *park* (the scheduler's preemption is a
  controlled loss): once ``fit`` returns ``"leave"`` they call
  :meth:`LiveReshardCoordinator.rejoin`, which writes a key on the process
  group's store and waits for a decision keyed to them.
- At the grow boundary the survivors publish the decision (step, contract,
  accumulation) on the store; every rank of the grown mesh first makes as
  many process groups as the busiest of them has made (the hashed names of
  groups made with ``use_local_synchronization`` count a process's groups),
  then they build the new mesh and a coordinator group together.
- The survivors send the state to the returning ranks: where every survivor
  already holds its shards of the grown mesh (a slice returns to a dp x
  fsdp mesh) each leaf is broadcast over the mesh's ``dp`` group from a
  survivor; otherwise each leaf is gathered on the survivors and broadcast
  whole from the coordinator rank.  The returning ranks are rebound and
  accumulation returns to its pre-shrink value (``symmetric_accum``).
- A slice whose processes are gone (a real death: they never call
  ``rejoin``) has no key on the store within ``PARK_WAIT_S`` of the grow:
  the grow takes the checkpoint fallback.

Timing comes from the injected ``clock`` (``time.monotonic`` by default, a
virtual clock in scenarios), never ``time.time()`` arithmetic.
"""

from __future__ import annotations

import datetime
import json
import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import torch
import torch.distributed as dist

from deeplearning_cfn_tpu_torch.obs.recorder import get_recorder
from deeplearning_cfn_tpu_torch.obs.tracing import span
from deeplearning_cfn_tpu_torch.parallel.mesh import MeshError, MeshSpec, mesh_spec
from deeplearning_cfn_tpu_torch.train.optimizers import host_whole, local_part
from deeplearning_cfn_tpu_torch.utils.logging import get_logger

log = get_logger("dlcfn.reshard")

#: Prefix of the keys the grow direction writes on the process group's store.
STORE_PREFIX = "dlcfn-reshard"
#: How long the survivors at a grow wait for a returning rank to park.  A
#: rank parks as ``fit`` hands it ``"leave"``, and the survivors train at
#: least one batch between the shrink and the grow: a rank not parked by
#: then is taken for gone.
PARK_WAIT_S = 5.0


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
    None for one device.  Used by the checkpoint envelope and ``status``."""
    if mesh is None:
        return {"devices": 1, "axes": {}}
    names = mesh.mesh_dim_names
    return {
        "devices": int(mesh.size()),
        "axes": {str(n): int(mesh.size(i)) for i, n in enumerate(names) if int(mesh.size(i)) > 1},
    }


def _devices(mesh: Any) -> int:
    return 1 if mesh is None else int(mesh.size())


@dataclass
class LeafSharding:
    """One leaf's layout on a mesh, as a JAX ``NamedSharding`` holds it: the
    mesh's axis sizes and a spec (one entry a dim: an axis name, a tuple of
    names, or None), with the leaf's global shape."""

    axis_sizes: dict[str, int]
    spec: tuple
    shape: tuple[int, ...] | None = None


@dataclass
class StateShardings:
    """The ``TrainState`` template on a mesh: each parameter's layout by
    name, each optimizer state tensor's by parameter name and key."""

    mesh: Any
    params: dict[str, LeafSharding]
    opt_state: dict[str, dict[str, LeafSharding]]


def state_shardings_for(trainer: Any, state: Any, mesh: Any) -> StateShardings:
    """Recompute the ``TrainState`` sharding template for a new mesh with
    the same rules ``Trainer.init`` applied to the old one: explicit param
    specs name for name, the FSDP rule re-inferred from the (unchanged)
    shapes, elementwise optimizer state on its parameter's spec, Adafactor's
    factored moments on the spec without the dim they reduce.  Raises
    :class:`ReshardError` for what live migration does not carry (module
    docstring)."""
    sizes = mesh_spec(mesh) if mesh is not None else MeshSpec()
    old = mesh_spec(trainer.mesh) if trainer.mesh is not None else MeshSpec()
    for axis in ("pp", "sp", "tp", "ep"):
        if getattr(sizes, axis) > 1 or getattr(old, axis) > 1:
            raise ReshardError(f"live migration keeps to the data axes; the mesh splits {axis} "
                               "(the checkpoint/restore path carries it)")
    if trainer.config.comms_overlap:
        raise ReshardError("the bucketed sync's error-feedback residuals are per data rank "
                           "(the checkpoint/restore path carries them)")
    axis_sizes = sizes.axis_sizes()
    model = state.model
    specs = trainer._specs(model, fsdp=sizes.fsdp)
    params, opt_state = {}, {}
    dims = getattr(state.optimizer, "_dims", None)
    for name, p in model.named_parameters():
        spec = tuple(specs[name])
        params[name] = LeafSharding(axis_sizes, spec, tuple(p.shape))
        leaves = {}
        for key, v in state.optimizer.state.get(p, {}).items():
            if not isinstance(v, torch.Tensor):
                continue
            if v.ndim == 0:
                leaves[key] = LeafSharding(axis_sizes, (), ())
            elif hasattr(v, "device_mesh") or v.shape == local_part(p).shape:
                leaves[key] = LeafSharding(axis_sizes, spec, tuple(p.shape))
            elif key in ("v_row", "v_col") and dims is not None and dims(p) is not None:
                d1, d0 = dims(p)
                gone = d0 if key == "v_row" else d1
                leaves[key] = LeafSharding(
                    axis_sizes, tuple(s for i, s in enumerate(spec) if i != gone),
                    tuple(n for i, n in enumerate(p.shape) if i != gone))
            else:
                raise ReshardError(f"no global view of the optimizer state {name}.{key} "
                                   f"(shape {tuple(v.shape)})")
        opt_state[name] = leaves
    return StateShardings(mesh=mesh, params=params, opt_state=opt_state)


def _leaves(tree: Any, path: str = "") -> dict[str, Any]:
    """Leaves of a nested dict (or ``StateShardings``) by key path."""
    if isinstance(tree, StateShardings):
        tree = {"params": tree.params, "opt_state": tree.opt_state}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{path}[{k!r}]"))
        return out
    return {path: tree}


def ensure_hostable(state: Any, shardings: Any) -> None:
    """Raise a typed :class:`ReshardError` (naming the leaf) when any
    sharded dimension does not divide by its mesh-axis product.  FSDP2 would
    pad such a dim; the port keeps the JAX package's rule, under which the
    state is not hostable live.  ``shardings`` is a :class:`StateShardings`
    (its leaves carry their global shapes) or a dict of
    :class:`LeafSharding` keyed as the dict ``state``."""
    shapes = {} if isinstance(shardings, StateShardings) else {
        k: tuple(getattr(x, "shape", ())) for k, x in _leaves(state).items()}
    for path, sh in _leaves(shardings).items():
        shape = sh.shape if sh.shape is not None else shapes[path]
        for dim, axes in enumerate(sh.spec):
            if axes is None:
                continue
            names = axes if isinstance(axes, tuple) else (axes,)
            n = math.prod(sh.axis_sizes[a] for a in names)
            if dim >= len(shape) or shape[dim] % n:
                raise ReshardError(
                    f"leaf {path} shape {tuple(shape)} dim {dim} not divisible "
                    f"by {n} on the target mesh"
                )


def _flat(sd: dict, path: str = "") -> dict[str, torch.Tensor]:
    out = {}
    for k, v in sd.items():
        key = f"{path}.{k}" if path else str(k)
        if isinstance(v, dict):
            out.update(_flat(v, key))
        elif isinstance(v, torch.Tensor):
            out[key] = v
    return out


def _region(t: torch.Tensor) -> tuple[slice, ...]:
    """The part of ``t``'s global tensor that this rank holds: all of a
    plain tensor, a DTensor's local shard."""
    if not hasattr(t, "device_mesh"):
        return tuple(slice(0, n) for n in t.shape)
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    shape, offset = compute_local_shape_and_global_offset(t.shape, t.device_mesh, t.placements)
    return tuple(slice(o, o + n) for o, n in zip(offset, shape))


def _agree(value: int, group: Any, op: Any = None) -> int:
    """The least ``value`` over the ranks of ``group`` (the greatest with
    ``op=ReduceOp.MAX``; this one's alone without a process group)."""
    if not dist.is_initialized():
        return value
    t = torch.tensor([value], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MIN if op is None else op, group=group)
    return int(t.item())


def _groups_made() -> int:
    """Process groups this process has registered (the default one too)."""
    return len(dist.distributed_c10d._world.pg_names)


def _pad_groups(count: int) -> None:
    """Make one-rank groups until this process has made ``count``.  A group
    made with ``use_local_synchronization`` is named by a hash of its ranks
    and of the count of groups its maker has made, so the ranks that meet in
    a new group must have made as many before."""
    me = dist.get_rank()
    while _groups_made() < count:
        dist.new_group([me], backend="gloo", use_local_synchronization=True)


def _layout(trainer: Any, state: Any, shardings: StateShardings) -> tuple[Any, dict]:
    """The trainer rebound to ``shardings.mesh`` and a ``TrainState`` of the
    same architecture laid out there (a model built on ``meta``, given
    storage on the trainer's device, its optimizer state at zero, the step
    count the old one's), with the trainer's old binding for
    :func:`_unbind`.  Raises :class:`ReshardError` when its leaves are not
    the old state's; on any failure the trainer is back on its old mesh."""
    kept = dict(vars(trainer))  # the old mesh, its groups, the layout's bookkeeping
    try:
        trainer.rebind_mesh(shardings.mesh)
        with torch.device("meta"):
            model = trainer.model_fn(None)
        new = trainer.init_from(model.to_empty(device=trainer.device))
        other = _flat(new.state_dict()).keys() ^ _flat(state.state_dict()).keys()
        if other:
            raise ReshardError(f"the state on the new mesh has other leaves: {sorted(other)}")
    except BaseException:
        _unbind(trainer, kept)
        raise
    new.step = state.step
    return new, kept


def _unbind(trainer: Any, kept: dict) -> None:
    """Put the trainer back on the binding :func:`_layout` replaced."""
    vars(trainer).clear()
    vars(trainer).update(kept)


@torch.no_grad()
def _move(state: Any, new: Any, group: Any) -> Any:
    """Copy every parameter, buffer and optimizer state tensor of ``state``
    into ``new`` (None on a rank that leaves) from the old state's global
    views.  The ranks of ``group`` first agree whether the survivors' local
    shards are already their new ones (whole slices left: nothing moves) or
    each sharded leaf is gathered on the host over the old mesh
    (:func:`host_whole`; departing ranks handing theirs over)."""
    old = _flat(state.state_dict())
    targets = _flat(new.state_dict()) if new is not None else {}
    local = 1 if new is None else int(all(_region(targets[k]) == _region(v)
                                          for k, v in old.items()))
    gather = not _agree(local, group)
    for key in sorted(old):
        src = old[key]
        if gather and hasattr(src, "device_mesh"):
            src = host_whole(src)
            region = tuple(slice(0, n) for n in src.shape)
        else:
            src, region = local_part(src), _region(src)
        if new is None:
            continue
        dst = targets[key]
        want = _region(dst)
        part = src[tuple(slice(w.start - r.start, w.stop - r.start)
                         for w, r in zip(want, region))]
        local_part(dst).copy_(part)
    return new


def migrate_state(trainer: Any, state: Any, shardings: StateShardings | None,
                  group: Any = None) -> Any:
    """Repartition the whole ``TrainState`` onto ``shardings.mesh``: the
    trainer is rebound to that mesh, a state of the same architecture laid
    out on it, then every parameter, buffer, optimizer state tensor and the
    step count copied in from the old state's global views.  Pure data
    movement: the result is byte for byte a fresh shard of the same values.

    Every rank of the old mesh calls this at the same boundary; a rank that
    leaves passes ``shardings=None`` and gets None.  ``group`` (a gloo group
    over the old mesh's ranks; the default group when None) is where the
    ranks agree how the bytes move (:func:`_move`)."""
    new = _layout(trainer, state, shardings)[0] if shardings is not None else None
    return _move(state, new, group)


@torch.no_grad()
def _broadcast_into(dst: torch.Tensor, src: int, group: Any) -> None:
    """``dist.broadcast`` into ``dst`` in place (through a contiguous copy
    when ``dst`` is a strided view)."""
    if dst.is_contiguous():
        dist.broadcast(dst, src=src, group=group)
        return
    buf = dst.contiguous()
    dist.broadcast(buf, src=src, group=group)
    dst.copy_(buf)


@torch.no_grad()
def _regrow(state: Any, new: Any, mesh: Any, group: Any, holders: list[int]) -> Any:
    """Fill ``new`` (a state laid out on the grown ``mesh``) on every rank of
    ``group``: a survivor passes its old ``state``, a returning rank None.
    The ranks agree on the mode first: when every survivor's shards on the
    grown mesh are its old ones and the mesh has a ``dp`` axis (a slice
    comes back to a dp x fsdp mesh), each leaf is copied in place on the
    survivors and broadcast over the ``dp`` group from its lowest survivor
    (``holders`` are the survivors' global ranks); otherwise every sharded
    leaf is gathered whole on the survivors' hosts (:func:`host_whole`)
    and broadcast from the first survivor over ``group``, each rank
    keeping its part."""
    targets = _flat(new.state_dict())
    old = _flat(state.state_dict()) if state is not None else None
    dp = mesh_spec(mesh).dp if mesh is not None else 1
    local = 1 if old is None else int(old.keys() == targets.keys() and all(
        _region(targets[k]) == _region(v) for k, v in old.items()))
    if _agree(int(local and dp > 1), group):
        line = mesh.get_group("dp")
        src = min((r for r in dist.get_process_group_ranks(line) if r in holders), default=None)
        if src is None:
            raise ReshardError("a dp group of the grown mesh holds no survivor")
        for key in sorted(targets):
            dst = local_part(targets[key])
            if old is not None:
                dst.copy_(local_part(old[key]))
            _broadcast_into(dst, src, line)
        return new
    for key in sorted(targets):
        dst = targets[key]
        if old is not None:
            whole = old[key]
            whole = host_whole(whole) if hasattr(whole, "device_mesh") else whole.detach().cpu()
            whole = whole.contiguous()
        else:
            whole = torch.empty(dst.shape, dtype=dst.dtype)
        dist.broadcast(whole, src=holders[0], group=group)
        local_part(dst).copy_(whole[_region(dst)])
    return new


def rescale_grad_accum(
    accum: int, old_devices: int, new_devices: int, *, symmetric: bool = False
) -> int:
    """Grad-accumulation count that preserves the global batch on a
    smaller mesh while keeping the per-device microbatch footprint no
    larger than before: the same global batch now lands on fewer devices,
    so each device sees ``old/new`` times more examples per step — split
    the step into proportionally more microbatches.  8→4 devices at
    accum=1 becomes accum=2.

    By default a grown mesh never *reduces* accum (that would change a
    tuning choice behind the caller's back).  ``symmetric=True`` is the
    scheduler's restore mode: growth inverts the shrink scaling exactly, so
    a preempt-then-restore round trip lands back on the original accum —
    8→4 takes 1 to 2, 4→8 takes 2 back to 1 — and only when the inversion
    is exact; a non-integral inverse keeps the current accum rather than
    perturb the global batch."""
    if new_devices <= 0:
        raise ReshardError("surviving mesh has no devices")
    if new_devices >= old_devices:
        if not symmetric or new_devices == old_devices:
            return accum
        scaled, rem = divmod(accum * old_devices, new_devices)
        if rem:
            return accum
        return max(1, scaled)
    return max(1, math.ceil(accum * old_devices / new_devices))


def survivor_ranks(origin: Any, contract: Any) -> list[int]:
    """The global ranks of ``contract``'s workers, numbered as at launch
    (``origin``): worker ``i`` of the launch contract runs ranks
    ``i * chips_per_worker .. (i + 1) * chips_per_worker - 1``."""
    index = {ip: i for i, ip in enumerate(origin.worker_ips)}
    cpw = origin.chips_per_worker
    missing = [ip for ip in contract.worker_ips if ip not in index]
    if missing:
        raise MeshError(f"workers {missing} were not in the launch contract")
    return sorted(index[ip] * cpw + c for ip in contract.worker_ips for c in range(cpw))


@dataclass
class ReshardRecord:
    """One pause-and-reshard episode, as journaled."""

    step: int
    mode: str  # "live" | "fallback"
    old_topology: dict
    new_topology: dict | None
    grad_accum_before: int
    grad_accum_after: int
    seconds: float
    reason: str | None = None


@dataclass
class LiveReshardCoordinator:
    """The pause/reshard orchestrator handed to ``Trainer.fit(reshard=...)``.

    ``pending()`` is polled at every step boundary on every rank: the
    coordinator rank pulls the debounced slice-loss flush (``flush``,
    typically ``controller.flush_slice_losses``; every rank runs its own
    flush, which runs its safe-point hooks) and broadcasts whether its
    manager armed, and the surviving contract.  ``execute(trainer, state,
    step)`` performs the live reshard and returns ``(new_state, "resume")``
    on a survivor and ``(state, "leave")`` on a rank that leaves — or, on
    ``force_fallback`` or any hosting failure, journals ``reshard_fallback``
    and returns ``(state, "stop")`` so the caller falls back to
    checkpoint/restore on ``fallback_contract``.  Structural impossibilities
    (the coordinator's own slice died, nothing survives) raise from
    ``pending()`` on every rank — there is no in-process path past those.

    ``origin`` is the launch contract (the manager's at construction), which
    numbers the ranks; ``group`` the gloo group the decision is broadcast
    over (made over every rank at the first boundary, over the survivors
    after a reshard); ``departed`` is set on a rank that left.

    A boundary that brings a slice back (``manager.arm_restore``) grows the
    mesh when that slice's ranks parked: they wait in :meth:`rejoin` and
    take part from there (module docstring); otherwise the grow takes the
    fallback.  :meth:`release` on the coordinator rank
    tells ranks still parked at the end of a run that no grow comes."""

    manager: Any  # cluster/recovery.LiveReshardManager (duck-typed)
    mesh_for: Callable[[Any], Any]  # surviving contract -> DeviceMesh
    flush: Callable[[], Any] | None = None
    clock: Callable[[], float] = time.monotonic
    force_fallback: bool = False
    records: list[ReshardRecord] = field(default_factory=list)
    fallback_pending: bool = False
    fallback_contract: Any = None
    #: called with the surviving contract right after every commit (live
    #: AND fallback) — the data plane's reshard seam: wire
    #: ``on_commit=plane.reshard`` and the record stream is re-partitioned
    #: over the survivors at the same step boundary the mesh is
    #: (train/datastream.DataStreamPlane).
    on_commit: Callable[[Any], Any] | None = None
    #: Scheduler mode (``sched/preempt.py``): grad-accum rescale inverts
    #: exactly on a grown mesh, so a preempt-then-restore round trip returns
    #: accum to its pre-preempt value (bit-safe restore).  Off by default — a
    #: plain slice-loss reshard keeps the conservative never-shrink-on-grow
    #: behavior.
    symmetric_accum: bool = False
    origin: Any = field(default=None, init=False)
    group: Any = field(default=None, init=False)
    departed: bool = field(default=False, init=False)
    _target: Any = field(default=None, init=False, repr=False)
    #: global rank -> how many times it left (names its store keys)
    _departures: dict = field(default_factory=dict, init=False, repr=False)
    #: set by ``rejoin``: the survivors took the boundary it returns at
    _rejoined: bool = field(default=False, init=False, repr=False)
    #: this coordinator's namespace on the store (its first group's name)
    _space: str = field(default="", init=False, repr=False)

    def __post_init__(self) -> None:
        self.origin = self.manager.contract

    @property
    def live_total(self) -> int:
        return sum(1 for r in self.records if r.mode == "live")

    @property
    def fallback_total(self) -> int:
        return sum(1 for r in self.records if r.mode == "fallback")

    @property
    def seconds_total(self) -> float:
        return sum(r.seconds for r in self.records)

    def pending(self) -> bool:
        if self.fallback_pending or self.departed:
            return False
        if self._rejoined:
            # This rank came back at a boundary whose decision the
            # survivors had taken: it trains that batch with them.
            self._rejoined = False
            return False
        if self.flush is not None:
            self.flush()
        if not dist.is_initialized():
            return bool(self.manager.needs_reshard)
        if self.group is None:
            self.group = dist.new_group(backend="gloo")
            self._space = self.group.group_name  # one name on every rank, a coordinator
        lead = dist.get_rank(self.group) == 0
        src = dist.get_global_rank(self.group, 0)
        # 0: train on; 1: pause (the contract follows); 2: impossible.
        flag = torch.zeros(1, dtype=torch.int64)
        error = target = None
        if lead and self.manager.needs_reshard:
            try:
                target = self.manager.surviving_contract()
                flag[0] = 1
            except ValueError as exc:
                error, flag[0] = exc, 2
        dist.broadcast(flag, src=src, group=self.group)
        if flag.item() == 0:
            return False
        if flag.item() == 2:
            raise error if error is not None else ValueError(
                "the coordinator rank found the live reshard impossible (see its log)")
        payload = [target.to_message() if lead else None]
        dist.broadcast_object_list(payload, src=src, group=self.group)
        self._target = type(self.manager.contract).from_message(payload[0])
        return True

    def _journal_fallback(self, step, old_topology, old_accum, seconds, reason, contract):
        self.fallback_pending = True
        self.fallback_contract = contract
        self.manager.commit(contract)
        if self.on_commit is not None:
            self.on_commit(contract)
        record = ReshardRecord(step=step, mode="fallback", old_topology=old_topology,
                               new_topology=None, grad_accum_before=old_accum,
                               grad_accum_after=old_accum, seconds=seconds, reason=reason)
        self.records.append(record)
        get_recorder().record("reshard_fallback", step=step, reason=reason, seconds=seconds)
        log.warning("live reshard at step %d failed (%s); degrading to the "
                    "checkpoint/restore path", step, reason)

    def execute(self, trainer: Any, state: Any, step: int):
        t0 = self.clock()
        old_topology = mesh_topology(trainer.mesh)
        old_devices = _devices(trainer.mesh)
        old_accum = int(trainer.config.grad_accum_steps)
        contract = self._target if self._target is not None else self.manager.surviving_contract()
        self._target = None
        if set(contract.worker_ips) - set(self.manager.contract.worker_ips):
            return self._grow(trainer, state, step, contract, t0)
        leaving = False
        if dist.is_initialized():
            ranks = survivor_ranks(self.origin, contract)
            leaving = dist.get_rank() not in ranks
            for r in survivor_ranks(self.origin, self.manager.contract):
                if r not in ranks:
                    self._departures[r] = self._departures.get(r, 0) + 1
        reason = None
        new_mesh = target = kept = None
        new_accum = old_accum
        if not leaving:
            # What can fail is done before the agreement, the trainer
            # rebound only once the new state is laid out.  It runs alike on
            # every survivor (the same contract, the same state), so the
            # collectives among them in it (the new groups, DDP's broadcast)
            # meet.
            try:
                if self.force_fallback:
                    raise ReshardError("forced fallback (chaos injection)")
                new_mesh = self.mesh_for(contract)
                shardings = state_shardings_for(trainer, state, new_mesh)
                ensure_hostable(state, shardings)
                new_accum = rescale_grad_accum(old_accum, old_devices, _devices(new_mesh),
                                               symmetric=self.symmetric_accum)
                target, kept = _layout(trainer, state, shardings)
            except (ReshardError, MeshError, ValueError) as exc:
                reason = str(exc)
        # Every rank of the old mesh learns whether the survivors go live.
        if not _agree(int(reason is None), self.group):
            if target is not None:  # another survivor failed: back on the old mesh
                _unbind(trainer, kept)
            if leaving:
                self.departed = True
                self.manager.commit(contract)
                return state, "leave"
            # Graceful degradation: the surviving topology is real even
            # though the live path failed — commit it, stop the episode,
            # and let the caller restore from checkpoint onto
            # ``fallback_contract`` (the tier this path replaced).
            self._journal_fallback(step, old_topology, old_accum, self.clock() - t0,
                                   reason or "a survivor cannot host the state live",
                                   contract)
            return state, "stop"
        with span("reshard", step=step):
            new_state = _move(state, target, self.group)
        self.manager.commit(contract)
        if leaving:
            self.departed = True
            return state, "leave"
        trainer.config.grad_accum_steps = new_accum
        if dist.is_initialized():
            self.group = dist.new_group(ranks, backend="gloo", use_local_synchronization=True)
        if self.on_commit is not None:
            self.on_commit(contract)
        self._journal_live(step, old_topology, mesh_topology(new_mesh), old_accum, new_accum,
                           self.clock() - t0)
        return new_state, "resume"

    def _journal_live(self, step, old_topology, new_topology, old_accum, new_accum, seconds):
        record = ReshardRecord(
            step=step,
            mode="live",
            old_topology=old_topology,
            new_topology=new_topology,
            grad_accum_before=old_accum,
            grad_accum_after=new_accum,
            seconds=seconds,
        )
        self.records.append(record)
        get_recorder().record(
            "reshard",
            step=step,
            old_topology=old_topology,
            new_topology=new_topology,
            grad_accum_before=old_accum,
            grad_accum_after=new_accum,
            seconds=seconds,
        )
        if new_accum != old_accum:
            get_recorder().record(
                "grad_accum_rescaled",
                step=step,
                before=old_accum,
                after=new_accum,
                global_batch_preserved=True,
            )
        log.warning(
            "live reshard at step %d: %s -> %s (grad_accum %d -> %d)",
            step,
            old_topology,
            new_topology,
            old_accum,
            new_accum,
        )

    # --- the grow direction -------------------------------------------------

    def _key(self, what: str, rank: int) -> str:
        """The store key of ``rank``'s current parking: ``parked`` (written
        by the rank as it parks) or ``rejoin`` (the decision it waits for)."""
        return f"{STORE_PREFIX}/{self._space}/{what}/{rank}/{self._departures.get(rank, 0)}"

    def _grow(self, trainer: Any, state: Any, step: int, contract: Any, t0: float):
        """A survivor at a boundary that brings ranks back: the decision on
        the store for the parked ranks, then :meth:`_join` with them; the
        fallback when they are not parked."""
        old_topology = mesh_topology(trainer.mesh)
        old_accum = int(trainer.config.grad_accum_steps)
        reason = None
        current = ranks = joining = []
        if not dist.is_initialized():
            reason = "growing a mesh needs the returning ranks in a process group"
        else:
            current = survivor_ranks(self.origin, self.manager.contract)
            ranks = survivor_ranks(self.origin, contract)
            joining = [r for r in ranks if r not in current]
            if self.force_fallback:
                reason = "forced fallback (chaos injection)"
            elif set(current) - set(ranks):
                reason = "a boundary that both loses and regains ranks is not taken live"
            elif not _parked([self._key("parked", r) for r in joining]):
                reason = (f"ranks {joining} of the returning slice are not parked in the "
                          "process group (their processes are gone)")
        if not _agree(int(reason is None), self.group):
            self._journal_fallback(step, old_topology, old_accum, self.clock() - t0,
                                   reason or "another survivor cannot take the grow live",
                                   contract)
            return state, "stop"
        store = _store()
        groups = _agree(_groups_made(), self.group, dist.ReduceOp.MAX)
        for r in joining:
            groups = max(groups, json.loads(store.get(self._key("parked", r)))["groups"])
        decision = {"step": step, "contract": contract.to_message(), "groups": groups,
                    "holders": current, "old_topology": old_topology, "old_accum": old_accum,
                    "accum": rescale_grad_accum(old_accum, _devices(trainer.mesh), len(ranks),
                                                symmetric=self.symmetric_accum)}
        if dist.get_rank(self.group) == 0:
            for r in joining:
                store.set(self._key("rejoin", r), json.dumps(decision))
        return self._join(trainer, state, decision, t0), "resume"

    def _join(self, trainer: Any, state: Any, decision: dict, t0: float) -> Any:
        """Every rank of the grown mesh, survivors and returning ranks alike:
        the same groups in the same order (padded to one count, the mesh's,
        the coordinator's), the state laid out on the grown mesh and filled
        by :func:`_regrow`, the trainer rebound."""
        contract = type(self.manager.contract).from_message(decision["contract"])
        ranks = survivor_ranks(self.origin, contract)
        holders = decision["holders"]
        _pad_groups(decision["groups"])
        new_mesh = self.mesh_for(contract)
        shardings = state_shardings_for(trainer, state, new_mesh)
        target, _ = _layout(trainer, state, shardings)
        self.group = dist.new_group(ranks, backend="gloo", use_local_synchronization=True)
        with span("reshard", step=decision["step"]):
            new_state = _regrow(state if dist.get_rank() in holders else None, target,
                                new_mesh, self.group, holders)
        new_state.step = decision["step"]
        trainer.config.grad_accum_steps = decision["accum"]
        self.manager.commit(contract)
        if self.on_commit is not None:
            self.on_commit(contract)
        self._journal_live(decision["step"], decision["old_topology"], mesh_topology(new_mesh),
                           decision["old_accum"], decision["accum"], self.clock() - t0)
        return new_state

    def rejoin(self, trainer: Any, state: Any, timeout_s: float = 3600.0) -> Any:
        """Park a rank whose slice left (``fit`` returned ``"leave"``): wait
        for the survivors' grow decision and take part in it.  Returns the state on the grown mesh, at the step the survivors
        paused at — train on from that batch, with this coordinator: the
        survivors train it on the grown mesh, and this rank's first
        ``pending()`` is the one they already took — or None when the
        coordinator rank released it (:meth:`release`).  ``trainer`` and
        ``state`` are the rank's from before it left: the state names the
        leaves to lay out, the trainer is rebound to the grown mesh."""
        if not (self.departed and dist.is_initialized()):
            raise ValueError("rejoin is for a rank of a process group whose slice left")
        store = _store()
        store.set(self._key("parked", dist.get_rank()), json.dumps({"groups": _groups_made()}))
        key = self._key("rejoin", dist.get_rank())
        store.wait([key], datetime.timedelta(seconds=timeout_s))
        decision = json.loads(store.get(key))
        if decision.get("release"):
            return None
        t0 = self.clock()
        self.departed = False
        self._rejoined = True
        return self._join(trainer, state, decision, t0)

    def release(self) -> None:
        """On the coordinator rank when its run is over: every rank still
        parked, or parking later, returns None from :meth:`rejoin`."""
        if not dist.is_initialized() or dist.get_rank(self.group) != 0:
            return
        store = _store()
        current = set(survivor_ranks(self.origin, self.manager.contract))
        for r in sorted(self._departures):
            if r not in current and not store.check([self._key("rejoin", r)]):
                store.set(self._key("rejoin", r), json.dumps({"release": True}))


def _store() -> Any:
    """The store of the default process group (where ranks rendezvoused)."""
    return dist.distributed_c10d._get_default_store()


def _parked(keys: list[str]) -> bool:
    """Whether every key is on the store within ``PARK_WAIT_S``."""
    try:
        _store().wait(keys, datetime.timedelta(seconds=PARK_WAIT_S))
    except dist.DistStoreError:
        return False
    return True
