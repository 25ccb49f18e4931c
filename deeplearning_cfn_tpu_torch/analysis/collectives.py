"""The DLC5xx comms/memory discipline rules (gated: ``dlcfn lint --comms``).

The JAX package's DLC5xx find the source shapes that make accidental
collectives and memory pressure under GSPMD.  The port places tensors
itself, with DTensor, FSDP2 and the process groups of a ``DeviceMesh``,
so each rule keeps its id, name and gate and anchors on the same class
of accidental collective in that idiom:

DLC500 placement drift / in-out mismatch   DLC503 one graph, two meshes
DLC501 unplaced DTensor matmul chain        DLC504 unsummed to_local reduce
DLC502 host read of a gathered DTensor      DLC505 tensor read after
                                                   donate_buffers freed it

Scope: everywhere placements are authored or consumed — ``train/``,
``parallel/``, ``models/``, ``ops/``, ``serve/``.

The static half is paired with a dynamic comms-audit sentinel
(analysis/comms_audit.py) that runs the real train and serve programs on
gloo ranks and counts the collectives the profiler saw; its findings use
the reserved ids DLC510 (comms-budget regression), DLC511 (an all-gather
FSDP2's parameter groups do not predict) and DLC512 (the bucketed sync
hides nothing its monolithic twin does not), so all halves share one
baseline ratchet (analysis/lint_baseline.json).
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Iterator

from deeplearning_cfn_tpu_torch.analysis.core import (
    FileContext,
    Rule,
    Violation,
    call_name,
    dotted_name,
    keyword,
    register,
    walk_skipping_nested_functions,
)
from deeplearning_cfn_tpu_torch.analysis.sharding import (
    _FnDef,
    canonical_mesh_axes,
)

GATE = "comms"
RULE_IDS = ("DLC500", "DLC501", "DLC502", "DLC503", "DLC504", "DLC505")

# Reserved for the dynamic comms-audit sentinel (analysis/comms_audit.py).
AUDIT_RULE_BUDGET = "DLC510"
AUDIT_RULE_UNPREDICTED = "DLC511"
AUDIT_RULE_OVERLAP = "DLC512"
AUDIT_RULE_IDS = (
    AUDIT_RULE_BUDGET,
    AUDIT_RULE_UNPREDICTED,
    AUDIT_RULE_OVERLAP,
)

_COMMS_DIRS = ("train", "parallel", "models", "ops", "serve")


def _applies_comms_paths(path: Path) -> bool:
    return path.name == "bench.py" or any(d in path.parts for d in _COMMS_DIRS)


def _scopes(tree: ast.Module) -> Iterator[_FnDef]:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def _terminal(node: ast.Call) -> str:
    return (call_name(node) or "").rsplit(".", 1)[-1] or (
        node.func.attr if isinstance(node.func, ast.Attribute) else ""
    )


# --- DLC500: placement drift / in-out mismatch --------------------------------
# A placement names a mesh dimension (through the mesh it is given) and a
# tensor dim (Shard(d)).  Two drifts make a collective no line shows: a
# placement over a mesh dimension the topology does not have (the layout
# fails on the cluster), and a local_map / parallel style whose input and
# output placements disagree on the sharded dims (DTensor redistributes at
# the boundary on every call: an all-gather or an all-to-all).

_PLACING_CALLS = (
    "distribute_tensor",
    "from_local",
    "fully_shard",
    "redistribute",
    "local_map",
    "distribute_module",
    "parallelize_module",
)
_INOUT_KWARGS = (
    ("in_placements", "out_placements"),
    ("input_layouts", "output_layouts"),
)


def _shard_dims(node: ast.AST) -> set[int | str]:
    """The tensor dims ``Shard(d)`` names under ``node`` ("partial" for Partial)."""
    out: set[int | str] = set()
    for n in ast.walk(node):
        if not isinstance(n, ast.Call):
            continue
        t = (call_name(n) or "").rsplit(".", 1)[-1]
        if t == "Shard" and n.args and isinstance(n.args[0], ast.Constant):
            out.add(n.args[0].value)
        elif t == "Partial":
            out.add("partial")
    return out


def _literal_placements(node: ast.AST) -> bool:
    return any(
        isinstance(n, ast.Call)
        and (call_name(n) or "").rsplit(".", 1)[-1] in ("Shard", "Replicate", "Partial")
        for n in ast.walk(node)
    )


def _check_inout_placement_consistency(
    tree: ast.Module, ctx: FileContext
) -> Iterator[Violation]:
    try:
        canonical = set(canonical_mesh_axes())
    except (OSError, ValueError, SyntaxError):
        canonical = None  # DLC403 owns reporting extraction failure
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        if canonical is not None and _terminal(node) in _PLACING_CALLS:
            meshes = list(node.args[1:2]) + [
                kw.value for kw in node.keywords if kw.arg in ("mesh", "device_mesh")
            ]
            for mesh in meshes:
                if not isinstance(mesh, ast.Subscript):
                    continue
                for const in ast.walk(mesh.slice):
                    if (
                        isinstance(const, ast.Constant)
                        and isinstance(const.value, str)
                        and const.value not in canonical
                    ):
                        shown = "/".join(sorted(canonical))
                        yield ctx.violation(
                            "DLC500",
                            const,
                            f"axis {const.value!r} in the mesh of a "
                            f"{_terminal(node)}() placement does not resolve "
                            f"against the mesh axes ({shown}) machine-read "
                            "from parallel/mesh.py AXIS_ORDER: that side of "
                            "the layout contract fails on the cluster",
                        )
        for kin, kout in _INOUT_KWARGS:
            kw_in, kw_out = keyword(node, kin), keyword(node, kout)
            if kw_in is None or kw_out is None:
                continue
            if not _literal_placements(kw_in.value) or not _literal_placements(kw_out.value):
                continue
            dims_in, dims_out = _shard_dims(kw_in.value), _shard_dims(kw_out.value)
            for missing in sorted(dims_in - dims_out, key=str):
                yield ctx.violation(
                    "DLC500",
                    kw_out.value,
                    f"dim {missing!r} is sharded by {kin} but not by this "
                    f"literal {kout}: DTensor all-gathers it at the boundary "
                    "on every call; carry the placement through (or spell "
                    "the redistribute explicitly)",
                )
            for extra in sorted(dims_out - dims_in, key=str):
                yield ctx.violation(
                    "DLC500",
                    kw_out.value,
                    f"dim {extra!r} appears only in {kout} of this in/out "
                    "pair: the output is resharded onto a dim the inputs "
                    "never occupied — a per-call all-to-all no line of user "
                    "code shows; shard the inputs to match",
                )


register(
    Rule(
        id="DLC500",
        name="pjit-inout-spec-consistency",
        doc="DTensor placements must use known mesh axes and agree in/out",
        check=_check_inout_placement_consistency,
        applies=_applies_comms_paths,
        gate=GATE,
    )
)

# --- DLC501: unplaced DTensor matmul chain ------------------------------------
# Under tp, a DTensor matmul whose output feeds another matmul with no
# explicit placement between lets DTensor's propagation pick the layout —
# and where the two operands' placements disagree it picks Replicate: the
# accidental all-gather of the largest activation.  Scope: functions that
# handle DTensors themselves (they place, redistribute, or take locals).

_DTENSOR_MARKERS = (
    "distribute_tensor",
    "from_local",
    "redistribute",
    "to_local",
    "full_tensor",
    "Shard",
    "Replicate",
)
_PLACEMENT_CALLS = ("redistribute", "from_local", "to_local", "distribute_tensor")
_MATMUL_CALLS = ("torch.matmul", "torch.mm", "torch.bmm", "torch.einsum", "F.linear",
                 "torch.nn.functional.linear", "scaled_dot_product_attention",
                 "F.scaled_dot_product_attention")


def _is_matmul_expr(node: ast.AST) -> bool:
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult):
        return True
    if isinstance(node, ast.Call):
        name = call_name(node) or ""
        return name in _MATMUL_CALLS or name.rsplit(".", 1)[-1] in ("matmul", "einsum")
    return False


def _handles_dtensors(fn: _FnDef) -> bool:
    for n in walk_skipping_nested_functions(fn.body):
        if isinstance(n, ast.Call) and _terminal(n) in _DTENSOR_MARKERS:
            return True
    return False


def _operands(node: ast.AST) -> list[ast.AST]:
    if isinstance(node, ast.BinOp):
        return [node.left, node.right]
    return list(getattr(node, "args", []))


def _check_unplaced_matmul_chain(tree: ast.Module, ctx: FileContext) -> Iterator[Violation]:
    for fn in _scopes(tree):
        if not _handles_dtensors(fn):
            continue
        statements = list(walk_skipping_nested_functions(fn.body))
        for node in statements:
            if not _is_matmul_expr(node):
                continue
            for operand in _operands(node):
                if _is_matmul_expr(operand):
                    yield ctx.violation(
                        "DLC501",
                        operand,
                        f"DTensor matmul output feeds another matmul directly "
                        f"in {fn.name}() with no placement on the intermediate: "
                        "propagation resolves a placement conflict to "
                        "Replicate — the accidental all-gather of the largest "
                        "activation; name the intermediate and redistribute it",
                    )
        produced: dict[str, list[int]] = {}
        killed: dict[str, list[int]] = {}
        for stmt in statements:
            if not isinstance(stmt, ast.Assign) or len(stmt.targets) != 1:
                continue
            target = stmt.targets[0]
            if not isinstance(target, ast.Name):
                continue
            if _is_matmul_expr(stmt.value):
                produced.setdefault(target.id, []).append(stmt.lineno)
            else:
                killed.setdefault(target.id, []).append(stmt.lineno)
        placed_lines: dict[str, list[int]] = {}
        for n in statements:
            if isinstance(n, ast.Call) and _terminal(n) in _PLACEMENT_CALLS:
                for sub in [getattr(n.func, "value", None), *n.args]:
                    if isinstance(sub, ast.Name):
                        placed_lines.setdefault(sub.id, []).append(n.lineno)
        if not produced:
            continue
        for node in statements:
            if not _is_matmul_expr(node):
                continue
            for op in _operands(node):
                if not (isinstance(op, ast.Name) and op.id in produced):
                    continue
                use_line = getattr(node, "lineno", 0)
                producer_line = max(
                    (ln for ln in produced[op.id] if ln < use_line), default=None
                )
                if producer_line is None or any(
                    producer_line < ln < use_line for ln in killed.get(op.id, ())
                ) or any(
                    producer_line <= ln <= use_line for ln in placed_lines.get(op.id, ())
                ):
                    continue
                yield ctx.violation(
                    "DLC501",
                    node,
                    f"DTensor matmul output {op.id!r} feeds another matmul in "
                    f"{fn.name}() with no placement between producer and "
                    "consumer: propagation resolves a placement conflict to "
                    "Replicate — the accidental all-gather shape; redistribute "
                    "the intermediate explicitly",
                )
                break


register(
    Rule(
        id="DLC501",
        name="unconstrained-large-intermediate",
        doc="DTensor matmul chains need an explicit placement between them",
        check=_check_unplaced_matmul_chain,
        applies=_applies_comms_paths,
        gate=GATE,
    )
)

# --- DLC502: host read of a gathered DTensor -----------------------------------
# `x.full_tensor()` (or a redistribute to all-Replicate) materializes the
# whole global tensor on every rank — an all-gather over the mesh, staged
# through the host under gloo — and reading it back on this rank (a slice
# of the whole, .cpu(), .item(), np.asarray) then holds the full tensor
# where a part would do.  The removed `train/reshard.py` `_move` did
# exactly this (`src = src.full_tensor()` then a slice) and the gather
# killed the process over gloo.

_HOST_READ_CALLS = ("np.asarray", "numpy.asarray", "np.array", "numpy.array", "torch.save")
_HOST_READ_METHODS = ("cpu", "item", "tolist", "numpy")


def _gathers_whole(node: ast.AST) -> str | None:
    if not isinstance(node, ast.Call) or not isinstance(node.func, ast.Attribute):
        return None
    if node.func.attr == "full_tensor":
        return ".full_tensor()"
    if node.func.attr == "redistribute":
        places = list(node.args[1:2]) + [
            kw.value for kw in node.keywords if kw.arg == "placements"
        ]
        for p in places:
            calls = [
                (call_name(n) or "").rsplit(".", 1)[-1]
                for n in ast.walk(p)
                if isinstance(n, ast.Call)
            ]
            if calls and all(c == "Replicate" for c in calls):
                return ".redistribute(..., Replicate())"
    return None


def _host_read_of(node: ast.AST, ctx: FileContext) -> str | None:
    """How ``node`` (a gathered value) is read on this rank, or None."""
    parent = ctx.parents.get(node)
    if isinstance(parent, ast.Subscript) and parent.value is node:
        return "a slice of it"
    if (
        isinstance(parent, ast.Attribute)
        and parent.value is node
        and parent.attr in _HOST_READ_METHODS
        and isinstance(ctx.parents.get(parent), ast.Call)
    ):
        return f".{parent.attr}()"
    if isinstance(parent, ast.Call) and node in parent.args and (
        call_name(parent) in _HOST_READ_CALLS
    ):
        return f"{call_name(parent)}()"
    return None


def _check_gathered_host_read(tree: ast.Module, ctx: FileContext) -> Iterator[Violation]:
    for fn in _scopes(tree):
        gathered: dict[str, tuple[int, str]] = {}
        for stmt in walk_skipping_nested_functions(fn.body):
            if (
                isinstance(stmt, ast.Assign)
                and len(stmt.targets) == 1
                and isinstance(stmt.targets[0], ast.Name)
            ):
                what = _gathers_whole(stmt.value)
                if what is not None:
                    gathered[stmt.targets[0].id] = (stmt.lineno, what)
        for node in walk_skipping_nested_functions(fn.body):
            what = _gathers_whole(node)
            if what is not None:
                read = _host_read_of(node, ctx)
                if read is not None:
                    yield _dlc502(ctx, node, what, read)
                continue
            if (
                isinstance(node, ast.Name)
                and isinstance(node.ctx, ast.Load)
                and node.id in gathered
                and node.lineno > gathered[node.id][0]
            ):
                read = _host_read_of(node, ctx)
                if read is not None:
                    yield _dlc502(ctx, node, f"{node.id} = ...{gathered[node.id][1]}", read)


def _dlc502(ctx: FileContext, node: ast.AST, what: str, read: str) -> Violation:
    return ctx.violation(
        "DLC502",
        node,
        f"{what} materializes the whole of a sharded DTensor on every rank "
        f"(an all-gather over the mesh, staged through the host under gloo) "
        f"and this scope then reads {read} here: read this rank's part "
        "(to_local(), or redistribute to the placement it needs) instead",
    )


register(
    Rule(
        id="DLC502",
        name="sharded-host-materialization",
        doc="no host read of a full_tensor()/all-Replicate redistribute result",
        check=_check_gathered_host_read,
        applies=_applies_comms_paths,
        gate=GATE,
    )
)

# --- DLC503: one captured callable replayed under two meshes -------------------
# A captured graph holds the collectives of the process groups it was
# captured on.  Replaying the same callable after the scope moved to
# another mesh (rebind_mesh, a new group) either reuses the old groups'
# communicators or recaptures silently — two graphs with independent
# collective schedules.  Rebuild the callable after a mesh change.

_CAPTURED_FACTORIES = ("multi_step_fn", "CapturedSteps", "CapturedDecode",
                       "make_graphed_callables", "CUDAGraph")
_MESH_CHANGES = ("rebind_mesh", "new_group", "init_device_mesh", "build_mesh",
                 "build_mesh_over")


def _captured_callable_names(fn: _FnDef) -> dict[str, int]:
    out: dict[str, int] = {}
    for stmt in walk_skipping_nested_functions(fn.body):
        if (
            isinstance(stmt, ast.Assign)
            and len(stmt.targets) == 1
            and isinstance(stmt.targets[0], ast.Name)
            and isinstance(stmt.value, ast.Call)
            and _terminal(stmt.value) in _CAPTURED_FACTORIES
        ):
            out.setdefault(stmt.targets[0].id, stmt.lineno)
    return out


def _check_cross_mesh_replay(tree: ast.Module, ctx: FileContext) -> Iterator[Violation]:
    for fn in _scopes(tree):
        names = _captured_callable_names(fn)
        if not names:
            continue
        nodes = list(walk_skipping_nested_functions(fn.body))
        changes = sorted(
            n.lineno for n in nodes
            if isinstance(n, ast.Call) and _terminal(n) in _MESH_CHANGES
        )
        if not changes:
            continue
        binds: dict[str, list[int]] = {}
        for n in nodes:
            if isinstance(n, ast.Assign):
                for t in n.targets:
                    if isinstance(t, ast.Name) and t.id in names:
                        binds.setdefault(t.id, []).append(n.lineno)
        for name in names:
            calls = sorted(
                (n for n in nodes if isinstance(n, ast.Call) and (
                    (isinstance(n.func, ast.Name) and n.func.id == name)
                    or (isinstance(n.func, ast.Attribute) and n.func.attr == "replay"
                        and dotted_name(n.func.value) == name))),
                key=lambda n: n.lineno,
            )
            for a, b in zip(calls, calls[1:]):
                moved = any(a.lineno < ln < b.lineno for ln in changes)
                rebuilt = any(a.lineno < ln <= b.lineno for ln in binds.get(name, ()))
                if moved and not rebuilt:
                    yield ctx.violation(
                        "DLC503",
                        b,
                        f"captured callable {name}() is replayed here after "
                        "the scope moved to another mesh or process group: "
                        "its graph holds the collectives of the groups it "
                        "was captured on, so the two calls run two "
                        "independent collective schedules; rebuild the "
                        "callable after the mesh change",
                    )
                    break


register(
    Rule(
        id="DLC503",
        name="cross-mesh-leakage",
        doc="a captured callable must not be replayed across a mesh change",
        check=_check_cross_mesh_replay,
        applies=_applies_comms_paths,
        gate=GATE,
    )
)

# --- DLC504: unsummed reduction over a local shard -----------------------------
# `x.to_local()` is this rank's shard.  A sum/mean over it reduces ONE
# shard and silently treats the result as the global value unless the
# scope follows it with a collective over the group.

_REDUCE_METHODS = ("sum", "mean", "prod", "max", "min", "norm", "amax")
_COLLECTIVE_TERMINALS = ("all_reduce", "reduce_scatter", "all_gather",
                         "all_gather_into_tensor", "reduce_scatter_tensor",
                         "all_reduce_coalesced", "full_tensor", "redistribute")


def _is_to_local(node: ast.AST) -> bool:
    return (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr == "to_local"
    )


def _check_local_reduction(tree: ast.Module, ctx: FileContext) -> Iterator[Violation]:
    for fn in _scopes(tree):
        nodes = list(walk_skipping_nested_functions(fn.body))
        if any(isinstance(n, ast.Call) and _terminal(n) in _COLLECTIVE_TERMINALS
               for n in nodes):
            continue  # the scope is group-aware; trust its reductions
        local_names = {
            n.targets[0].id
            for n in nodes
            if isinstance(n, ast.Assign) and len(n.targets) == 1
            and isinstance(n.targets[0], ast.Name) and _is_to_local(n.value)
        }
        for node in nodes:
            if not isinstance(node, ast.Call):
                continue
            subject = None
            if isinstance(node.func, ast.Attribute) and node.func.attr in _REDUCE_METHODS:
                subject = node.func.value
                what = f".{node.func.attr}()"
            elif (call_name(node) or "").rsplit(".", 1)[-1] in _REDUCE_METHODS and (
                (call_name(node) or "").startswith("torch.")
            ) and node.args:
                subject = node.args[0]
                what = f"{call_name(node)}()"
            if subject is None:
                continue
            # Through elementwise chains: local.pow(2).sum() reduces local.
            while not _is_to_local(subject) and isinstance(subject, ast.Call) \
                    and isinstance(subject.func, ast.Attribute):
                subject = subject.func.value
            if _is_to_local(subject) or (
                isinstance(subject, ast.Name) and subject.id in local_names
            ):
                yield ctx.violation(
                    "DLC504",
                    node,
                    f"{what} over to_local() in {fn.name}() with no "
                    "collective anywhere in the scope: the tensor is this "
                    "rank's SHARD, so this reduces one shard and silently "
                    "treats it as the global value; follow the reduction "
                    "with dist.all_reduce over the shard's group",
                )


register(
    Rule(
        id="DLC504",
        name="shard-map-partial-reduction",
        doc="reductions over to_local() shards need a collective after them",
        check=_check_local_reduction,
        applies=_applies_comms_paths,
        gate=GATE,
    )
)

# --- DLC505: tensor read after donate_buffers freed it ---------------------------
# train.data.donate_buffers(tree) resizes every tensor's storage of the
# tree to zero once the step that read it is launched: a later read of the
# same name sees an empty storage (an error at best, garbage through a
# raw pointer at worst).  Rebind the name, or free after the last read.


def _assigned_names(stmt: ast.stmt) -> set[str]:
    out: set[str] = set()
    targets: list[ast.expr] = []
    if isinstance(stmt, ast.Assign):
        targets = list(stmt.targets)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign, ast.For)):
        targets = [stmt.target]
    elif isinstance(stmt, ast.With):
        targets = [item.optional_vars for item in stmt.items if item.optional_vars is not None]
    for t in targets:
        for n in ast.walk(t):
            name = dotted_name(n)
            if name is not None:
                out.add(name)
    return out


def _donated(call: ast.Call) -> list[str]:
    if not call.args:
        return []
    arg = call.args[0]
    elts = arg.elts if isinstance(arg, (ast.Tuple, ast.List)) else [arg]
    return [n for n in (dotted_name(e) for e in elts) if n is not None]


def _check_donated_read_after_call(tree: ast.Module, ctx: FileContext) -> Iterator[Violation]:
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or _terminal(node) != "donate_buffers":
            continue
        # The statement holding the call, in the body list that holds it.
        stmt, parent = node, ctx.parents.get(node)
        while parent is not None and not (
            isinstance(stmt, ast.stmt)
            and any(isinstance(getattr(parent, f, None), list) and stmt in getattr(parent, f)
                    for f in ("body", "orelse", "finalbody"))
        ):
            stmt, parent = parent, ctx.parents.get(parent)
        if parent is None:
            continue
        body = next(getattr(parent, f) for f in ("body", "orelse", "finalbody")
                    if isinstance(getattr(parent, f, None), list) and stmt in getattr(parent, f))
        for donated in _donated(node):
            for later in body[body.index(stmt) + 1:]:
                if donated in _assigned_names(later):
                    break
                read = next(
                    (
                        n
                        for n in ast.walk(later)
                        if isinstance(n, (ast.Name, ast.Attribute))
                        and isinstance(getattr(n, "ctx", ast.Load()), ast.Load)
                        and dotted_name(n) == donated
                    ),
                    None,
                )
                if read is not None:
                    yield ctx.violation(
                        "DLC505",
                        read,
                        f"{donated!r} is read after donate_buffers() freed "
                        "its storage: the tensor is empty from that call on, "
                        "so this read fails or sees garbage; free after the "
                        "last read, or rebind the name first",
                    )
                    break


register(
    Rule(
        id="DLC505",
        name="donated-read-after-call",
        doc="tensors must not be read after donate_buffers() freed them",
        check=_check_donated_read_after_call,
        applies=_applies_comms_paths,
        gate=GATE,
    )
)
