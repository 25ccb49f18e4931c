"""The DLC4xx capture-safety rules (gated: ``dlcfn lint --sharding``).

The JAX package's DLC4xx guard its dispatch layer: retraces, missing
buffer donation, host syncs in the step loop, impure traced code.  The
port's dispatch layer is the CUDA graph (``train/trainer.CapturedSteps``,
``serve/engine.CapturedDecode``) and its state lives in place, so each
rule keeps its id, name and gate and finds the same class of bug in the
port's idiom:

DLC400 captured-code impurity      DLC403 mesh-axis consistency
DLC401 out-of-place state rebinding DLC404 host sync in the step loop
DLC402 replay-frozen Python scalars DLC405 nested capture / device copy

A graph replays what the capture recorded: a host value read in captured
code (a wall-clock stamp, a ``np.random`` or global-generator draw, a
Python float) is frozen at capture and every replay reuses it; a host
sync or a device copy inside the capture fails it or records a stale
value; a state tensor rebound out of place leaves the graph reading the
old storage.  The rules are conservative: each matcher anchors on the
specific shape of the bug.  The dynamic half (analysis/compile_audit.py)
runs the real trainer and engine and proves one capture and in-place
updates; its findings use the reserved ids DLC410/DLC411 so both halves
share one baseline ratchet.

Scope: the compute tree (``train/``, ``models/``, ``ops/``, ``serve/``).

What "captured" means here
--------------------------
Code is captured when the file shows it running under a CUDA-graph
capture: the body of a ``with torch.cuda.graph(...)`` block, a function
passed to ``torch.cuda.make_graphed_callables``, the captured step roots
``CapturedSteps._run`` and ``paged_decode_logits``, and, closed over as
the JAX package closes its traced functions, defs nested in captured
code and same-file functions it calls by bare name (or, for a method,
by ``self.<name>``).  Cross-module call graphs stay out, deliberately.

DLC403's ground truth is cross-module: the axis vocabulary is
machine-read from ``AXIS_ORDER`` in ``parallel/mesh.py``.
"""

from __future__ import annotations

import ast
from functools import lru_cache
from pathlib import Path
from typing import Iterator

from deeplearning_cfn_tpu_torch.analysis.core import (
    FileContext,
    Rule,
    Violation,
    call_name,
    dotted_name,
    has_keyword,
    register,
    walk_skipping_nested_functions,
)

GATE = "sharding"
RULE_IDS = ("DLC400", "DLC401", "DLC402", "DLC403", "DLC404", "DLC405")

# Reserved for the dynamic compile-audit sentinel (analysis/compile_audit.py):
# same namespace, same baseline ratchet, but findings come from running the
# real trainer and engine rather than from this AST pass.
AUDIT_RULE_RETRACE = "DLC410"
AUDIT_RULE_DONATION = "DLC411"
AUDIT_RULE_IDS = (AUDIT_RULE_RETRACE, AUDIT_RULE_DONATION)

_COMPUTE_DIRS = ("train", "models", "ops", "serve")


def _applies_compute_paths(path: Path) -> bool:
    return path.name == "bench.py" or any(d in path.parts for d in _COMPUTE_DIRS)


# --- captured-code discovery -------------------------------------------------

_FnDef = ast.FunctionDef | ast.AsyncFunctionDef
_GRAPH_CONTEXTS = ("torch.cuda.graph", "cuda.graph")
_GRAPHED_CALLABLES = (
    "torch.cuda.make_graphed_callables",
    "cuda.make_graphed_callables",
    "make_graphed_callables",
)
# The port's captured step roots: (class or None, function name).
_CAPTURED_ROOTS = (("CapturedSteps", "_run"), (None, "paged_decode_logits"))


def is_graph_context(node: ast.With) -> bool:
    """A ``with torch.cuda.graph(...)`` block: its body is captured."""
    for item in node.items:
        expr = item.context_expr
        if isinstance(expr, ast.Call) and call_name(expr) in _GRAPH_CONTEXTS:
            return True
    return False


def _defs_by_name(tree: ast.Module) -> dict[str, list[_FnDef]]:
    out: dict[str, list[_FnDef]] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.setdefault(node.name, []).append(node)
    return out


def _class_of(fn: ast.AST, ctx: FileContext) -> ast.ClassDef | None:
    parent = ctx.parents.get(fn)
    return parent if isinstance(parent, ast.ClassDef) else None


def _methods(cls: ast.ClassDef | None, name: str) -> list[_FnDef]:
    if cls is None:
        return []
    return [
        n
        for n in cls.body
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) and n.name == name
    ]


def captured_scopes(ctx: FileContext) -> dict[ast.AST, tuple[str, str]]:
    """Every captured body the file shows -> (display name, why).

    Keys are function defs (their body is captured) and ``with
    torch.cuda.graph`` blocks (their body is).  Cached on the FileContext
    so the rules share one computation.
    """
    cached = getattr(ctx, "_dlc4_captured", None)
    if cached is not None:
        return cached
    defs = _defs_by_name(ctx.tree)
    captured: dict[ast.AST, tuple[str, str]] = {}
    stack: list[ast.AST] = []

    def mark(node: ast.AST, name: str, why: str) -> None:
        if node not in captured:
            captured[node] = (name, why)
            stack.append(node)

    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.With) and is_graph_context(node):
            fn = ctx.enclosing_function(node)
            where = fn.name if fn is not None else "<module>"
            mark(node, f"the torch.cuda.graph block in {where}", "captured")
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            cls = _class_of(node, ctx)
            for root_cls, root_fn in _CAPTURED_ROOTS:
                if node.name == root_fn and (
                    root_cls is None or (cls is not None and cls.name == root_cls)
                ):
                    mark(node, node.name, "a captured step root")
        elif isinstance(node, ast.Call) and call_name(node) in _GRAPHED_CALLABLES:
            for arg in node.args[:1]:
                elts = arg.elts if isinstance(arg, (ast.Tuple, ast.List)) else [arg]
                for e in elts:
                    if isinstance(e, ast.Name):
                        for fn in defs.get(e.id, ()):
                            mark(fn, fn.name, f"passed to {call_name(node)}")

    # Transitive closure: nested defs and same-file calls (bare names, or
    # self.<method> of the enclosing class) run under the same capture.
    while stack:
        scope = stack.pop()
        name = captured[scope][0]
        owner = scope if isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef)) \
            else ctx.enclosing_function(scope)
        cls = _class_of(owner, ctx) if owner is not None else None
        body = scope.body
        for stmt in body:
            for node in ast.walk(stmt):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    mark(node, node.name, f"nested in captured {name}")
                elif isinstance(node, ast.Call):
                    func = node.func
                    if isinstance(func, ast.Name):
                        for callee in defs.get(func.id, ()):
                            mark(callee, callee.name, f"called from captured {name}")
                    elif (
                        isinstance(func, ast.Attribute)
                        and isinstance(func.value, ast.Name)
                        and func.value.id == "self"
                    ):
                        for callee in _methods(cls, func.attr):
                            mark(callee, callee.name, f"called from captured {name}")

    ctx._dlc4_captured = captured  # type: ignore[attr-defined]
    return captured


def captured_nodes(ctx: FileContext) -> Iterator[tuple[ast.AST, str, str]]:
    """(node, captured scope's name, why) for every node of captured code,
    each once, nested scopes walked as their own."""
    seen: set[int] = set()
    for scope, (name, why) in captured_scopes(ctx).items():
        for node in walk_skipping_nested_functions(scope.body):
            if id(node) in seen:
                continue
            seen.add(id(node))
            yield node, name, why


# --- DLC400: captured-code impurity -------------------------------------------
# A host effect inside captured code runs ONCE, at capture; replays run
# the recorded kernels only.  A wall-clock read becomes a frozen number, a
# np.random or global-generator draw becomes the same "random" numbers on
# every replay (the generator's offset is not advanced per replay unless
# the graph registered it), and a `global` write never happens again.

_WALL_CLOCK_CALLS = (
    "time.time",
    "time.time_ns",
    "time.perf_counter",
    "time.perf_counter_ns",
    "time.monotonic",
    "time.monotonic_ns",
    "time.process_time",
    "datetime.now",
    "datetime.utcnow",
    "datetime.datetime.now",
    "datetime.datetime.utcnow",
)
_HOST_RANDOM_PREFIXES = ("np.random.", "numpy.random.", "random.")
TORCH_GLOBAL_DRAWS = (
    "torch.rand",
    "torch.randn",
    "torch.randint",
    "torch.randperm",
    "torch.rand_like",
    "torch.randn_like",
    "torch.randint_like",
    "torch.normal",
    "torch.bernoulli",
    "torch.multinomial",
)
TORCH_GLOBAL_DRAW_METHODS = ("normal_", "uniform_", "random_", "bernoulli_", "exponential_")


def torch_global_draw(node: ast.Call) -> str | None:
    """``torch.rand(...)``-shaped draws on the global generator (no
    ``generator=``) -> their display, else None."""
    if has_keyword(node, "generator"):
        return None
    name = call_name(node)
    if name in TORCH_GLOBAL_DRAWS:
        return f"{name}()"
    if isinstance(node.func, ast.Attribute) and node.func.attr in TORCH_GLOBAL_DRAW_METHODS:
        return f".{node.func.attr}()"
    return None


def _check_captured_impurity(tree: ast.Module, ctx: FileContext) -> Iterator[Violation]:
    for node, fn, why in captured_nodes(ctx):
        if isinstance(node, ast.Global):
            names = ", ".join(node.names)
            yield ctx.violation(
                "DLC400",
                node,
                f"`global {names}` inside captured {fn} ({why}): the write "
                "happens once at capture and never on a replay; keep the "
                "value in a device tensor the graph updates",
            )
            continue
        if not isinstance(node, ast.Call):
            continue
        name = call_name(node) or ""
        if name in _WALL_CLOCK_CALLS:
            yield ctx.violation(
                "DLC400",
                node,
                f"{name}() inside captured {fn} ({why}) is read once at "
                "capture — every replay reuses the same timestamp; measure "
                "host-side around the replay",
            )
        elif any(name.startswith(p) for p in _HOST_RANDOM_PREFIXES):
            yield ctx.violation(
                "DLC400",
                node,
                f"{name}() inside captured {fn} ({why}) freezes a host draw "
                "into the graph (identical values on every replay); draw on "
                "the device from a generator the graph registers",
            )
        else:
            draw = torch_global_draw(node)
            if draw is not None:
                yield ctx.violation(
                    "DLC400",
                    node,
                    f"{draw} inside captured {fn} ({why}) draws on torch's "
                    "global generator: the capture fixes its offset, so "
                    "replays repeat or skip draws the eager step would make; "
                    "pass generator= (a device generator registered with the "
                    "graph) or draw outside the capture",
                )


register(
    Rule(
        id="DLC400",
        name="traced-impurity",
        doc="no wall-clock/np.random/global-generator/global-write in captured code",
        check=_check_captured_impurity,
        applies=_applies_compute_paths,
        gate=GATE,
    )
)

# --- DLC401: out-of-place state rebinding -------------------------------------
# DLC008 (ungated) catches the exact trainer shape: a step or update
# function whose first argument is literally `state` rebinding a state
# tensor out of place.  DLC401 widens to what slips past it: any non-eval
# function whose first parameter is train-state typed (by name
# `state`/`train_state` or an annotation ending in `State`) that rebinds a
# tensor's storage (`p.data = ...`, `state.<field> = <arithmetic>`),
# replaces a parameter (`m.w = nn.Parameter(...)`), or loads an optimizer
# state dict (which replaces its tensors instead of copying into them).
# Each leaves two copies live, and a captured graph reading the old one.

_STATE_PARAM_NAMES = ("state", "train_state")
_EVAL_NAME_MARKERS = ("eval", "infer", "predict")
_STEP_NAME_MARKERS = ("step", "update")


def _annotation_is_state(arg: ast.arg) -> bool:
    ann = arg.annotation
    if ann is None:
        return False
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        text = ann.value
    else:
        text = dotted_name(ann) or ""
    return text.rsplit(".", 1)[-1].endswith("State")


def state_typed_first_param(fn: _FnDef) -> ast.arg | None:
    args = fn.args.args
    if args and args[0].arg == "self":
        args = args[1:]
    if not args:
        return None
    first = args[0]
    if first.arg in _STATE_PARAM_NAMES or _annotation_is_state(first):
        return first
    return None


def eval_like(name: str) -> bool:
    low = name.lower()
    return any(marker in low for marker in _EVAL_NAME_MARKERS)


def step_like(name: str) -> bool:
    low = name.lower()
    return any(marker in low for marker in _STEP_NAME_MARKERS)


def out_of_place_rebinds(fn: _FnDef, state_name: str) -> Iterator[tuple[ast.AST, str]]:
    """(node, what) for each out-of-place tensor rebinding in ``fn``'s own
    body: ``x.data = ...`` and ``<state>.<field> = <arithmetic>``."""
    for node in walk_skipping_nested_functions(fn.body):
        if not isinstance(node, ast.Assign):
            continue
        for target in node.targets:
            if not isinstance(target, ast.Attribute):
                continue
            name = dotted_name(target) or f"<expr>.{target.attr}"
            if target.attr == "data":
                yield node, f"{name} = ..."
            elif (
                isinstance(target.value, ast.Name)
                and target.value.id == state_name
                and isinstance(node.value, ast.BinOp)
            ):
                yield node, f"{name} = <arithmetic>"


def _parameter_replacements(fn: _FnDef) -> Iterator[tuple[ast.AST, str]]:
    for node in walk_skipping_nested_functions(fn.body):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            cname = call_name(node.value) or ""
            if cname.rsplit(".", 1)[-1] == "Parameter" and any(
                isinstance(t, ast.Attribute) for t in node.targets
            ):
                yield node, f"{dotted_name(node.targets[0]) or 'attribute'} = nn.Parameter(...)"
        elif (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "load_state_dict"
            and "optim" in (dotted_name(node.func.value) or "").lower()
        ):
            yield node, f"{dotted_name(node.func.value)}.load_state_dict(...)"


def _check_out_of_place_state(tree: ast.Module, ctx: FileContext) -> Iterator[Violation]:
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        first = state_typed_first_param(fn)
        if first is None or eval_like(fn.name):
            continue
        exact = first.arg == "state" and step_like(fn.name)
        found = [] if exact else list(out_of_place_rebinds(fn, first.arg))
        found += list(_parameter_replacements(fn))
        for node, what in found:
            yield ctx.violation(
                "DLC401",
                node,
                f"{fn.name}() takes a train state ({first.arg!r}) and "
                f"rebinds its tensors out of place ({what}): the old and "
                "new copies stay live together and a captured graph keeps "
                "reading the old storage; update in place (copy_, add_, "
                "torch._foreach_*_, load into the live tensors)",
            )


register(
    Rule(
        id="DLC401",
        name="undonated-train-state-jit",
        doc="train-state functions must update state tensors in place (eval exempt)",
        check=_check_out_of_place_state,
        applies=_applies_compute_paths,
        gate=GATE,
    )
)

# --- DLC402: replay-frozen Python scalars -------------------------------------
# A graph records kernels with their arguments: a Python float or bool
# read in captured code becomes a constant of the graph.  A learning rate
# passed as a float is the classic: the schedule moves, the replays keep
# the capture's value.  The port keeps lr in a device tensor
# (CapturedSteps.lrs) for exactly this reason.  An if-test over an
# f-string is frozen the same way.


def _annotation_terminal(arg: ast.arg) -> str | None:
    ann = arg.annotation
    if ann is None:
        return None
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        return ann.value.rsplit(".", 1)[-1]
    name = dotted_name(ann)
    return name.rsplit(".", 1)[-1] if name else None


def _defaults_by_arg(fn: _FnDef) -> dict[str, ast.expr]:
    out: dict[str, ast.expr] = {}
    pos = fn.args.args
    for arg, default in zip(pos[len(pos) - len(fn.args.defaults):], fn.args.defaults):
        out[arg.arg] = default
    for arg, default in zip(fn.args.kwonlyargs, fn.args.kw_defaults):
        if default is not None:
            out[arg.arg] = default
    return out


def _reads(fn: _FnDef, pname: str) -> bool:
    return any(
        isinstance(n, ast.Name) and n.id == pname and isinstance(n.ctx, ast.Load)
        for n in walk_skipping_nested_functions(fn.body)
    )


def _check_replay_frozen_scalars(tree: ast.Module, ctx: FileContext) -> Iterator[Violation]:
    for scope, (name, why) in captured_scopes(ctx).items():
        if isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defaults = _defaults_by_arg(scope)
            args = list(scope.args.args) + list(scope.args.kwonlyargs)
            if args and args[0].arg == "self":
                args = args[1:]
            for arg in args:
                ann = _annotation_terminal(arg)
                default = defaults.get(arg.arg)
                kind = None
                if ann in ("float", "bool"):
                    kind = ann
                elif isinstance(default, ast.Constant) and type(default.value) in (float, bool):
                    kind = type(default.value).__name__
                if kind is None or not _reads(scope, arg.arg):
                    continue
                yield ctx.violation(
                    "DLC402",
                    arg,
                    f"{scope.name}() parameter {arg.arg!r} is a Python {kind} "
                    f"read in captured code ({why}): the capture freezes its "
                    "value into the graph and every replay reuses it; keep a "
                    "value that changes between replays in a device tensor "
                    "(CapturedSteps.lrs)",
                )
    for node, fn, why in captured_nodes(ctx):
        if isinstance(node, ast.If) and any(
            isinstance(n, ast.JoinedStr) for n in ast.walk(node.test)
        ):
            yield ctx.violation(
                "DLC402",
                node,
                f"if-test built from an f-string inside captured {fn} "
                f"({why}): the branch is decided once at capture and "
                "frozen into the graph; branch outside the capture",
            )


register(
    Rule(
        id="DLC402",
        name="retrace-hazard",
        doc="no Python float/bool that changes between replays read in captured code",
        check=_check_replay_frozen_scalars,
        applies=_applies_compute_paths,
        gate=GATE,
    )
)

# --- DLC403: mesh-axis consistency --------------------------------------------
# A DeviceMesh dimension name is a stringly-typed foreign key into the
# mesh topology: `mesh["fspd"]` raises only when that line runs, a
# parallelize plan over an unknown axis only on the cluster.  The
# canonical vocabulary is machine-read from AXIS_ORDER in parallel/mesh.py.

_MESH_PY = Path(__file__).resolve().parents[1] / "parallel" / "mesh.py"
_AXIS_KWARGS = ("axis_name", "axis_names", "mesh_dim_names", "mesh_dim")
_AXIS_CALL_TERMINALS = ("get_group", "get_local_rank", "axis_rank", "size")


@lru_cache(maxsize=8)
def canonical_mesh_axes(mesh_py: str | None = None) -> tuple[str, ...]:
    """Extract AXIS_ORDER from parallel/mesh.py by AST, not import."""
    path = Path(mesh_py) if mesh_py is not None else _MESH_PY
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in tree.body:
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets = [node.target]
        else:
            continue
        for target in targets:
            if isinstance(target, ast.Name) and target.id == "AXIS_ORDER":
                value = node.value
                if isinstance(value, (ast.Tuple, ast.List)):
                    axes = tuple(
                        e.value
                        for e in value.elts
                        if isinstance(e, ast.Constant) and isinstance(e.value, str)
                    )
                    if axes:
                        return axes
    raise ValueError(f"could not extract AXIS_ORDER from {path}")


def _mesh_named(node: ast.AST) -> bool:
    name = dotted_name(node)
    return name is not None and "mesh" in name.rsplit(".", 1)[-1].lower()


def _str_constants(node: ast.AST) -> Iterator[ast.Constant]:
    for n in ast.walk(node):
        if isinstance(n, ast.Constant) and isinstance(n.value, str):
            yield n


def axis_sources(node: ast.AST) -> list[ast.AST]:
    """The sub-expressions of ``node`` that name mesh axes: ``mesh["a"]``,
    ``mesh.get_group("a")``, ``axis_rank(mesh, "a")`` and the axis kwargs."""
    sources: list[ast.AST] = []
    if isinstance(node, ast.Subscript) and _mesh_named(node.value):
        sources.append(node.slice)
    elif isinstance(node, ast.Call):
        name = call_name(node) or ""
        terminal = name.rsplit(".", 1)[-1]
        if terminal in _AXIS_CALL_TERMINALS:
            if isinstance(node.func, ast.Attribute) and _mesh_named(node.func.value):
                sources.extend(node.args)
            elif node.args and _mesh_named(node.args[0]):
                sources.extend(node.args[1:])
        sources.extend(kw.value for kw in node.keywords if kw.arg in _AXIS_KWARGS)
    return sources


def _check_mesh_axis_consistency(tree: ast.Module, ctx: FileContext) -> Iterator[Violation]:
    try:
        canonical = set(canonical_mesh_axes())
    except (OSError, ValueError, SyntaxError) as e:
        yield ctx.violation(
            "DLC403",
            tree,
            f"cannot machine-read AXIS_ORDER from parallel/mesh.py ({e}); "
            "the mesh-axis vocabulary must stay statically extractable",
        )
        return
    shown = "/".join(sorted(canonical))
    for node in ast.walk(tree):
        for source in axis_sources(node):
            for const in _str_constants(source):
                if const.value not in canonical:
                    yield ctx.violation(
                        "DLC403",
                        const,
                        f"axis {const.value!r} does not resolve against the "
                        f"mesh topology axes ({shown}) machine-read from "
                        "parallel/mesh.py AXIS_ORDER: a DeviceMesh lookup or "
                        "plan over an unknown axis fails only on the cluster",
                    )


register(
    Rule(
        id="DLC403",
        name="mesh-axis-consistency",
        doc="DeviceMesh dim names, mesh[...] and plan axes must exist in AXIS_ORDER",
        check=_check_mesh_axis_consistency,
        applies=_applies_compute_paths,
        gate=GATE,
    )
)

# --- DLC404: host sync in the step loop ---------------------------------------
# DLC003 guards captured code; this rule guards the HOST side: the loop
# that launches steps.  An unguarded .item()/.tolist()/.cpu()/float()/
# torch.cuda.synchronize() in the loop body drains the stream every
# iteration.  The repo idiom (train/trainer.py fit()) reads losses back
# behind a periodic `if` (the log_every boundary), so anything under an
# `if` inside the loop is deliberately exempt.

_SYNC_CALL_NAMES = ("torch.cuda.synchronize", "cuda.synchronize")
_SYNC_METHODS = ("item", "tolist", "cpu")
_NP_MATERIALIZE = ("np.asarray", "numpy.asarray", "np.array", "numpy.array")


def host_sync_shape(node: ast.Call, floats: bool = True) -> str | None:
    name = call_name(node)
    if name in _SYNC_CALL_NAMES:
        return f"{name}()"
    if name in _NP_MATERIALIZE and node.args:
        return f"{name}()"
    if (
        isinstance(node.func, ast.Attribute)
        and node.func.attr in _SYNC_METHODS
        and not node.args
    ):
        return f".{node.func.attr}()"
    if (
        floats
        and isinstance(node.func, ast.Name)
        and node.func.id == "float"
        and len(node.args) == 1
        and not isinstance(node.args[0], ast.Constant)
    ):
        return "float(<device value>)"
    return None


def _is_step_loop(loop: ast.For | ast.While, ctx: FileContext) -> bool:
    fn = ctx.enclosing_function(loop)
    if fn is not None and fn.name == "fit":
        return True
    for node in walk_skipping_nested_functions(loop.body):
        if isinstance(node, ast.Call):
            name = call_name(node)
            if name is not None and "step" in name.rsplit(".", 1)[-1].lower():
                return True
    return False


def _guarded_or_rescoped(node: ast.AST, loop: ast.AST, ctx: FileContext) -> bool:
    cur = ctx.parents.get(node)
    while cur is not None and cur is not loop:
        if isinstance(cur, ast.If):
            return True  # periodic sync boundary — the sanctioned idiom
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            return True  # different scope; not executed per iteration here
        cur = ctx.parents.get(cur)
    return False


def _check_step_loop_host_sync(tree: ast.Module, ctx: FileContext) -> Iterator[Violation]:
    reported: set[int] = set()
    for loop in ast.walk(tree):
        if not isinstance(loop, (ast.For, ast.While)):
            continue
        if not _is_step_loop(loop, ctx):
            continue
        for stmt in loop.body:
            for node in ast.walk(stmt):
                if not isinstance(node, ast.Call) or id(node) in reported:
                    continue
                what = host_sync_shape(node)
                if what is None or _guarded_or_rescoped(node, loop, ctx):
                    continue
                reported.add(id(node))
                yield ctx.violation(
                    "DLC404",
                    node,
                    f"{what} runs unguarded on every iteration of a step "
                    "loop: it waits for the stream and serializes host with "
                    "device; read back behind a periodic `if` boundary "
                    "(fit()'s log_every idiom)",
                )


register(
    Rule(
        id="DLC404",
        name="step-loop-host-sync",
        doc="no unguarded host sync inside the step-launch loop",
        check=_check_step_loop_host_sync,
        applies=_applies_compute_paths,
        gate=GATE,
    )
)

# --- DLC405: nested capture / device copy under capture -----------------------
# A capture inside a capture is refused by CUDA at best and records
# a graph nobody replays at worst; a .to(device)/.cuda() copy inside
# captured code records a copy from a host buffer whose contents the
# replays never refresh (or fails the capture on pageable memory).  Both
# are hoist-one-line fixes: capture once, place inputs in static buffers.

_CAPTURE_CALLS = (
    "torch.cuda.graph",
    "cuda.graph",
    "torch.cuda.CUDAGraph",
    "cuda.CUDAGraph",
    "CUDAGraph",
) + _GRAPHED_CALLABLES
_HOST_TENSOR_CTORS = ("torch.tensor", "torch.as_tensor", "torch.from_numpy")


def _device_arg(node: ast.Call) -> bool:
    for a in node.args[:1]:
        if isinstance(a, ast.Constant) and isinstance(a.value, str) and (
            a.value.startswith("cuda") or a.value == "cpu"
        ):
            return True
        name = dotted_name(a) or ""
        if "device" in name.rsplit(".", 1)[-1].lower():
            return True
    return has_keyword(node, "device")


def _check_nested_capture(tree: ast.Module, ctx: FileContext) -> Iterator[Violation]:
    for node, fn, why in captured_nodes(ctx):
        if not isinstance(node, ast.Call):
            continue
        name = call_name(node) or ""
        if name in _CAPTURE_CALLS:
            yield ctx.violation(
                "DLC405",
                node,
                f"{name}() called inside captured {fn} ({why}): a capture "
                "inside a capture records a graph no replay runs (or fails "
                "the outer capture); capture once, outside",
            )
        elif isinstance(node.func, ast.Attribute) and (
            node.func.attr == "cuda" or (node.func.attr == "to" and _device_arg(node))
        ):
            yield ctx.violation(
                "DLC405",
                node,
                f".{node.func.attr}() device copy inside captured {fn} "
                f"({why}): the graph records a copy from a host buffer the "
                "replays never refresh; place inputs in static device "
                "buffers before the replay",
            )


register(
    Rule(
        id="DLC405",
        name="nested-dispatch-under-trace",
        doc="no nested capture or .to(device)/.cuda() copy inside captured code",
        check=_check_nested_capture,
        applies=_applies_compute_paths,
        gate=GATE,
    )
)
