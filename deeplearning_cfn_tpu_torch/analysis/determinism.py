"""DLC6xx: the determinism verifier — static nondeterminism rules (the port's
copy of the JAX package's, with torch's global generator under DLC601).

Every proof this stack offers — the 10k-agent fleet soak, the chaos
gates, the scheduler's ledger crash-resume — is an assertion of
*byte-determinism per seed*: the same seed must produce the same
report, byte for byte, run over run (ROADMAP items 3 and 4 make that
the acceptance criterion for the federated sim and the composed
gauntlet).  These rules encode the hazards that silently break the
contract, scoped to the determinism-bearing packages (chaos/, sched/,
cluster/, obs/, train/datastream/, serve/loadgen.py,
analysis/schedules.py, parallel/overlap.py — the bucket planner's
output order is an SPMD contract, so it is held to the same bar):

DLC600 unsorted-fs-enumeration  os.listdir/glob/Path.iterdir results
                                feeding iteration, a subscript, or a
                                return value without sorted() — the OS
                                hands back directory entries in
                                filesystem order, which differs across
                                machines and reruns
DLC601 ambient-entropy          random.*/uuid1/uuid4/secrets/time.time,
                                and draws on torch's global generator
                                (torch.rand/randn/randint/randperm,
                                normal_/uniform_ without generator=),
                                in deterministic scope, outside the
                                injected-clock / seeded-RNG seams —
                                widens DLC205's wall-clock rule from
                                liveness to entropy
DLC602 set-order-fold           iterating a set without a sort key —
                                str hashes are salted per process
                                (PYTHONHASHSEED), so the fold order
                                differs run over run
DLC603 hash-escape              hash()/id() escaping into persisted or
                                compared values — the exact bug class
                                ``cluster.shards.shard_for_key`` dodged
                                by using crc32
DLC604 seed-plumbing-break      a function that takes seed/rng but
                                constructs an unseeded RNG: the seed
                                never reaches the entropy source

Like every DLC pass, matchers anchor on the bug's *shape*, not a
keyword: DLC600 only fires where enumeration order can reach output
(truthiness, len(), membership stay legal); DLC601 exempts ts-named
record metadata (``"started_ts": time.time()`` stays legal, same
carve-out DLC205 made) and default-clock adapters whose entire body is
the call; DLC602 tracks set-typed bindings per scope, not names that
merely sound set-ish; time.monotonic()/perf_counter() remain DLC205's
domain — interval math is a liveness question, not an entropy one.

All five are gated behind ``dlcfn lint --determinism`` (or an explicit
``--select``) and ratchet via the committed baseline.  DLC610 is
*reserved* here for the dynamic replay sentinel
(analysis/replay_audit.py — double-run every chaos scenario and fleet
soak, diff bytes); no static rule may ever register it.
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
    register,
    walk_skipping_nested_functions,
)

GATE = "determinism"
RULE_IDS = ("DLC600", "DLC601", "DLC602", "DLC603", "DLC604")

# Reserved for the dynamic replay sentinel (analysis/replay_audit.py): a
# chaos scenario or fleet soak whose two same-seed in-process runs produce
# different report bytes.  Only the sentinel may emit it; registering a
# static rule under this id is a bug (tests pin the reservation).
AUDIT_RULE_REPLAY = "DLC610"
AUDIT_RULE_IDS = (AUDIT_RULE_REPLAY,)


def _applies_determinism_paths(path: Path) -> bool:
    parts = path.parts
    if {"chaos", "sched", "cluster", "obs"} & set(parts):
        return True
    if "datastream" in parts:
        return True
    if path.name == "loadgen.py" and "serve" in parts:
        return True
    if path.name == "schedules.py" and "analysis" in parts:
        return True
    # The bucket planner must emit the same bucket order on every host or
    # the fused collectives deadlock — replay-critical like the rest.
    if path.name == "overlap.py" and "parallel" in parts:
        return True
    return False


# --- DLC600: unsorted filesystem enumeration --------------------------------

_ENUM_CALLS = {"os.listdir", "os.scandir", "glob.glob", "glob.iglob"}
_ENUM_METHODS = {"glob", "rglob", "iterdir"}
# Wrappers that preserve order without consuming it — climb through.
_TRANSPARENT_CALLS = {"list", "tuple"}
# Consumers for which enumeration order cannot reach the result.
_ORDER_FREE_CALLS = {
    "sorted",
    "len",
    "set",
    "frozenset",
    "any",
    "all",
    "sum",
    "min",
    "max",
    "bool",
}


def _is_enum_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    if call_name(node) in _ENUM_CALLS:
        return True
    return (
        isinstance(node.func, ast.Attribute) and node.func.attr in _ENUM_METHODS
    )


def _enum_display(node: ast.Call) -> str:
    name = call_name(node)
    if name is not None:
        return f"{name}()"
    assert isinstance(node.func, ast.Attribute)
    return f".{node.func.attr}()"


def _climb_transparent(
    node: ast.AST, ctx: FileContext
) -> tuple[ast.AST, ast.AST | None]:
    """Skip list()/tuple() shells: they keep the order problem intact."""
    cur = node
    parent = ctx.parents.get(cur)
    while (
        isinstance(parent, ast.Call)
        and call_name(parent) in _TRANSPARENT_CALLS
        and cur in parent.args
    ):
        cur = parent
        parent = ctx.parents.get(parent)
    return cur, parent


def _order_sensitive_context(cur: ast.AST, parent: ast.AST | None) -> bool:
    """Can enumeration order reach output from this expression position?

    Anchored on the escape shapes: iteration, subscripts, return/yield,
    containment in a built value, or feeding an arbitrary consumer.
    Truthiness, len(), set()-folding, and membership tests stay legal.
    """
    if isinstance(parent, ast.Call):
        if cur in parent.args and call_name(parent) in _ORDER_FREE_CALLS:
            return False
        return True
    if isinstance(parent, ast.Compare):
        return not (
            cur in parent.comparators
            and all(isinstance(op, (ast.In, ast.NotIn)) for op in parent.ops)
        )
    if isinstance(parent, (ast.If, ast.While)) and parent.test is cur:
        return False
    if isinstance(parent, ast.BoolOp):
        return False
    if isinstance(parent, ast.UnaryOp) and isinstance(parent.op, ast.Not):
        return False
    if isinstance(parent, ast.For) and parent.iter is cur:
        return True
    if isinstance(parent, ast.comprehension) and parent.iter is cur:
        return True
    if isinstance(
        parent,
        (
            ast.Return,
            ast.Yield,
            ast.YieldFrom,
            ast.Subscript,
            ast.Starred,
            ast.Dict,
            ast.List,
            ast.Tuple,
            ast.Set,
            ast.JoinedStr,
            ast.FormattedValue,
            ast.BinOp,
        ),
    ):
        return True
    return False


def _scope_of(node: ast.AST, ctx: FileContext) -> ast.AST:
    return ctx.enclosing_function(node) or ctx.tree


def _first_sensitive_load(
    scope: ast.AST, name: str, ctx: FileContext
) -> ast.AST | None:
    for n in ast.walk(scope):
        if (
            isinstance(n, ast.Name)
            and n.id == name
            and isinstance(n.ctx, ast.Load)
        ):
            cur, parent = _climb_transparent(n, ctx)
            if _order_sensitive_context(cur, parent):
                return n
    return None


def _check_unsorted_enumeration(
    tree: ast.Module, ctx: FileContext
) -> Iterator[Violation]:
    for node in ast.walk(tree):
        if not _is_enum_call(node):
            continue
        assert isinstance(node, ast.Call)
        what = _enum_display(node)
        cur, parent = _climb_transparent(node, ctx)
        if isinstance(parent, ast.Assign):
            targets = parent.targets
            if len(targets) == 1 and isinstance(targets[0], ast.Name):
                name = targets[0].id
                load = _first_sensitive_load(_scope_of(parent, ctx), name, ctx)
                if load is not None:
                    yield ctx.violation(
                        "DLC600",
                        node,
                        f"{what} result `{name}` is used order-sensitively "
                        f"(line {load.lineno}) without sorted(): the OS "
                        "returns entries in filesystem order, which differs "
                        "across machines and reruns; sort at the "
                        "enumeration site",
                    )
                continue
            yield ctx.violation(
                "DLC600",
                node,
                f"{what} result is stored without sorted() where its uses "
                "cannot be tracked: the OS returns entries in filesystem "
                "order, which differs across machines and reruns; sort at "
                "the enumeration site",
            )
            continue
        if _order_sensitive_context(cur, parent):
            yield ctx.violation(
                "DLC600",
                node,
                f"{what} feeds iteration or output in filesystem order, "
                "which differs across machines and reruns; wrap the "
                "enumeration in sorted(...)",
            )


register(
    Rule(
        id="DLC600",
        name="unsorted-fs-enumeration",
        doc="listdir/glob/iterdir results must be sorted before order can escape",
        check=_check_unsorted_enumeration,
        applies=_applies_determinism_paths,
        gate=GATE,
    )
)

# --- DLC601: ambient entropy in deterministic scope -------------------------

_AMBIENT_ENTROPY = {
    "random.random",
    "random.randint",
    "random.randrange",
    "random.uniform",
    "random.gauss",
    "random.normalvariate",
    "random.expovariate",
    "random.betavariate",
    "random.choice",
    "random.choices",
    "random.sample",
    "random.shuffle",
    "random.getrandbits",
    "random.seed",
    "uuid.uuid1",
    "uuid.uuid4",
    "os.urandom",
}
_WALL_CLOCK = {"time.time", "time.time_ns"}
_ALWAYS_AMBIENT_CTORS = {"random.SystemRandom", "SystemRandom"}
_NP_RANDOM_PREFIXES = ("np.random.", "numpy.random.")
# numpy.random members that are constructors of *seedable* state, not
# draws from the hidden global generator.
_NP_SEEDED_MEMBERS = {
    "default_rng",
    "Generator",
    "RandomState",
    "SeedSequence",
    "PCG64",
    "Philox",
}
# Seedable RNG constructors: zero-arg means "seed from the OS".
_SEEDED_CTORS = {
    "random.Random",
    "Random",
    "np.random.default_rng",
    "numpy.random.default_rng",
    "default_rng",
    "np.random.RandomState",
    "numpy.random.RandomState",
    "RandomState",
}
_TS_MARKERS = ("ts", "time", "at", "when", "date", "timestamp")
_NUMERIC_WRAPPERS = {"round", "int", "float"}
_SEED_PARAM_TERMINALS = ("seed", "rng")


def _ts_named(name: str) -> bool:
    return name.lower().endswith(_TS_MARKERS)


def _is_record_metadata(node: ast.AST, ctx: FileContext) -> bool:
    """``"started_ts": time.time()`` and kin: a timestamp *recorded*, not
    a timestamp *decided on* — the same carve-out DLC205 makes."""
    cur = node
    parent = ctx.parents.get(cur)
    while (
        isinstance(parent, ast.Call)
        and cur in parent.args
        and (
            call_name(parent) in _NUMERIC_WRAPPERS
            # A record-read fallback — ``standby.get("started_ts",
            # time.time())`` — is still the recorded-metadata shape.
            or (
                isinstance(parent.func, ast.Attribute)
                and parent.func.attr == "get"
            )
        )
    ):
        cur = parent
        parent = ctx.parents.get(parent)
    if isinstance(parent, ast.Dict):
        for key, value in zip(parent.keys, parent.values):
            if (
                value is cur
                and isinstance(key, ast.Constant)
                and isinstance(key.value, str)
                and _ts_named(key.value)
            ):
                return True
        return False
    if isinstance(parent, ast.keyword):
        return parent.arg is not None and _ts_named(parent.arg)
    if isinstance(parent, ast.Assign):
        return any(_ts_named(dotted_name(t) or "") for t in parent.targets)
    return False


def _is_clock_adapter(node: ast.AST, ctx: FileContext) -> bool:
    """A function whose whole body is ``return time.time()`` is the
    injectable default of a clock seam, not ambient use."""
    fn = ctx.enclosing(node, ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
    if isinstance(fn, ast.Lambda):
        return fn.body is node
    if fn is None:
        return False
    assert isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
    body = [
        s
        for s in fn.body
        if not (
            isinstance(s, ast.Expr)
            and isinstance(s.value, ast.Constant)
            and isinstance(s.value.value, str)
        )
    ]
    return (
        len(body) == 1
        and isinstance(body[0], ast.Return)
        and body[0].value is node
    )


def _seed_params(fn: ast.AST) -> list[str]:
    args = getattr(fn, "args", None)
    if args is None:
        return []
    out = []
    for a in args.posonlyargs + args.args + args.kwonlyargs:
        t = a.arg.lower()
        if t in _SEED_PARAM_TERMINALS or t.endswith(
            tuple("_" + m for m in _SEED_PARAM_TERMINALS)
        ):
            out.append(a.arg)
    return out


# torch's draws on its process-wide default generator: the port's form of
# ambient entropy (JAX has no global generator to draw from).  Each is
# ambient unless it names its own ``generator=``.
_TORCH_GLOBAL_DRAWS = {
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
}
_TORCH_GLOBAL_DRAW_METHODS = {
    "normal_",
    "uniform_",
    "random_",
    "bernoulli_",
    "exponential_",
    "geometric_",
    "cauchy_",
    "log_normal_",
}


def _draws_torch_global(node: ast.Call, name: str) -> bool:
    if any(kw.arg == "generator" for kw in node.keywords):
        return False
    if name in _TORCH_GLOBAL_DRAWS:
        return True
    return (
        isinstance(node.func, ast.Attribute)
        and node.func.attr in _TORCH_GLOBAL_DRAW_METHODS
    )


def _check_ambient_entropy(
    tree: ast.Module, ctx: FileContext
) -> Iterator[Violation]:
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = call_name(node) or ""
        terminal = name.rsplit(".", 1)[-1]
        if name in _WALL_CLOCK:
            if _is_record_metadata(node, ctx) or _is_clock_adapter(node, ctx):
                continue
            yield ctx.violation(
                "DLC601",
                node,
                f"{name}() in a determinism-scoped path: wall-clock reads "
                "differ every run; thread the injected clock (VirtualClock "
                "or a clock callable) through instead — record metadata "
                'like `"started_ts": time.time()` stays legal',
            )
            continue
        if (
            name in _AMBIENT_ENTROPY
            or name in _ALWAYS_AMBIENT_CTORS
            or name.startswith("secrets.")
            or (
                name.startswith(_NP_RANDOM_PREFIXES)
                and terminal not in _NP_SEEDED_MEMBERS
            )
        ):
            yield ctx.violation(
                "DLC601",
                node,
                f"{name}() draws ambient process entropy in a "
                "determinism-scoped path; plumb a seeded RNG "
                "(random.Random(seed) / np.random.default_rng(seed)) or an "
                "injected id factory through the call path",
            )
            continue
        if _draws_torch_global(node, name):
            what = f"{name}()" if name else f".{node.func.attr}()"
            yield ctx.violation(
                "DLC601",
                node,
                f"{what} draws on torch's global generator in a "
                "determinism-scoped path: its state is shared by every "
                "caller in the process; pass generator= (a "
                "torch.Generator seeded from the run's seed)",
            )
            continue
        if name in _SEEDED_CTORS and not node.args and not node.keywords:
            fn = ctx.enclosing_function(node)
            if fn is not None and _seed_params(fn):
                continue  # the seed exists but is not plumbed: DLC604's find
            yield ctx.violation(
                "DLC601",
                node,
                f"{name}() with no seed falls back to OS entropy; construct "
                "it from an explicit seed",
            )


register(
    Rule(
        id="DLC601",
        name="ambient-entropy",
        doc="no random/uuid/secrets/wall-clock outside injected seams",
        check=_check_ambient_entropy,
        applies=_applies_determinism_paths,
        gate=GATE,
    )
)

# --- DLC602: order-sensitive folds over sets --------------------------------


def _is_set_expr(expr: ast.AST) -> bool:
    if isinstance(expr, (ast.Set, ast.SetComp)):
        return True
    return isinstance(expr, ast.Call) and call_name(expr) in {
        "set",
        "frozenset",
    }


def _set_typed_names(scope: ast.AST) -> set[str]:
    """Names bound to sets in this scope — and *only* ever to sets, so a
    rebinding to sorted(...) downstream clears the name."""
    sets: set[str] = set()
    dropped: set[str] = set()
    for n in walk_skipping_nested_functions(scope.body):
        target = None
        value = None
        if (
            isinstance(n, ast.Assign)
            and len(n.targets) == 1
            and isinstance(n.targets[0], ast.Name)
        ):
            target, value = n.targets[0].id, n.value
        elif (
            isinstance(n, ast.AnnAssign)
            and isinstance(n.target, ast.Name)
            and n.value is not None
        ):
            target, value = n.target.id, n.value
        if target is None or value is None:
            continue
        (sets if _is_set_expr(value) else dropped).add(target)
    return sets - dropped


def _unordered_iter(it: ast.AST, set_names: set[str]) -> bool:
    if _is_set_expr(it):
        return True
    return isinstance(it, ast.Name) and it.id in set_names


def _check_set_order_fold(
    tree: ast.Module, ctx: FileContext
) -> Iterator[Violation]:
    scopes: list[ast.AST] = [tree]
    scopes.extend(
        n
        for n in ast.walk(tree)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    )
    for scope in scopes:
        set_names = _set_typed_names(scope)
        for n in walk_skipping_nested_functions(scope.body):
            iters: list[ast.AST] = []
            if isinstance(n, ast.For):
                iters.append(n.iter)
            elif isinstance(
                n, (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)
            ):
                iters.extend(gen.iter for gen in n.generators)
            for it in iters:
                if _unordered_iter(it, set_names):
                    yield ctx.violation(
                        "DLC602",
                        it,
                        "iterating a set folds in hash order, which is "
                        "salted per process (PYTHONHASHSEED) — a journal, "
                        "report, or ledger built from it differs run over "
                        "run; iterate sorted(...) with an explicit key",
                    )


register(
    Rule(
        id="DLC602",
        name="set-order-fold",
        doc="sets must be sorted before order-sensitive iteration",
        check=_check_set_order_fold,
        applies=_applies_determinism_paths,
        gate=GATE,
    )
)

# --- DLC603: hash()/id() escaping into persisted/compared values ------------


def _check_hash_escape(
    tree: ast.Module, ctx: FileContext
) -> Iterator[Violation]:
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = call_name(node)
        if name not in {"hash", "id"} or len(node.args) != 1:
            continue
        fn = ctx.enclosing_function(node)
        if fn is not None and fn.name == "__hash__":
            continue  # defining an object's hash is the one legal producer
        why = (
            "salted per process (PYTHONHASHSEED)"
            if name == "hash"
            else "a memory address, unique only within one process"
        )
        yield ctx.violation(
            "DLC603",
            node,
            f"{name}() is {why}; any persisted or compared value built on "
            "it differs across runs — use a stable digest (zlib.crc32 / "
            "hashlib) the way cluster.shards.shard_for_key does",
        )


register(
    Rule(
        id="DLC603",
        name="hash-escape",
        doc="hash()/id() must not reach persisted or compared values",
        check=_check_hash_escape,
        applies=_applies_determinism_paths,
        gate=GATE,
    )
)

# --- DLC604: seed-plumbing breaks -------------------------------------------


def _check_seed_plumbing(
    tree: ast.Module, ctx: FileContext
) -> Iterator[Violation]:
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        seedish = _seed_params(fn)
        if not seedish:
            continue
        for node in walk_skipping_nested_functions(fn.body):
            if (
                isinstance(node, ast.Call)
                and call_name(node) in _SEEDED_CTORS
                and not node.args
                and not node.keywords
            ):
                yield ctx.violation(
                    "DLC604",
                    node,
                    f"{fn.name}() takes `{seedish[0]}` but constructs an "
                    f"unseeded {call_name(node)}(): the seed never reaches "
                    "this RNG, so two same-seed runs diverge; pass the seed "
                    "(or a derived child seed) to the constructor",
                )


register(
    Rule(
        id="DLC604",
        name="seed-plumbing-break",
        doc="a function taking seed/rng must seed the RNGs it constructs",
        check=_check_seed_plumbing,
        applies=_applies_determinism_paths,
        gate=GATE,
    )
)
