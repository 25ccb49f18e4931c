"""The DLC0xx per-file rules.

Each rule encodes one repo idiom whose violation has already bitten (or
demonstrably would): the module docstrings cite the incident.  Rules are
deliberately conservative — a lint that cries wolf gets noqa'd into
uselessness — so every matcher anchors on the specific shape of the bug,
not on a keyword.

Registered ids (the README's rule table has the operator-facing view):

DLC001 untimed blocking call        DLC005 substring param-name match
DLC002 NaN-unsafe json.dumps       DLC006 thread without daemon/join
DLC003 host sync in captured code   DLC007 mutable default / py2 remnant
DLC004 interrupt-swallowing except  DLC008 out-of-place state step

DLC001, 002 and 004-007 are the JAX package's rules, copied: they do not
depend on the framework.  DLC003 and DLC008 keep their ids and names and
find the same bug in the port's idiom: a host sync inside code a CUDA
graph captures, and a train step that rebinds state tensors out of place
(both copies live, a captured graph reading the old storage).
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
    has_keyword,
    register,
    walk_skipping_nested_functions,
)
from deeplearning_cfn_tpu_torch.analysis.sharding import (
    captured_nodes,
    out_of_place_rebinds,
    state_typed_first_param,
    step_like,
)

# --- DLC001: untimed blocking calls ---------------------------------------
# The repo's idiom is utils/timeouts.py: every phase draws from an explicit
# budget, and every blocking primitive states its own bound.  An untimed
# socket/subprocess call in the cluster/provision layers hangs bootstrap
# forever on the exact failure (unreachable broker, wedged make) the
# budget machinery exists to survive.

# dotted call name -> how a timeout may be passed: a kwarg name, plus an
# optional positional index that also counts.
_TIMEOUT_CALLS: dict[str, int | None] = {
    "socket.create_connection": 1,
    "subprocess.run": None,
    "subprocess.call": None,
    "subprocess.check_call": None,
    "subprocess.check_output": None,
    "urllib.request.urlopen": 2,
    "requests.get": None,
    "requests.post": None,
    "requests.put": None,
    "requests.head": None,
    "requests.delete": None,
    "requests.request": None,
}
# Receivers whose .wait()/.communicate() are Popen-shaped (a bare
# `self.wait()` on an unrelated class must not match).
_PROC_RECEIVERS = ("proc", "process", "popen", "child")


def _receiver_is_proc(func: ast.Attribute) -> bool:
    name = dotted_name(func.value)
    if name is None:
        return False
    terminal = name.rsplit(".", 1)[-1].lower()
    return any(marker in terminal for marker in _PROC_RECEIVERS)


def _check_untimed_calls(tree: ast.Module, ctx: FileContext) -> Iterator[Violation]:
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        if has_keyword(node, "timeout", "timeout_s"):
            continue
        name = call_name(node)
        if name in _TIMEOUT_CALLS:
            pos = _TIMEOUT_CALLS[name]
            if pos is not None and len(node.args) > pos:
                continue  # timeout passed positionally
            yield ctx.violation(
                "DLC001",
                node,
                f"{name}() without a timeout can hang forever; pass "
                "timeout= (the utils/timeouts.py budget discipline)",
            )
        elif (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in ("wait", "communicate")
            and _receiver_is_proc(node.func)
        ):
            yield ctx.violation(
                "DLC001",
                node,
                f".{node.func.attr}() on a subprocess without timeout= "
                "blocks indefinitely if the child wedges",
            )


register(
    Rule(
        id="DLC001",
        name="untimed-blocking-call",
        doc="socket/subprocess/requests calls must carry an explicit timeout",
        check=_check_untimed_calls,
    )
)

# --- DLC002: NaN-unsafe json.dumps in bench/metrics emitters ---------------
# json.dumps serializes float('nan') as the bare token `NaN`, which is NOT
# JSON: every strict consumer (jq, json.loads in CI comparisons, the
# BENCH_*.json history) chokes or silently skips the record.  The
# idiom: sanitize computed floats (train/metrics.py json_safe) and pass
# allow_nan=False so regressions fail at the emitter, not the reader.


def _applies_bench_paths(path: Path) -> bool:
    parts = path.parts
    return (
        "scripts" in parts
        or path.name == "bench.py"
        or (path.name == "metrics.py" and "train" in parts)
    )


def _check_nan_unsafe_dumps(tree: ast.Module, ctx: FileContext) -> Iterator[Violation]:
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or call_name(node) != "json.dumps":
            continue
        kw = next((k for k in node.keywords if k.arg == "allow_nan"), None)
        strict = (
            kw is not None
            and isinstance(kw.value, ast.Constant)
            and kw.value.value is False
        )
        if not strict:
            yield ctx.violation(
                "DLC002",
                node,
                "json.dumps in a bench/metrics emitter must pass "
                "allow_nan=False (and sanitize computed floats with "
                "train/metrics.json_safe): NaN serializes as invalid JSON",
            )


register(
    Rule(
        id="DLC002",
        name="nan-unsafe-json",
        doc="bench/metrics json.dumps must be strict (allow_nan=False)",
        check=_check_nan_unsafe_dumps,
        applies=_applies_bench_paths,
    )
)

# --- DLC003: host synchronization inside captured code --------------------
# Under a CUDA-graph capture these calls either fail the capture (a sync
# on a capturing stream is illegal) or, in code that also runs eagerly,
# read back a value the replays never refresh.  "Captured" is
# analysis/sharding.py's captured_scopes: torch.cuda.graph blocks, the
# functions make_graphed_callables takes, the captured step roots, and
# what they call in the same file.

_HOST_SYNC_CALLS = (
    "np.asarray",
    "numpy.asarray",
    "np.array",
    "numpy.array",
    "torch.cuda.synchronize",
    "cuda.synchronize",
)
_HOST_SYNC_METHODS = ("item", "tolist", "cpu")


def _check_host_sync_in_capture(tree: ast.Module, ctx: FileContext) -> Iterator[Violation]:
    for node, fn, why in captured_nodes(ctx):
        if not isinstance(node, ast.Call):
            continue
        name = call_name(node)
        if name in _HOST_SYNC_CALLS:
            yield ctx.violation(
                "DLC003",
                node,
                f"{name}() inside captured {fn} ({why}) forces a host sync "
                "(or fails the capture); keep device->host transfers outside "
                "the captured step",
            )
        elif (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in _HOST_SYNC_METHODS
            and not node.args
        ):
            yield ctx.violation(
                "DLC003",
                node,
                f".{node.func.attr}() inside captured {fn} ({why}) is a host "
                "sync; compute on-device and read back after the replay",
            )


register(
    Rule(
        id="DLC003",
        name="host-sync-in-jit",
        doc="no .item()/.tolist()/.cpu()/np.asarray/synchronize in captured code",
        check=_check_host_sync_in_capture,
    )
)

# --- DLC004: interrupt-swallowing exception handlers -----------------------
# A bare `except:` (or `except BaseException` without a re-raise) catches
# KeyboardInterrupt/SystemExit: Ctrl-C against an agent/broker retry loop
# then becomes "log and keep looping" and the operator cannot stop the
# process.  A BaseException handler is legitimate exactly when it re-raises
# after cleanup — that shape is allowed.


def _handler_reraises(handler: ast.ExceptHandler) -> bool:
    caught = handler.name
    for node in walk_skipping_nested_functions(handler.body):
        if isinstance(node, ast.Raise):
            if node.exc is None:
                return True  # bare `raise`
            if (
                caught
                and isinstance(node.exc, ast.Name)
                and node.exc.id == caught
            ):
                return True  # `raise e` — re-raises the original
    return False


def _catches_base_exception(handler: ast.ExceptHandler) -> bool:
    types = (
        handler.type.elts if isinstance(handler.type, ast.Tuple) else [handler.type]
    )
    return any(dotted_name(t) == "BaseException" for t in types if t is not None)


def _check_swallowed_interrupts(
    tree: ast.Module, ctx: FileContext
) -> Iterator[Violation]:
    for node in ast.walk(tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if node.type is None:
            yield ctx.violation(
                "DLC004",
                node,
                "bare `except:` swallows KeyboardInterrupt/SystemExit; "
                "catch Exception (or re-raise BaseException after cleanup)",
            )
        elif _catches_base_exception(node) and not _handler_reraises(node):
            yield ctx.violation(
                "DLC004",
                node,
                "`except BaseException` without a re-raise swallows "
                "KeyboardInterrupt; re-raise after cleanup or catch "
                "Exception",
            )


register(
    Rule(
        id="DLC004",
        name="interrupt-swallowing-except",
        doc="no bare except / BaseException handlers that fail to re-raise",
        check=_check_swallowed_interrupts,
    )
)

# --- DLC005: substring-based pytree param-name matching --------------------
# `'norm' in leaf` also matches 'normalizer_proj' — a layer that should
# receive weight decay silently stops decaying (train/trainer.py:124 was
# exactly this).  Param-name predicates must anchor: exact match or
# whole-component match on '_'-split names.

_PARAM_NAME_MARKERS = ("leaf", "param")


def _names_a_param(node: ast.AST) -> bool:
    name = dotted_name(node)
    if name is None:
        return False
    terminal = name.rsplit(".", 1)[-1].lower()
    return any(marker in terminal for marker in _PARAM_NAME_MARKERS)


def _check_substring_param_match(
    tree: ast.Module, ctx: FileContext
) -> Iterator[Violation]:
    for node in ast.walk(tree):
        if not isinstance(node, ast.Compare):
            continue
        if not (
            isinstance(node.left, ast.Constant) and isinstance(node.left.value, str)
        ):
            continue
        for op, comparator in zip(node.ops, node.comparators):
            if isinstance(op, (ast.In, ast.NotIn)) and _names_a_param(comparator):
                yield ctx.violation(
                    "DLC005",
                    node,
                    f"substring match {node.left.value!r} in a param/leaf "
                    "name also matches unrelated layers (e.g. "
                    "'normalizer_proj'); use exact or '_'-component-"
                    "anchored matching",
                )


register(
    Rule(
        id="DLC005",
        name="substring-param-match",
        doc="pytree param-name predicates must anchor, not substring-match",
        check=_check_substring_param_match,
    )
)

# --- DLC006: threads without a daemon flag or join path --------------------
# A non-daemon thread with no join keeps the interpreter alive after main
# exits (the classic hung-agent-on-shutdown); a daemon=True producer is
# the repo idiom (train/data.py PrefetchIterator).  Either state
# daemon= explicitly or join the thread somewhere in the same scope.


def _scope_has_join(node: ast.AST, ctx: FileContext) -> bool:
    scope = ctx.enclosing(node, ast.ClassDef) or ctx.enclosing(
        node, ast.FunctionDef, ast.AsyncFunctionDef
    ) or ctx.tree
    for n in ast.walk(scope):
        if (
            isinstance(n, ast.Call)
            and isinstance(n.func, ast.Attribute)
            and n.func.attr == "join"
        ):
            return True
    return False


def _check_thread_daemon(tree: ast.Module, ctx: FileContext) -> Iterator[Violation]:
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = call_name(node)
        if name not in ("threading.Thread", "Thread"):
            continue
        if has_keyword(node, "daemon"):
            continue
        if _scope_has_join(node, ctx):
            continue
        yield ctx.violation(
            "DLC006",
            node,
            "Thread() without daemon= and with no join path in scope: "
            "the thread outlives (and can hang) interpreter shutdown",
        )


register(
    Rule(
        id="DLC006",
        name="thread-without-daemon",
        doc="threads must state daemon= or have a join path",
        check=_check_thread_daemon,
    )
)

# --- DLC007: mutable default arguments + Python-2 remnants -----------------
# The cluster scripts descend from a py2 CloudFormation codebase; remnants
# (xrange, dict.iteritems, has_key) crash at runtime on py3, and mutable
# defaults alias state across calls — both pure foot-guns with zero
# legitimate uses here.

_PY2_NAMES = ("xrange", "basestring")
_PY2_METHODS = ("has_key", "iteritems", "iterkeys", "itervalues")


def _is_mutable_default(node: ast.AST | None) -> bool:
    if isinstance(node, (ast.List, ast.Dict, ast.Set)):
        return True
    if isinstance(node, ast.Call) and not node.args and not node.keywords:
        return call_name(node) in ("list", "dict", "set")
    return False


def _check_py_hygiene(tree: ast.Module, ctx: FileContext) -> Iterator[Violation]:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defaults = list(node.args.defaults) + [
                d for d in node.args.kw_defaults if d is not None
            ]
            for d in defaults:
                if _is_mutable_default(d):
                    yield ctx.violation(
                        "DLC007",
                        d,
                        f"mutable default argument in {node.name}() aliases "
                        "state across calls; default to None and construct "
                        "inside",
                    )
        elif isinstance(node, ast.Name) and node.id in _PY2_NAMES:
            yield ctx.violation(
                "DLC007", node, f"python-2 remnant {node.id!r} does not exist on py3"
            )
        elif isinstance(node, ast.Attribute) and node.attr in _PY2_METHODS:
            yield ctx.violation(
                "DLC007",
                node,
                f"python-2 remnant .{node.attr}() does not exist on py3 dicts",
            )


register(
    Rule(
        id="DLC007",
        name="py-hygiene",
        doc="no mutable default args; no python-2 remnants",
        check=_check_py_hygiene,
    )
)

# --- DLC008: state steps must update in place -----------------------------
# A train step that rebinds the state's tensors (`p.data = p - lr * g`,
# `state.field = <arithmetic>`) holds BOTH copies live across the update —
# the port's form of a JAX step without donation — and a captured graph
# keeps reading the old storage.  The repo idiom is an in-place update
# (the optimizers' foreach kernels, copy_, DCP loading into the live
# tensors).  DLC401 (gated) widens the shape.


def _check_out_of_place_step(tree: ast.Module, ctx: FileContext) -> Iterator[Violation]:
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        first = state_typed_first_param(fn)
        if first is None or first.arg != "state" or not step_like(fn.name):
            continue
        for node, what in out_of_place_rebinds(fn, "state"):
            yield ctx.violation(
                "DLC008",
                node,
                f"{fn.name}(state, ...) rebinds a state tensor out of place "
                f"({what}): two full state copies stay live and a captured "
                "graph keeps the old storage; update the state in place",
            )


register(
    Rule(
        id="DLC008",
        name="undonated-state-jit",
        doc="state-threading steps must update the state in place",
        check=_check_out_of_place_step,
    )
)
