"""DLC2xx: the concurrency lockset / thread-escape analyzer (the port's copy).

The control plane is genuinely concurrent — Heartbeater daemon
threads, the DevicePrefetcher producers, the FlightRecorder ring — and
control-plane races are exactly the class of silent failure large-scale
systems papers identify as the dominant source of distributed-training
flakiness.  These rules encode the repo's threading discipline:

DLC201 unlocked-shared-attribute  attribute written from thread-side code
                                  (a Thread subclass's run() closure, or a
                                  ``target=self.method``) and visible
                                  outside the thread without a common lock
DLC202 bare-acquire               ``lock.acquire()`` as a statement with no
                                  try/finally release — an exception leaks
                                  the lock forever
DLC203 blocking-under-lock        socket/subprocess/sleep inside a
                                  ``with <lock>:`` body — every other
                                  thread stalls behind one peer's I/O
DLC204 daemon-without-stop        a daemon thread with neither a stop
                                  Event nor a join path — "daemon" becomes
                                  "unkillable until process exit"
DLC205 wall-clock-liveness        ``time.time()`` arithmetic/comparison in
                                  cluster/obs timing paths — NTP steps the
                                  wall clock; liveness and retry deadlines
                                  must use time.monotonic() (the broker
                                  side already uses std::chrono::steady_clock)

Like the DLC0xx rules, every matcher anchors on the bug's shape, not a
keyword: DLC201 only fires on classes that actually spawn a thread at one
of their own methods, DLC203 only inside a lock-typed ``with``, DLC205
only where the timestamp feeds arithmetic or a deadline-named binding
(record metadata like ``"started_ts": time.time()`` stays legal).

All five are gated behind ``dlcfn lint --concurrency`` (or an explicit
``--select``), so the pass ratchets via the committed baseline instead of
flag-flooding a previously-clean tree.
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
)

GATE = "concurrency"
RULE_IDS = ("DLC201", "DLC202", "DLC203", "DLC204", "DLC205")

_LOCK_FACTORIES = {
    "threading.Lock",
    "threading.RLock",
    "threading.Condition",
    "Lock",
    "RLock",
    "Condition",
}
# Attribute types that are themselves synchronization/thread-safe
# primitives: writes to (or through) them do not need an extra lock.
_SAFE_FACTORIES = _LOCK_FACTORIES | {
    "threading.Event",
    "Event",
    "threading.Semaphore",
    "threading.BoundedSemaphore",
    "Semaphore",
    "queue.Queue",
    "Queue",
    "collections.deque",
    "deque",
}

_THREAD_NAMES = ("threading.Thread", "Thread")


def _is_thread_class(cls: ast.ClassDef) -> bool:
    return any(dotted_name(b) in _THREAD_NAMES for b in cls.bases)


def _self_attr(node: ast.AST) -> str | None:
    """'x' for a ``self.x`` attribute node, else None."""
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _attr_factories(cls: ast.ClassDef) -> dict[str, set[str]]:
    """attr name -> dotted names of calls ever assigned to ``self.attr``."""
    out: dict[str, set[str]] = {}
    for node in ast.walk(cls):
        if not isinstance(node, ast.Assign):
            continue
        for target in node.targets:
            attr = _self_attr(target)
            if attr is None:
                continue
            name = (
                call_name(node.value) if isinstance(node.value, ast.Call) else None
            )
            out.setdefault(attr, set()).add(name or "")
    return out


def _thread_side_methods(cls: ast.ClassDef) -> set[str]:
    """Methods that execute on a spawned thread: ``run`` of a Thread
    subclass, every ``target=self.m``, and the closure of self-calls
    reachable from those entries."""
    methods = {
        fn.name: fn
        for fn in cls.body
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
    }
    entries: set[str] = set()
    if _is_thread_class(cls) and "run" in methods:
        entries.add("run")
    for node in ast.walk(cls):
        if isinstance(node, ast.Call) and call_name(node) in _THREAD_NAMES:
            kw = keyword(node, "target")
            if kw is not None:
                attr = _self_attr(kw.value)
                if attr in methods:
                    entries.add(attr)
    # Transitive closure over self.<m>() calls.
    frontier = list(entries)
    while frontier:
        fn = methods.get(frontier.pop())
        if fn is None:
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                callee = _self_attr(node.func)
                if callee in methods and callee not in entries:
                    entries.add(callee)
                    frontier.append(callee)
    return entries


def _under_lock(node: ast.AST, ctx: FileContext, lock_attrs: set[str]) -> bool:
    """Is ``node`` lexically inside ``with self.<lock>:`` for a known lock?"""
    cur = ctx.parents.get(node)
    while cur is not None:
        if isinstance(cur, ast.With):
            for item in cur.items:
                if _self_attr(item.context_expr) in lock_attrs:
                    return True
        cur = ctx.parents.get(cur)
    return False


def _check_unlocked_shared_attr(
    tree: ast.Module, ctx: FileContext
) -> Iterator[Violation]:
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        thread_side = _thread_side_methods(cls)
        if not thread_side:
            continue
        factories = _attr_factories(cls)
        lock_attrs = {
            a for a, fs in factories.items() if fs & _LOCK_FACTORIES
        }
        safe_attrs = {a for a, fs in factories.items() if fs & _SAFE_FACTORIES}
        methods = [
            fn
            for fn in cls.body
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]
        # attr -> (node of first unlocked thread-side write, method name)
        unlocked_writes: dict[str, tuple[ast.AST, str]] = {}
        main_unlocked: set[str] = set()
        for fn in methods:
            if fn.name == "__init__":
                continue  # construction happens-before the thread starts
            for node in ast.walk(fn):
                attr = _self_attr(node)
                if attr is None or attr in safe_attrs:
                    continue
                assert isinstance(node, ast.Attribute)
                if fn.name in thread_side:
                    if isinstance(node.ctx, ast.Store) and not _under_lock(
                        node, ctx, lock_attrs
                    ):
                        unlocked_writes.setdefault(attr, (node, fn.name))
                else:
                    if not _under_lock(node, ctx, lock_attrs):
                        main_unlocked.add(attr)
        for attr, (node, method) in sorted(unlocked_writes.items()):
            # Escapes the thread if the class's own main-side code touches
            # it without the lock, or if it is public API (readable by any
            # caller while the thread mutates it).
            if attr in main_unlocked or not attr.startswith("_"):
                yield ctx.violation(
                    "DLC201",
                    node,
                    f"self.{attr} is written in thread-side "
                    f"{cls.name}.{method}() without a lock but is visible "
                    "outside the thread; guard both sides with a common "
                    "`with self.<lock>:`",
                )


register(
    Rule(
        id="DLC201",
        name="unlocked-shared-attribute",
        doc="thread-side attribute writes visible outside the thread need a lock",
        check=_check_unlocked_shared_attr,
        gate=GATE,
    )
)

# --- DLC202: bare acquire() ------------------------------------------------

_LOCKISH_MARKERS = ("lock", "mutex", "sem", "cond")


def _is_lockish(expr: ast.AST) -> bool:
    name = dotted_name(expr)
    if name is None:
        return False
    terminal = name.rsplit(".", 1)[-1].lower()
    return any(marker in terminal for marker in _LOCKISH_MARKERS)


def _releases(try_node: ast.Try, receiver: str) -> bool:
    for stmt in try_node.finalbody:
        for node in ast.walk(stmt):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "release"
                and dotted_name(node.func.value) == receiver
            ):
                return True
    return False


def _check_bare_acquire(tree: ast.Module, ctx: FileContext) -> Iterator[Violation]:
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Expr) and isinstance(node.value, ast.Call)):
            continue
        call = node.value
        if not (
            isinstance(call.func, ast.Attribute)
            and call.func.attr == "acquire"
            and _is_lockish(call.func.value)
        ):
            continue
        receiver = dotted_name(call.func.value) or ""
        # Clean shape: acquire() guarded by a try/finally that releases the
        # same receiver — either the acquire sits inside the try, or the
        # try is a sibling in the same block right after it.
        enclosing_try = ctx.enclosing(node, ast.Try)
        if isinstance(enclosing_try, ast.Try) and _releases(enclosing_try, receiver):
            continue
        parent = ctx.parents.get(node)
        siblings: list[ast.stmt] = []
        for attr in ("body", "orelse", "finalbody"):
            block = getattr(parent, attr, None)
            if isinstance(block, list) and node in block:
                siblings = block
        idx = siblings.index(node) if node in siblings else -1
        follower = siblings[idx + 1] if 0 <= idx < len(siblings) - 1 else None
        if isinstance(follower, ast.Try) and _releases(follower, receiver):
            continue
        yield ctx.violation(
            "DLC202",
            node,
            f"{receiver}.acquire() with no try/finally release: an "
            "exception before the release leaks the lock forever; use "
            f"`with {receiver}:` (or release in a finally)",
        )


register(
    Rule(
        id="DLC202",
        name="bare-acquire",
        doc="acquire() must be `with lock:` or paired with try/finally release",
        check=_check_bare_acquire,
        gate=GATE,
    )
)

# --- DLC203: blocking I/O while holding a lock -----------------------------
# File writes are deliberately NOT in this list: the FlightRecorder
# journals under its lock by design (local appends, bounded lines).  The
# bug shape is unbounded waits — network, child processes, sleeps — that
# stall every thread queued on the lock behind one peer's I/O.

_BLOCKING_CALLS = {
    "time.sleep",
    "socket.create_connection",
    "urllib.request.urlopen",
}
_BLOCKING_PREFIXES = ("subprocess.", "requests.")
_SOCK_METHODS = ("recv", "sendall", "connect", "accept")
_SOCK_MARKERS = ("sock", "conn")
_PROC_METHODS = ("wait", "communicate")
_PROC_MARKERS = ("proc", "process", "popen", "child")


def _receiver_matches(func: ast.Attribute, markers: tuple[str, ...]) -> bool:
    name = dotted_name(func.value)
    if name is None:
        return False
    terminal = name.rsplit(".", 1)[-1].lower()
    return any(marker in terminal for marker in markers)


def _blocking_call(node: ast.Call) -> str | None:
    name = call_name(node)
    if name in _BLOCKING_CALLS or (
        name and name.startswith(_BLOCKING_PREFIXES)
    ):
        return f"{name}()"
    if isinstance(node.func, ast.Attribute):
        if node.func.attr in _SOCK_METHODS and _receiver_matches(
            node.func, _SOCK_MARKERS
        ):
            return f".{node.func.attr}() on a socket"
        if node.func.attr in _PROC_METHODS and _receiver_matches(
            node.func, _PROC_MARKERS
        ):
            return f".{node.func.attr}() on a subprocess"
    return None


def _check_blocking_under_lock(
    tree: ast.Module, ctx: FileContext
) -> Iterator[Violation]:
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        what = _blocking_call(node)
        if what is None:
            continue
        cur = ctx.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                break  # a nested def's body runs later, not under the with
            if isinstance(cur, ast.With) and any(
                _is_lockish(item.context_expr) for item in cur.items
            ):
                yield ctx.violation(
                    "DLC203",
                    node,
                    f"{what} while holding a lock blocks every thread "
                    "queued on it; move the I/O outside the `with` and "
                    "only mutate shared state under the lock",
                )
                break
            cur = ctx.parents.get(cur)


register(
    Rule(
        id="DLC203",
        name="blocking-under-lock",
        doc="no socket/subprocess/sleep calls inside a `with <lock>:` body",
        check=_check_blocking_under_lock,
        gate=GATE,
    )
)

# --- DLC204: daemon threads without a stop path ----------------------------
# daemon=True satisfies DLC006 (interpreter shutdown) but is not a
# lifecycle: a daemon loop with no stop Event and no join is unstoppable
# in-process — tests leak it, agents cannot drain it before teardown.
# The repo idiom is Heartbeater: a halt Event plus stop()->join().


def _scope_has_stop_path(scope: ast.AST) -> bool:
    for node in ast.walk(scope):
        if isinstance(node, ast.Call):
            if call_name(node) in ("threading.Event", "Event"):
                return True
            if isinstance(node.func, ast.Attribute) and node.func.attr == "join":
                return True
    return False


def _daemon_true(call: ast.Call) -> bool:
    kw = keyword(call, "daemon")
    return (
        kw is not None
        and isinstance(kw.value, ast.Constant)
        and kw.value.value is True
    )


def _class_sets_daemon(cls: ast.ClassDef) -> bool:
    for node in ast.walk(cls):
        if isinstance(node, ast.Call) and _daemon_true(node):
            return True
        if isinstance(node, ast.Assign):
            for target in node.targets:
                if (
                    _self_attr(target) == "daemon"
                    and isinstance(node.value, ast.Constant)
                    and node.value.value is True
                ):
                    return True
    return False


def _check_daemon_without_stop(
    tree: ast.Module, ctx: FileContext
) -> Iterator[Violation]:
    flagged_classes: set[ast.ClassDef] = set()
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        if _is_thread_class(cls) and _class_sets_daemon(cls):
            if not _scope_has_stop_path(cls):
                flagged_classes.add(cls)
                yield ctx.violation(
                    "DLC204",
                    cls,
                    f"daemon Thread subclass {cls.name} has no stop Event "
                    "and no join path: the loop is unstoppable in-process; "
                    "add a halt Event and a stop() that joins",
                )
    for node in ast.walk(tree):
        if not (
            isinstance(node, ast.Call)
            and call_name(node) in _THREAD_NAMES
            and _daemon_true(node)
        ):
            continue
        scope = ctx.enclosing(node, ast.ClassDef) or ctx.tree
        if scope in flagged_classes:
            continue  # already reported at the class level
        if not _scope_has_stop_path(scope):
            yield ctx.violation(
                "DLC204",
                node,
                "daemon Thread with no stop Event and no join path in "
                "scope: nothing can stop the loop before process exit; "
                "pair it with a threading.Event (or join it)",
            )


register(
    Rule(
        id="DLC204",
        name="daemon-without-stop",
        doc="daemon threads need a stop Event or join path",
        check=_check_daemon_without_stop,
        gate=GATE,
    )
)

# --- DLC205: wall-clock time in liveness/retry paths -----------------------

_DEADLINE_MARKERS = (
    "deadline",
    "expires",
    "expiry",
    "until",
    "cutoff",
    "last_beat",
)


def _applies_timing_paths(path: Path) -> bool:
    parts = path.parts
    return "cluster" in parts or "obs" in parts or "provision" in parts


def _deadline_named(target: ast.AST) -> bool:
    name = dotted_name(target)
    if name is None:
        return False
    terminal = name.rsplit(".", 1)[-1].lower()
    return any(marker in terminal for marker in _DEADLINE_MARKERS)


def _check_wall_clock_liveness(
    tree: ast.Module, ctx: FileContext
) -> Iterator[Violation]:
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and call_name(node) == "time.time"):
            continue
        parent = ctx.parents.get(node)
        fires = isinstance(parent, (ast.BinOp, ast.Compare))
        if isinstance(parent, ast.Assign) and any(
            _deadline_named(t) for t in parent.targets
        ):
            fires = True
        if fires:
            yield ctx.violation(
                "DLC205",
                node,
                "time.time() used for elapsed-time/deadline logic: NTP "
                "steps the wall clock backwards and forwards; use "
                "time.monotonic() (the broker side already uses "
                "std::chrono::steady_clock)",
            )


register(
    Rule(
        id="DLC205",
        name="wall-clock-liveness",
        doc="liveness/retry timing in cluster/obs must use time.monotonic()",
        check=_check_wall_clock_liveness,
        applies=_applies_timing_paths,
        gate=GATE,
    )
)
