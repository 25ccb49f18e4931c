"""The lint framework: rule registry, AST context, noqa suppression.

A rule is a function ``check(tree, ctx) -> iterable[Violation]`` plus
metadata, registered in :data:`FILE_RULES`.  :func:`lint_source` parses
one file, builds a :class:`FileContext` (parent links, per-line
suppressions), runs every applicable rule, and filters suppressed
findings.

Suppression is per physical line, flake8-style but namespaced so it can
never collide with other linters' noqa semantics::

    proc.wait()  # dlcfn: noqa[DLC001] build step is externally supervised

The rule list in brackets is mandatory (a blanket ``noqa`` suppressing
every rule hides future findings on the line); the trailing free text is
the required human reason.
"""

from __future__ import annotations

import ast
import re
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Callable, Iterable, Iterator

_NOQA = re.compile(r"#\s*dlcfn:\s*noqa\[([A-Z0-9,\s]+)\]")


@dataclass(frozen=True)
class Violation:
    rule: str
    path: str
    line: int
    col: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"

    def to_dict(self) -> dict:
        return asdict(self)


@dataclass(frozen=True)
class Rule:
    """One registered check.

    ``applies(path)`` scopes path-specific rules (e.g. DLC002 only
    guards bench/metrics emitters); the default is every file.

    ``gate`` names an opt-in pass ("concurrency"): gated rules run only
    when explicitly selected (``--select DLC2xx`` or the pass flag), so
    growing the rule set never changes what a plain ``dlcfn lint``
    reports out from under the baseline.
    """

    id: str
    name: str
    doc: str
    check: Callable[[ast.Module, "FileContext"], Iterable[Violation]]
    applies: Callable[[Path], bool] = field(default=lambda _p: True)
    gate: str | None = None


FILE_RULES: dict[str, Rule] = {}


def register(rule: Rule) -> Rule:
    if rule.id in FILE_RULES:
        raise ValueError(f"duplicate rule id {rule.id}")
    FILE_RULES[rule.id] = rule
    return rule


class FileContext:
    """Shared per-file state handed to every rule."""

    def __init__(self, path: Path, source: str, tree: ast.Module):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        self.parents: dict[ast.AST, ast.AST] = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
        self.suppressions = self._parse_noqa()

    def _parse_noqa(self) -> dict[int, set[str]]:
        out: dict[int, set[str]] = {}
        for i, line in enumerate(self.lines, start=1):
            m = _NOQA.search(line)
            if m:
                out[i] = {r.strip() for r in m.group(1).split(",") if r.strip()}
        return out

    def violation(self, rule_id: str, node: ast.AST, message: str) -> Violation:
        return Violation(
            rule=rule_id,
            path=str(self.path),
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0) + 1,
            message=message,
        )

    def suppressed(self, v: Violation) -> bool:
        return v.rule in self.suppressions.get(v.line, set())

    # --- rule helpers -----------------------------------------------------
    def enclosing(self, node: ast.AST, *types: type) -> ast.AST | None:
        """Nearest ancestor of one of ``types`` (not the node itself)."""
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, types):
                return cur
            cur = self.parents.get(cur)
        return None

    def enclosing_function(
        self, node: ast.AST
    ) -> ast.FunctionDef | ast.AsyncFunctionDef | None:
        fn = self.enclosing(node, ast.FunctionDef, ast.AsyncFunctionDef)
        return fn  # type: ignore[return-value]


def dotted_name(node: ast.AST) -> str | None:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts: list[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
        return ".".join(reversed(parts))
    return None


def call_name(call: ast.Call) -> str | None:
    return dotted_name(call.func)


def keyword(call: ast.Call, name: str) -> ast.keyword | None:
    for kw in call.keywords:
        if kw.arg == name:
            return kw
    return None


def has_keyword(call: ast.Call, *names: str) -> bool:
    return any(kw.arg in names for kw in call.keywords)


def walk_skipping_nested_functions(body: Iterable[ast.AST]) -> Iterator[ast.AST]:
    """Walk statements without descending into nested def/class scopes —
    for rules whose question is "does THIS scope do X"."""
    nested = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)
    stack = list(body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, nested):
            # A def/class that is itself a statement of the walked scope:
            # yield it (so callers can see the boundary) but do not
            # descend — its body is a different scope.
            continue
        stack.extend(ast.iter_child_nodes(node))


def lint_source(
    path: Path | str,
    source: str | None = None,
    select: set[str] | None = None,
) -> list[Violation]:
    """Lint one Python file.  ``select`` limits to specific rule ids."""
    path = Path(path)
    if source is None:
        source = path.read_text()
    try:
        tree = ast.parse(source, filename=str(path))
    except SyntaxError as e:
        return [
            Violation(
                rule="DLC000",
                path=str(path),
                line=e.lineno or 1,
                col=(e.offset or 0) + 1,
                message=f"file does not parse: {e.msg}",
            )
        ]
    ctx = FileContext(path, source, tree)
    out: list[Violation] = []
    for rule in FILE_RULES.values():
        if select is not None and rule.id not in select:
            continue
        if select is None and rule.gate is not None:
            continue  # gated passes are opt-in (runner/CLI selects them)
        if not rule.applies(path):
            continue
        for v in rule.check(tree, ctx):
            if not ctx.suppressed(v):
                out.append(v)
    out.sort(key=lambda v: (v.path, v.line, v.col, v.rule))
    return out
