"""DLC3xx: the broker protocol state-machine / message-shape checker (the
port's copy: its ``cluster/`` and ``provision/`` against the C++ broker).

DLC100 proves every layer *names* the same verbs; these rules prove the
layers agree on each verb's *message shape* — the drift DLC100 cannot
see (client sends three request tokens, C++ extracts two; broker renames
a reply token; an HB frame loses a field).  Four homes are cross-checked:

1. the canonical per-verb spec comments on
   ``cluster/contract.py:BROKER_PROTOCOL_VERBS`` (``# SEND <queue>
   <nbytes>\\n<body> ...`` — machine-read, so the docs cannot rot);
2. the Python client's wire writes and reply parsing
   (``cluster/broker_client.py``, via AST);
3. the C++ handler chain (``native/broker/broker.cpp``, via the same
   tolerant segment scan DLC100 uses — no C++ parser);
4. the lifecycle-kind vocabulary: ``EventKind`` members, the kinds
   publishers construct, the kinds the elasticity controller dispatches,
   and the flight-journal ``kind`` strings consumers filter on.

DLC300 request-shape drift   per-verb argument count + payload presence:
                             canonical spec vs client template vs C++
                             ``>>`` extraction / read_exact
DLC301 reply-token drift     every reply token the client tests for
                             (``== "PONG"``, ``startswith("OK ")``) must
                             be one the C++ handler emits for that verb
DLC302 frame-shape drift     multi-line frames (MSG/HB): tag + token
                             arity the client unpacks vs what the C++
                             response concatenation emits
DLC303 lifecycle-kind drift  ``EventKind.X`` references must be defined
                             members; every published kind must be
                             dispatched by the elasticity controller;
                             every journal ``kind=`` a reader filters on
                             must be one some ``record()`` call produces

Like contract_check, every extractor takes its source path as an
argument so tests can run the checker against mutated fixture copies.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Iterable

from deeplearning_cfn_tpu_torch.analysis.core import Violation, dotted_name
from deeplearning_cfn_tpu_torch.analysis.contract_check import (
    BROKER_CPP,
    CLIENT_PY,
    CONTRACT_PY,
    REPO_ROOT,
    _CPP_HANDLER,
    _parse,
    canonical_verbs,
    client_verb_map,
)

RULE_REQUEST = "DLC300"
RULE_REPLY = "DLC301"
RULE_FRAME = "DLC302"
RULE_LIFECYCLE = "DLC303"

EVENTS_PY = REPO_ROOT / "deeplearning_cfn_tpu_torch" / "provision" / "events.py"
ELASTICITY_PY = REPO_ROOT / "deeplearning_cfn_tpu_torch" / "cluster" / "elasticity.py"
PACKAGE_DIR = REPO_ROOT / "deeplearning_cfn_tpu_torch"

# One request shape: (argument token count, carries a length-prefixed payload).
Shape = tuple[int, bool]

_TOKEN = re.compile(r"^[A-Z]{1,16}$")
_SPEC_ARGS = re.compile(r"^(?:\s*<\w+>)*")


# --- layer 1: canonical shapes from the contract.py spec comments ----------
def canonical_shapes(contract_py: Path = CONTRACT_PY) -> dict[str, set[Shape]]:
    """verb -> request shapes, parsed from the ``# VERB <arg>...`` comment
    lines inside the BROKER_PROTOCOL_VERBS assignment.  A verb may carry
    several spec lines (HEARTBEAT's record and dump modes)."""
    verbs, _ = canonical_verbs(contract_py)
    source = contract_py.read_text()
    m = re.search(
        r"BROKER_PROTOCOL_VERBS\s*(?::[^=]+)?=\s*\(", source
    )
    if m is None:
        return {}
    depth = 0
    end = m.end()
    for i in range(m.end() - 1, len(source)):
        if source[i] == "(":
            depth += 1
        elif source[i] == ")":
            depth -= 1
            if depth == 0:
                end = i
                break
    segment = source[m.start():end]
    out: dict[str, set[Shape]] = {}
    for comment in re.findall(r"#\s*([A-Z]{2,16})\b([^\n]*)", segment):
        verb, rest = comment
        if verb not in verbs:
            continue
        args_m = _SPEC_ARGS.match(rest)
        head = args_m.group(0) if args_m else ""
        nargs = len(re.findall(r"<\w+>", head))
        # A payload spec is the literal two-character "\n" followed by a
        # <name> token, immediately after the argument list.
        payload = rest[len(head):].startswith("\\n<")
        out.setdefault(verb, set()).add((nargs, payload))
    return out


# --- layer 2: client request shapes, reply tokens, frames ------------------
def _header_template(expr: ast.AST) -> tuple[str | None, bool]:
    """(header text with {} placeholders, payload appended?) for a
    ``sendall`` argument.  Mirrors contract_check._leading_literal but
    keeps the whole first line, so token arity is recoverable."""
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Add):
        header, _ = _header_template(expr.left)
        return header, True
    if (
        isinstance(expr, ast.Call)
        and isinstance(expr.func, ast.Attribute)
        and expr.func.attr == "encode"
    ):
        return _header_template(expr.func.value)
    if isinstance(expr, ast.JoinedStr):
        parts: list[str] = []
        for value in expr.values:
            if isinstance(value, ast.Constant) and isinstance(value.value, str):
                parts.append(value.value)
            else:
                parts.append("{}")
        return "".join(parts), False
    if isinstance(expr, ast.Constant):
        if isinstance(expr.value, bytes):
            return expr.value.decode(errors="replace"), False
        if isinstance(expr.value, str):
            return expr.value, False
    return None, False


def client_request_shapes(client_py: Path = CLIENT_PY) -> dict[str, set[Shape]]:
    """verb -> (token count, payload?) shapes the client writes."""
    tree = _parse(client_py)
    out: dict[str, set[Shape]] = {}
    for node in ast.walk(tree):
        if not (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "sendall"
            and node.args
        ):
            continue
        header, payload = _header_template(node.args[0])
        if header is None:
            continue
        tokens = header.split("\n", 1)[0].split()
        if not tokens or not _TOKEN.fullmatch(tokens[0]):
            continue
        out.setdefault(tokens[0], set()).add((len(tokens) - 1, payload))
    return out


def _expected_tokens(fn: ast.AST) -> set[str]:
    """Reply tokens a client method tests for: ``== "PONG"`` /
    ``!= "OK"`` comparisons and ``.startswith("OK ")`` prefixes."""
    out: set[str] = set()

    def first_token(text: str) -> str | None:
        parts = text.split()
        if parts and _TOKEN.fullmatch(parts[0]):
            return parts[0]
        return None

    for node in ast.walk(fn):
        if isinstance(node, ast.Compare):
            for side in [node.left, *node.comparators]:
                if isinstance(side, ast.Constant) and isinstance(side.value, str):
                    token = first_token(side.value)
                    if token:
                        out.add(token)
        elif (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "startswith"
            and node.args
            and isinstance(node.args[0], ast.Constant)
            and isinstance(node.args[0].value, str)
        ):
            token = first_token(node.args[0].value)
            if token:
                out.add(token)
    return out


def _client_frames(fn: ast.AST) -> dict[str, set[int]]:
    """frame tag -> token arities a client method unpacks.  Anchored on
    the ``v = self._read_line().split(" ")`` idiom: ``v[0] != "TAG"``
    names the tag; ``len(v) != N`` and tuple-unpacks of ``v`` fix arity."""
    frame_vars: set[str] = set()
    for node in ast.walk(fn):
        if (
            isinstance(node, ast.Assign)
            and isinstance(node.value, ast.Call)
            and isinstance(node.value.func, ast.Attribute)
            and node.value.func.attr == "split"
        ):
            for target in node.targets:
                if isinstance(target, ast.Name):
                    frame_vars.add(target.id)
    if not frame_vars:
        return {}
    tags: set[str] = set()
    arities: set[int] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Compare):
            left, comparators = node.left, node.comparators
            # v[0] != "TAG"
            if (
                isinstance(left, ast.Subscript)
                and isinstance(left.value, ast.Name)
                and left.value.id in frame_vars
            ):
                for comp in comparators:
                    if isinstance(comp, ast.Constant) and isinstance(comp.value, str):
                        if _TOKEN.fullmatch(comp.value):
                            tags.add(comp.value)
            # len(v) != N
            if (
                isinstance(left, ast.Call)
                and dotted_name(left.func) == "len"
                and left.args
                and isinstance(left.args[0], ast.Name)
                and left.args[0].id in frame_vars
            ):
                for comp in comparators:
                    if isinstance(comp, ast.Constant) and isinstance(comp.value, int):
                        arities.add(comp.value)
        elif isinstance(node, ast.Assign):
            # _, mid, receipt, count, length = v
            if isinstance(node.value, ast.Name) and node.value.id in frame_vars:
                for target in node.targets:
                    if isinstance(target, (ast.Tuple, ast.List)):
                        arities.add(len(target.elts))
    return {tag: set(arities) for tag in tags}


def client_reply_contract(
    client_py: Path = CLIENT_PY,
) -> tuple[dict[str, set[str]], dict[str, dict[str, set[int]]]]:
    """(verb -> expected reply tokens, verb -> frame tag -> arities),
    unioned across the client methods that send each verb."""
    tree = _parse(client_py)
    verb_map = client_verb_map(client_py)
    tokens: dict[str, set[str]] = {}
    frames: dict[str, dict[str, set[int]]] = {}
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        for fn in cls.body:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            verbs = verb_map.get(fn.name)
            if not verbs:
                continue
            fn_tokens = _expected_tokens(fn)
            fn_frames = _client_frames(fn)
            for verb in verbs:
                tokens.setdefault(verb, set()).update(fn_tokens)
                per_verb = frames.setdefault(verb, {})
                for tag, arities in fn_frames.items():
                    per_verb.setdefault(tag, set()).update(arities)
    # Frame tags double as expected tokens only for frame parsing; keep
    # them out of the scalar reply-token set (they are checked by DLC302).
    for verb, per_verb in frames.items():
        tokens.get(verb, set()).difference_update(per_verb)
    return tokens, frames


# --- layer 3: the C++ handler chain ----------------------------------------
_CPP_LITERAL = re.compile(r'"((?:[^"\\]|\\.)*)"')


def _cpp_segments(broker_cpp: Path = BROKER_CPP) -> dict[str, str]:
    """verb -> handler segment text (from its ``cmd == "VERB"`` test to
    the next handler's)."""
    text = broker_cpp.read_text(errors="replace")
    matches = list(_CPP_HANDLER.finditer(text))
    out: dict[str, str] = {}
    for i, m in enumerate(matches):
        verb = m.group(1) or m.group(2)
        end = matches[i + 1].start() if i + 1 < len(matches) else len(text)
        out[verb] = text[m.start():end]
    return out


def cpp_request_shapes(broker_cpp: Path = BROKER_CPP) -> dict[str, Shape]:
    """verb -> (number of ``>>`` extractions, reads a payload?)."""
    return {
        verb: (segment.count(">>"), "read_exact(" in segment)
        for verb, segment in _cpp_segments(broker_cpp).items()
    }


def cpp_reply_contract(
    broker_cpp: Path = BROKER_CPP,
) -> tuple[dict[str, set[str]], dict[str, dict[str, int]]]:
    """(verb -> emitted reply tokens, verb -> frame tag -> token arity).

    Reply tokens come from the first token of every string literal in the
    handler segment (``write_all(fd, "OK " ...)``, ``resp = "N " ...``);
    frames from ``resp += "TAG " ...`` concatenations, whose arity is the
    tag + trailing fields joined by standalone ``" "`` separators."""
    tokens: dict[str, set[str]] = {}
    frames: dict[str, dict[str, int]] = {}
    for verb, segment in _cpp_segments(broker_cpp).items():
        verb_tokens: set[str] = set()
        verb_frames: dict[str, int] = {}
        for m in _CPP_LITERAL.finditer(segment):
            literal = m.group(1)
            first = literal.split("\\n")[0].split()
            if first and _TOKEN.fullmatch(first[0]):
                verb_tokens.add(first[0])
        for stmt_m in re.finditer(r"resp\s*\+=\s*([^;]*);", segment):
            stmt = stmt_m.group(1)
            literals = _CPP_LITERAL.findall(stmt)
            if not literals:
                continue
            head = literals[0].split("\\n")[0]
            lead = head.split()
            if not lead or not _TOKEN.fullmatch(lead[0]):
                continue
            # Tokens: those inside the lead literal, plus the field its
            # trailing space opens, plus one per standalone " " separator
            # ("MSG " + id + " " + receipt + ... -> 2 + separators).
            arity = (
                len(lead)
                + (1 if head.endswith(" ") else 0)
                + sum(1 for lit in literals[1:] if lit == " ")
            )
            verb_frames[lead[0]] = arity
        tokens[verb] = verb_tokens
        frames[verb] = verb_frames
    return tokens, frames


# --- the wire-shape check --------------------------------------------------
def check_protocol(
    contract_py: Path = CONTRACT_PY,
    client_py: Path = CLIENT_PY,
    broker_cpp: Path = BROKER_CPP,
) -> list[Violation]:
    out: list[Violation] = []

    def v(rule: str, path: Path, msg: str) -> None:
        out.append(Violation(rule=rule, path=str(path), line=1, col=1, message=msg))

    canon = canonical_shapes(contract_py)
    canon_verbs, _ = canonical_verbs(contract_py)
    client = client_request_shapes(client_py)
    cpp = cpp_request_shapes(broker_cpp)

    # DLC300: request shapes.  Verb *presence* drift is DLC100's job;
    # shapes are only compared where the layers share the verb.
    for verb in sorted(canon_verbs):
        specs = canon.get(verb)
        if not specs:
            v(
                RULE_REQUEST,
                contract_py,
                f"verb {verb!r} has no request-shape spec comment on "
                "BROKER_PROTOCOL_VERBS (`# VERB <arg>... ` is the "
                "machine-read source of truth)",
            )
            continue
        for shape in sorted(client.get(verb, set())):
            if shape not in specs:
                nargs, payload = shape
                v(
                    RULE_REQUEST,
                    client_py,
                    f"client sends {verb} with {nargs} argument token(s)"
                    f"{' + payload' if payload else ''}, but the canonical "
                    f"spec allows {sorted(specs)} (args, payload?)",
                )
        if verb in cpp:
            cpp_nargs, cpp_payload = cpp[verb]
            spec_max = max(n for n, _ in specs)
            if cpp_nargs != spec_max:
                v(
                    RULE_REQUEST,
                    broker_cpp,
                    f"broker.cpp extracts {cpp_nargs} argument token(s) for "
                    f"{verb} but the canonical spec's widest shape has "
                    f"{spec_max}",
                )
            if cpp_payload != any(p for _, p in specs):
                v(
                    RULE_REQUEST,
                    broker_cpp,
                    f"broker.cpp {'reads' if cpp_payload else 'does not read'} "
                    f"a payload for {verb}, disagreeing with the canonical "
                    "spec",
                )

    # DLC301/DLC302: replies and frames.
    client_tokens, client_frames = client_reply_contract(client_py)
    cpp_tokens, cpp_frames = cpp_reply_contract(broker_cpp)
    for verb in sorted(set(client_tokens) & set(cpp_tokens)):
        for token in sorted(client_tokens[verb] - cpp_tokens[verb]):
            v(
                RULE_REPLY,
                client_py,
                f"client expects reply token {token!r} for {verb} but "
                f"broker.cpp's handler only emits "
                f"{sorted(cpp_tokens[verb]) or 'nothing'}",
            )
    for verb in sorted(set(client_frames) | set(cpp_frames)):
        want = client_frames.get(verb, {})
        have = cpp_frames.get(verb, {})
        for tag in sorted(set(want) | set(have)):
            if tag not in have:
                v(
                    RULE_FRAME,
                    broker_cpp,
                    f"client parses {tag!r} frames for {verb} but "
                    "broker.cpp's handler never emits them",
                )
            elif tag not in want:
                v(
                    RULE_FRAME,
                    client_py,
                    f"broker.cpp emits {tag!r} frames for {verb} but the "
                    "client never parses them",
                )
            elif want[tag] and have[tag] not in want[tag]:
                v(
                    RULE_FRAME,
                    client_py,
                    f"{tag!r} frame arity drift for {verb}: client unpacks "
                    f"{sorted(want[tag])} token(s), broker.cpp emits "
                    f"{have[tag]}",
                )
    return out


# --- DLC303: lifecycle kinds ------------------------------------------------
def _event_kind_members(events_py: Path = EVENTS_PY) -> set[str]:
    tree = _parse(events_py)
    for cls in ast.walk(tree):
        if isinstance(cls, ast.ClassDef) and cls.name == "EventKind":
            return {
                t.id
                for node in cls.body
                if isinstance(node, ast.Assign)
                for t in node.targets
                if isinstance(t, ast.Name)
            }
    return set()


def _package_files(scan_root: Path = PACKAGE_DIR) -> list[Path]:
    return sorted(
        f for f in scan_root.rglob("*.py") if "__pycache__" not in f.parts
    )


def check_lifecycle(
    events_py: Path = EVENTS_PY,
    elasticity_py: Path = ELASTICITY_PY,
    files: Iterable[Path] | None = None,
) -> list[Violation]:
    out: list[Violation] = []
    defined = _event_kind_members(events_py)
    if not defined:
        out.append(
            Violation(
                rule=RULE_LIFECYCLE,
                path=str(events_py),
                line=1,
                col=1,
                message="EventKind enum not found: the lifecycle vocabulary "
                "must live in provision/events.py",
            )
        )
        return out

    handled: set[str] = set()
    elasticity_tree = _parse(elasticity_py)
    for node in ast.walk(elasticity_tree):
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "EventKind"
        ):
            handled.add(node.attr)

    produced_kinds: set[str] = set()
    consumed_kinds: dict[str, tuple[Path, int]] = {}
    published: dict[str, tuple[Path, int]] = {}
    for path in files if files is not None else _package_files():
        tree = _parse(path)
        for node in ast.walk(tree):
            if (
                isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "EventKind"
            ):
                if node.attr not in defined:
                    out.append(
                        Violation(
                            rule=RULE_LIFECYCLE,
                            path=str(path),
                            line=node.lineno,
                            col=node.col_offset + 1,
                            message=f"EventKind.{node.attr} is not a defined "
                            "lifecycle kind (provision/events.py)",
                        )
                    )
                continue
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            # LifecycleEvent(kind=EventKind.X, ...) publishers
            if dotted_name(func) == "LifecycleEvent":
                for kw in node.keywords:
                    if (
                        kw.arg == "kind"
                        and isinstance(kw.value, ast.Attribute)
                        and isinstance(kw.value.value, ast.Name)
                        and kw.value.value.id == "EventKind"
                    ):
                        published.setdefault(
                            kw.value.attr, (path, node.lineno)
                        )
            # journal producers: <anything>.record("kind", ...)
            if (
                isinstance(func, ast.Attribute)
                and func.attr == "record"
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)
            ):
                produced_kinds.add(node.args[0].value)
            # journal consumers: read_journal(..., kind="x")
            if dotted_name(func) in ("read_journal",) or (
                isinstance(func, ast.Attribute) and func.attr == "read_journal"
            ):
                for kw in node.keywords:
                    if (
                        kw.arg == "kind"
                        and isinstance(kw.value, ast.Constant)
                        and isinstance(kw.value.value, str)
                    ):
                        consumed_kinds.setdefault(
                            kw.value.value, (path, node.lineno)
                        )

    for kind in sorted(set(published) - handled - {"TEST_NOTIFICATION"}):
        path, line = published[kind]
        out.append(
            Violation(
                rule=RULE_LIFECYCLE,
                path=str(path),
                line=line,
                col=1,
                message=f"EventKind.{kind} is published on the bus but the "
                "elasticity controller never dispatches it — the event "
                "would be dropped on the floor (cluster/elasticity.py)",
            )
        )
    for kind in sorted(set(consumed_kinds) - produced_kinds):
        path, line = consumed_kinds[kind]
        out.append(
            Violation(
                rule=RULE_LIFECYCLE,
                path=str(path),
                line=line,
                col=1,
                message=f"journal kind {kind!r} is filtered by a reader but "
                "no record() call ever produces it",
            )
        )
    out.sort(key=lambda x: (x.path, x.line, x.col))
    return out
