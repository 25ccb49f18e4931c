"""DLC1xx: the cross-language broker-contract checker (the port's copy: its
``cluster/`` against the C++ broker it builds).

The broker wire protocol lives in FOUR places that nothing previously
forced to agree:

1. the canonical verb set, ``cluster/contract.py:BROKER_PROTOCOL_VERBS``
   (the single source of truth this checker enforces);
2. the verbs the Python client actually sends on the wire
   (``cluster/broker_client.py`` — every ``sendall(f"VERB ...")``);
3. the verbs the supervisor layer exercises through client methods
   (``cluster/broker_service.py``);
4. the verbs the C++ broker dispatches (``native/broker/broker.cpp`` —
   the ``cmd == "VERB"`` handler chain in ``serve()``).

Any verb present in one layer but missing from another is exactly the
"drifted wire protocol" glue failure the reference system kept hitting:
the client grows a verb the C++ broker answers with ``ERR unknown
command``, or a handler ships with no caller and rots.  The checker
extracts each layer's set (Python via AST, C++ via a tolerant regex
scanner — no C++ parser dependency) and cross-checks.

DLC101 guards the OTHER wire contract in cluster/contract.py: the
``to_message``/``from_message`` field sets.  A field written by
``to_message`` but never read back (or read but never written) is a
protocol key drifting out of sync between coordinator and workers.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path

from deeplearning_cfn_tpu_torch.analysis.core import Violation, dotted_name

RULE_VERBS = "DLC100"
RULE_FIELDS = "DLC101"

REPO_ROOT = Path(__file__).resolve().parents[2]
CONTRACT_PY = REPO_ROOT / "deeplearning_cfn_tpu_torch" / "cluster" / "contract.py"
CLIENT_PY = REPO_ROOT / "deeplearning_cfn_tpu_torch" / "cluster" / "broker_client.py"
SERVICE_PY = REPO_ROOT / "deeplearning_cfn_tpu_torch" / "cluster" / "broker_service.py"
BROKER_CPP = REPO_ROOT / "native" / "broker" / "broker.cpp"

# Envelope keys to_message stamps for queue-side filtering (bootstrap
# agents route on them) that from_message intentionally does not consume.
_ENVELOPE_FIELDS = {"event", "status"}

_VERB = re.compile(r"^[A-Z]{2,16}$")
# Tolerant C++ scanner: the dispatch chain in serve() compares the parsed
# command token against string literals.  Matches both `cmd == "SEND"`
# and `"SEND" == cmd` spellings, any whitespace.
_CPP_HANDLER = re.compile(
    r'(?:cmd\s*==\s*"([A-Z]{2,16})")|(?:"([A-Z]{2,16})"\s*==\s*cmd)'
)


def _parse(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


# --- layer 1: the canonical set -------------------------------------------
def canonical_verbs(contract_py: Path = CONTRACT_PY) -> tuple[set[str], int]:
    """(verbs, lineno) from the BROKER_PROTOCOL_VERBS assignment."""
    tree = _parse(contract_py)
    for node in ast.walk(tree):
        targets: list[ast.expr] = []
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        else:
            continue
        for t in targets:
            if isinstance(t, ast.Name) and t.id == "BROKER_PROTOCOL_VERBS":
                verbs = {
                    e.value
                    for e in ast.walk(value)
                    if isinstance(e, ast.Constant) and isinstance(e.value, str)
                }
                return verbs, node.lineno
    return set(), 1


# --- layer 2: what the client sends ---------------------------------------
def _leading_literal(expr: ast.AST) -> str | None:
    """The leading string literal of a wire-write expression.

    Handles the client's three shapes::

        b"PING\\n"
        f"SEND {queue} {len(body)}\\n".encode()
        f"RECV {q} {n} {v}\\n".encode() + body     (header + payload concat)
    """
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Add):
        return _leading_literal(expr.left)
    if (
        isinstance(expr, ast.Call)
        and isinstance(expr.func, ast.Attribute)
        and expr.func.attr == "encode"
    ):
        return _leading_literal(expr.func.value)
    if isinstance(expr, ast.JoinedStr) and expr.values:
        first = expr.values[0]
        if isinstance(first, ast.Constant) and isinstance(first.value, str):
            return first.value
    if isinstance(expr, ast.Constant):
        if isinstance(expr.value, bytes):
            return expr.value.decode(errors="replace")
        if isinstance(expr.value, str):
            return expr.value
    return None


def client_verb_map(client_py: Path = CLIENT_PY) -> dict[str, set[str]]:
    """method name -> verbs that method writes to the socket, for every
    method of every class in broker_client.py (in practice:
    BrokerConnection).  The union of values is the client's wire set."""
    tree = _parse(client_py)
    out: dict[str, set[str]] = {}
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        for fn in cls.body:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            verbs: set[str] = set()
            for node in ast.walk(fn):
                if (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "sendall"
                    and node.args
                ):
                    lit = _leading_literal(node.args[0])
                    if lit:
                        token = lit.split()[0] if lit.split() else ""
                        if _VERB.fullmatch(token):
                            verbs.add(token)
            if verbs:
                out[fn.name] = verbs
    return out


def client_verbs(client_py: Path = CLIENT_PY) -> set[str]:
    return set().union(*client_verb_map(client_py).values() or [set()])


# --- layer 3: what the supervisor exercises -------------------------------
def service_verbs(
    service_py: Path = SERVICE_PY, client_py: Path = CLIENT_PY
) -> set[str]:
    """Verbs broker_service reaches through client-connection methods.

    Matching is receiver-anchored: only calls on names containing 'conn'
    count (``conn.ping()``), so dict ``.get()`` etc. cannot alias into
    protocol verbs."""
    verb_map = client_verb_map(client_py)
    tree = _parse(service_py)
    out: set[str] = set()
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
            continue
        if node.func.attr not in verb_map:
            continue
        receiver = dotted_name(node.func.value) or ""
        if "conn" in receiver.rsplit(".", 1)[-1].lower():
            out |= verb_map[node.func.attr]
    return out


# --- layer 4: what the C++ broker handles ---------------------------------
def cpp_verbs(broker_cpp: Path = BROKER_CPP) -> set[str]:
    text = broker_cpp.read_text(errors="replace")
    out = set()
    for m in _CPP_HANDLER.finditer(text):
        out.add(m.group(1) or m.group(2))
    return out


# --- the field contract (to_message / from_message) ------------------------
def _message_fields(contract_py: Path = CONTRACT_PY) -> tuple[set[str], set[str]]:
    """(written_by_to_message, read_by_from_message) key sets."""
    tree = _parse(contract_py)
    written: set[str] = set()
    read: set[str] = set()
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef):
            continue
        if fn.name == "to_message":
            for node in ast.walk(fn):
                if isinstance(node, ast.Dict):
                    written |= {
                        k.value
                        for k in node.keys
                        if isinstance(k, ast.Constant) and isinstance(k.value, str)
                    }
        elif fn.name == "from_message":
            for node in ast.walk(fn):
                # body["key"] subscripts
                if (
                    isinstance(node, ast.Subscript)
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "body"
                    and isinstance(node.slice, ast.Constant)
                    and isinstance(node.slice.value, str)
                ):
                    read.add(node.slice.value)
                # body.get("key", ...) defaults
                elif (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "get"
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "body"
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)
                ):
                    read.add(node.args[0].value)
    return written, read


# --- the check -------------------------------------------------------------
def check_contract(
    contract_py: Path = CONTRACT_PY,
    client_py: Path = CLIENT_PY,
    service_py: Path = SERVICE_PY,
    broker_cpp: Path = BROKER_CPP,
) -> list[Violation]:
    out: list[Violation] = []

    def v(rule: str, path: Path, line: int, msg: str) -> None:
        out.append(
            Violation(rule=rule, path=str(path), line=line, col=1, message=msg)
        )

    canon, canon_line = canonical_verbs(contract_py)
    if not canon:
        v(
            RULE_VERBS,
            contract_py,
            1,
            "BROKER_PROTOCOL_VERBS not found: the canonical verb set must "
            "live in cluster/contract.py",
        )
        return out

    client = client_verbs(client_py)
    cpp = cpp_verbs(broker_cpp)
    service = service_verbs(service_py, client_py)

    def diff(missing_from: str, path: Path, line: int, have: set[str], want: set[str]) -> None:
        for verb in sorted(want - have):
            v(
                RULE_VERBS,
                path,
                line,
                f"verb {verb!r} is in the canonical set "
                f"(cluster/contract.py) but missing from {missing_from}",
            )

    # canonical <-> client, both directions
    diff("the Python client (broker_client.py)", client_py, 1, client, canon)
    for verb in sorted(client - canon):
        v(
            RULE_VERBS,
            contract_py,
            canon_line,
            f"broker_client.py sends verb {verb!r} that is not in "
            "BROKER_PROTOCOL_VERBS — add it to the canonical set",
        )
    # canonical <-> C++ broker, both directions
    diff("the C++ handler chain (native/broker/broker.cpp)", broker_cpp, 1, cpp, canon)
    for verb in sorted(cpp - canon):
        v(
            RULE_VERBS,
            contract_py,
            canon_line,
            f"broker.cpp handles verb {verb!r} that is not in "
            "BROKER_PROTOCOL_VERBS — dead handler or missing canon entry",
        )
    # supervisor layer must stay inside the canon
    for verb in sorted(service - canon):
        v(
            RULE_VERBS,
            service_py,
            1,
            f"broker_service.py exercises verb {verb!r} that is not in "
            "BROKER_PROTOCOL_VERBS",
        )

    # field contract
    written, read = _message_fields(contract_py)
    if written or read:
        for key in sorted((written - _ENVELOPE_FIELDS) - read):
            v(
                RULE_FIELDS,
                contract_py,
                1,
                f"to_message writes field {key!r} that from_message never "
                "reads — receiver-side drift",
            )
        for key in sorted(read - written):
            v(
                RULE_FIELDS,
                contract_py,
                1,
                f"from_message reads field {key!r} that to_message never "
                "writes — sender-side drift",
            )
    return out
