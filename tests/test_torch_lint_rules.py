"""The port's copied lint rules against the JAX package's, by JAX's own tests.

Every case of JAX ``tests/test_lint_rules.py``, ``test_concurrency_rules.py``,
``test_determinism_rules.py``, ``test_protocol_shapes.py`` and
``test_contract_check.py`` runs twice: once as written and once with the
package renamed to ``deeplearning_cfn_tpu_torch`` (its ``analysis/``, its
``cluster/`` and ``provision/`` for the contract and protocol checks, which
the port's checker reads against the same ``native/broker/broker.cpp``).
The same assertions hold for both packages.  Not run on the port: the
cases of DLC003 and DLC008, whose matchers the port retargets at its own
idiom (``test_torch_lint_retargeted.py`` holds those), and the case that
pins the JAX package's own committed baseline file
(``test_torch_lint_clean.py`` holds the port's).
"""

from pathlib import Path

import pytest

try:
    from deeplearning_cfn_tpu.analysis import lint_source as jax_lint_source
except ImportError:  # the card's host
    jax_lint_source = None

pytestmark = pytest.mark.skipif(jax_lint_source is None, reason="needs JAX, the reference")

TESTS = Path(__file__).resolve().parent
JAX_FILES = ("test_lint_rules.py", "test_concurrency_rules.py", "test_determinism_rules.py",
             "test_protocol_shapes.py", "test_contract_check.py")
# JAX cases that do not apply to the port (see the module docstring).
NOT_PORTED = ("dlc003", "dlc008", "test_committed_baseline_carries_only_the_comms_sentinel_debt")


def _cases(file: str, pkg: str) -> dict:
    """JAX's ``file`` executed with its imports of ``pkg``."""
    path = TESTS / file
    src = path.read_text()
    if pkg == "torch":
        src = src.replace("deeplearning_cfn_tpu.", "deeplearning_cfn_tpu_torch.")
    ns = {"__name__": f"lint_cases_{file[:-3]}_{pkg}", "__file__": str(path)}
    exec(compile(src, f"{path}[{pkg}]", "exec"), ns)
    return ns


_NS = {(f, pkg): _cases(f, pkg) for f in JAX_FILES for pkg in ("jax", "torch")} \
    if jax_lint_source is not None else {}
_NAMES = sorted((f, n) for (f, pkg), ns in _NS.items() if pkg == "jax"
                for n in ns if n.startswith("test_"))
_PARAMS = [(f, n, pkg) for f, n in _NAMES for pkg in ("jax", "torch")
           if pkg == "jax" or not any(m in n for m in NOT_PORTED)]


@pytest.mark.parametrize("file,name,pkg", _PARAMS)
def test_jax_lint_case(file, name, pkg, request):
    fn = _NS[(file, pkg)][name]
    kwargs = {a: request.getfixturevalue(a)
              for a in fn.__code__.co_varnames[: fn.__code__.co_argcount]}
    fn(**kwargs)


def test_the_port_runs_its_own_copies():
    from deeplearning_cfn_tpu_torch.analysis import core, lint_source

    ns = _NS[("test_lint_rules.py", "torch")]
    assert ns["lint_source"] is lint_source
    assert _NS[("test_lint_rules.py", "jax")]["lint_source"] is jax_lint_source
    assert ns["lint_source"].__module__ == core.__name__
    assert len(_PARAMS) >= 2 * len(_NAMES) - 12
