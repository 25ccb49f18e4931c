"""Tree parity of the copied lint rules, over the port's own tree.

Both linters read every file of the port's lint targets
(``deeplearning_cfn_tpu_torch/`` and ``chip_smoke.py``) as source text, with
every copied rule selected (the DLC0xx rules but DLC003/DLC008, the DLC2xx
and DLC6xx passes).  Their ``(rule, relative path, line, col, message)``
lists are identical, apart from DLC601's torch extension (draws on torch's
global generator), which the JAX linter has no form of.  The contract and
protocol checks, pointed at the port's cluster and provision files, agree
too.  This file holds the DLC0xx and DLC2xx rules;
``test_torch_lint_parity_port_tree_det.py`` the DLC6xx rules, and
``test_torch_lint_parity_jax_tree.py`` does the same over the JAX package's
tree.
"""

from pathlib import Path

import pytest

try:
    from deeplearning_cfn_tpu.analysis import contract_check as jcontract
    from deeplearning_cfn_tpu.analysis import core as jcore
    from deeplearning_cfn_tpu.analysis import protocol as jprotocol
except ImportError:  # the card's host
    jcore = None

from deeplearning_cfn_tpu_torch.analysis import contract_check, core, protocol, runner

pytestmark = pytest.mark.skipif(jcore is None, reason="needs JAX, the reference")

ROOT = runner.REPO_ROOT
RETARGETED = {"DLC003", "DLC008", *(f"DLC40{i}" for i in range(6)),
              *(f"DLC50{i}" for i in range(6))}
COPIED = {r for r in set(core.FILE_RULES) - RETARGETED if not r.startswith("DLC6")}
TORCH_ONLY = "torch's global generator"


def findings(lint_source, targets) -> list[tuple]:
    out = []
    for path in runner.discover(targets, ROOT):
        for v in lint_source(path, select=COPIED):
            if TORCH_ONLY not in v.message:
                out.append((v.rule, Path(v.path).relative_to(ROOT).as_posix(), v.line, v.col,
                            v.message))
    return out


@pytest.fixture(scope="module")
def both():
    if jcore is None:
        pytest.skip("needs JAX, the reference")
    targets = runner.DEFAULT_TARGETS
    return findings(core.lint_source, targets), findings(jcore.lint_source, targets)


def test_copied_rules_find_the_same_on_the_ports_tree(both):
    ours, theirs = both
    assert ours == theirs


def test_the_ports_tree_findings_are_the_baselined_ones(both):
    ours, _ = both
    assert sorted({(r, p) for r, p, *_ in ours}) == [
        ("DLC004", "deeplearning_cfn_tpu_torch/train/checkpoint.py"),
        ("DLC004", "deeplearning_cfn_tpu_torch/train/data.py"),
    ]
    assert len(ours) == 2


def test_contract_and_protocol_checks_agree_on_the_ports_files():
    kw = dict(contract_py=contract_check.CONTRACT_PY, client_py=contract_check.CLIENT_PY,
              service_py=contract_check.SERVICE_PY, broker_cpp=contract_check.BROKER_CPP)
    assert contract_check.check_contract() == jcontract.check_contract(**kw) == []
    assert protocol.check_protocol() == [] == jprotocol.check_protocol(
        **{k: v for k, v in kw.items() if k != "service_py"})
    assert protocol.check_lifecycle() == [] == jprotocol.check_lifecycle(
        events_py=protocol.EVENTS_PY, elasticity_py=protocol.ELASTICITY_PY,
        files=protocol._package_files(protocol.PACKAGE_DIR))
