"""Tree parity of the copied DLC6xx determinism rules over the port's own
tree (``test_torch_lint_parity_port_tree.py`` holds the DLC0xx and DLC2xx
rules and says how the trees are read).  DLC601's torch extension (draws on
torch's global generator) is left out: the JAX linter has no form of it.
"""

from pathlib import Path

import pytest

try:
    from deeplearning_cfn_tpu.analysis import core as jcore
except ImportError:  # the card's host
    jcore = None

from deeplearning_cfn_tpu_torch.analysis import core, runner
from deeplearning_cfn_tpu_torch.analysis.determinism import RULE_IDS

pytestmark = pytest.mark.skipif(jcore is None, reason="needs JAX, the reference")

TORCH_ONLY = "torch's global generator"


def findings(lint_source) -> list[tuple]:
    root = runner.REPO_ROOT
    return [(v.rule, Path(v.path).relative_to(root).as_posix(), v.line, v.col, v.message)
            for path in runner.discover(runner.DEFAULT_TARGETS, root)
            for v in lint_source(path, select=set(RULE_IDS)) if TORCH_ONLY not in v.message]


def test_determinism_rules_find_the_same_on_the_ports_tree():
    ours, theirs = findings(core.lint_source), findings(jcore.lint_source)
    assert ours == theirs
    assert sorted({(r, p) for r, p, *_ in ours}) == [
        ("DLC603", "deeplearning_cfn_tpu_torch/parallel/overlap.py")]
    assert len(ours) == 2
