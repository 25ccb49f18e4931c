"""Tree parity of the copied lint rules, over the JAX package's tree.

Both linters read every file of the JAX package's lint targets
(``deeplearning_cfn_tpu/``, ``scripts/``, ``bench.py``) as source text, with
every copied rule selected; their ``(rule, relative path, line, col,
message)`` lists are identical (today: none, the JAX package is clean).
``test_torch_lint_parity_port_tree.py`` holds the port's tree and says which
rules count as copied.
"""

from pathlib import Path

import pytest

try:
    from deeplearning_cfn_tpu.analysis import core as jcore
except ImportError:  # the card's host
    jcore = None

from deeplearning_cfn_tpu_torch.analysis import core, runner

pytestmark = pytest.mark.skipif(jcore is None, reason="needs JAX, the reference")

JAX_TARGETS = ("deeplearning_cfn_tpu", "scripts", "bench.py")
RETARGETED = {"DLC003", "DLC008", *(f"DLC40{i}" for i in range(6)),
              *(f"DLC50{i}" for i in range(6))}
COPIED = set(core.FILE_RULES) - RETARGETED


def findings(lint_source, targets) -> list[tuple]:
    root = runner.REPO_ROOT
    return [(v.rule, Path(v.path).relative_to(root).as_posix(), v.line, v.col, v.message)
            for path in runner.discover(targets, root)
            for v in lint_source(path, select=COPIED)]


def test_copied_rules_find_the_same_on_the_jax_tree():
    ours = findings(core.lint_source, JAX_TARGETS)
    theirs = findings(jcore.lint_source, JAX_TARGETS)
    assert ours == theirs == []
