"""The port's tree lints clean against its own baseline: the sharding, comms
and determinism passes (``test_torch_lint_clean.py`` holds the others and
says why the check is split).
"""

from deeplearning_cfn_tpu_torch.analysis import runner
from deeplearning_cfn_tpu_torch.analysis.collectives import RULE_IDS as COMMS
from deeplearning_cfn_tpu_torch.analysis.determinism import RULE_IDS as DETERMINISM
from deeplearning_cfn_tpu_torch.analysis.sharding import RULE_IDS as SHARDING

RULES = set(SHARDING) | set(COMMS) | set(DETERMINISM)


def test_the_ports_tree_has_no_fresh_gated_findings_and_no_stale_entries():
    found = runner.run_lint(select=RULES, contract=False)
    baseline = runner.load_baseline(runner.DEFAULT_BASELINE)
    fresh, stale = runner.apply_baseline(found, {e for e in baseline if e[0] in RULES})
    assert fresh == [], "\n" + runner.render_text(fresh)
    assert stale == []
    assert sorted({v.rule for v in found}) == ["DLC603"]
