"""The port's tree lints clean against its own baseline.

``python -m deeplearning_cfn_tpu_torch.cli lint --concurrency --protocol
--sharding --comms --determinism --baseline`` exits 0: every finding of
every pass over the port's package and ``chip_smoke.py`` is one the port's
ratchet (``analysis/lint_baseline.json``) holds, and the ratchet has no
stale static entry.  Its dynamic entries are the audits' own (DLC41x, DLC51x,
DLC610) and are held by their tests.  This file lints with the ungated
rules and the concurrency, contract and protocol passes;
``test_torch_lint_clean_gated.py`` with the sharding, comms and
determinism passes (the same check, split to keep each file short).
"""

import json

import pytest

from deeplearning_cfn_tpu_torch import cli
from deeplearning_cfn_tpu_torch.analysis import FILE_RULES, runner
from deeplearning_cfn_tpu_torch.analysis.concurrency import RULE_IDS as CONCURRENCY

RULES = {r for r, rule in FILE_RULES.items() if rule.gate is None} | set(CONCURRENCY) | {
    "DLC100", "DLC101"}


def assert_clean(found, rules):
    """No fresh finding, and no stale static entry among ``rules``."""
    baseline = runner.load_baseline(runner.DEFAULT_BASELINE)
    fresh, stale = runner.apply_baseline(
        found, {e for e in baseline if e[0] in rules})
    assert fresh == [], "\n" + runner.render_text(fresh)
    assert stale == []


@pytest.fixture(scope="module")
def found():
    return runner.run_lint(select=RULES, protocol_pass=True)


def test_the_ports_tree_has_no_fresh_findings_and_no_stale_entries(found):
    assert_clean(found, RULES | {"DLC300", "DLC301", "DLC302", "DLC303"})


def test_the_baseline_holds_only_what_the_readme_explains():
    rules = sorted({rule for rule, _, _ in runner.load_baseline(runner.DEFAULT_BASELINE)})
    assert rules == ["DLC004", "DLC603"]


def test_cli_lint_every_pass_with_the_baseline_exits_zero(tmp_path, capsys):
    # A file of the port's tree re-linted through the CLI with every flag:
    # the CLI applies the default baseline and finds nothing fresh.
    flags = ["--concurrency", "--protocol", "--sharding", "--comms", "--determinism"]
    target = "deeplearning_cfn_tpu_torch/parallel/overlap.py"
    assert cli.main(["lint", *flags, "--baseline", "--format", "json", target]) == 0
    out = capsys.readouterr().out
    report, end = json.JSONDecoder().raw_decode(out)
    assert report == {"violations": [], "count": 0}
    # The entries of the files not linted here are reported stale.
    assert all(line.startswith("dlcfn-lint: stale baseline entry: DLC004 ")
               for line in out[end:].strip().splitlines())
    assert cli.main(["lint", *flags, "--format", "json", target]) == 1
    out = json.loads(capsys.readouterr().out)
    assert {v["rule"] for v in out["violations"]} == {"DLC603"}


def test_a_planted_capture_sync_and_host_gather_fail_the_cli(tmp_path, capsys):
    planted = tmp_path / "train" / "planted.py"
    planted.parent.mkdir()
    planted.write_text(
        "import torch\n\n\n"
        "def step(graph, x, w):\n"
        "    with torch.cuda.graph(graph):\n"
        "        y = x @ w\n"
        "        scale = y.sum().item()\n"
        "    return y * scale\n\n\n"
        "def move(src, region):\n"
        "    src = src.full_tensor()\n"
        "    return src[region]\n")
    assert cli.main(["lint", "--sharding", "--comms", "--format", "json", str(planted)]) == 1
    rules = sorted(v["rule"] for v in json.loads(capsys.readouterr().out)["violations"])
    assert rules == ["DLC003", "DLC502"]
