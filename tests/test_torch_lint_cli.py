"""The port's lint registry, output, baseline ratchet and ``cli lint`` against
the JAX package's.

- The ``{id: (name, gate)}`` registry equals JAX's, rule for rule.
- ``render_text`` / ``render_json`` and the baseline's write, load, apply and
  stale report give the same bytes for the same violations.
- ``cli lint`` with each of JAX's flags, on a fixture directory that seeds
  findings of the copied rules, prints JAX's stdout and exits with JAX's code:
  1 on fresh findings, 0 against a baseline that holds them (a stale entry
  reported), 2 on an unreadable baseline.  Both CLIs also run their own
  contract and protocol checks over their own trees, which are clean.
"""

import json

import pytest

try:
    from deeplearning_cfn_tpu import cli as jcli
    from deeplearning_cfn_tpu.analysis import FILE_RULES as JAX_RULES
    from deeplearning_cfn_tpu.analysis import runner as jrunner
except ImportError:  # the card's host
    jcli = None

from deeplearning_cfn_tpu_torch import cli  # noqa: E402
from deeplearning_cfn_tpu_torch.analysis import FILE_RULES, runner  # noqa: E402
from deeplearning_cfn_tpu_torch.analysis.core import Violation  # noqa: E402

pytestmark = pytest.mark.skipif(jcli is None, reason="needs JAX, the reference")

# Findings of copied rules only: DLC001/004/006/007 ungated, DLC201 under
# --concurrency, DLC601/603 under --determinism.
FIXTURES = {
    "cluster/agent.py": (
        "import subprocess\n"
        "import threading\n\n\n"
        "def run(cmd, xs=[]):\n"
        "    subprocess.run(cmd)\n"
        "    threading.Thread(target=run).start()\n"
        "    try:\n"
        "        pass\n"
        "    except:\n"
        "        pass\n\n\n"
        "class Counter(threading.Thread):\n"
        "    def __init__(self):\n"
        "        super().__init__(daemon=True)\n"
        "        self._halt = threading.Event()\n"
        "        self.total = 0\n\n"
        "    def run(self):\n"
        "        self.total += 1\n"
    ),
    "chaos/pick.py": (
        "import random\n\n\n"
        "def pick(agents):\n"
        "    return random.choice(agents), id(agents)\n"
    ),
    "train/clean.py": "def f(x):\n    return x\n",
}
FLAGS = ([], ["--concurrency"], ["--protocol"], ["--sharding"], ["--comms"],
         ["--determinism"], ["--concurrency", "--determinism", "--format", "json"],
         ["--select", "DLC601,DLC201"])


@pytest.fixture
def fixture_dir(tmp_path):
    for rel, src in FIXTURES.items():
        path = tmp_path / "pkg" / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(src)
    return tmp_path / "pkg"


def _run(main, argv, capsys):
    rc = main(["lint", *argv])
    return rc, capsys.readouterr().out


def test_registry_equals_jax():
    assert {k: (r.name, r.gate) for k, r in FILE_RULES.items()} == \
        {k: (r.name, r.gate) for k, r in JAX_RULES.items()}


def _violations():
    return [Violation("DLC201", "/x/pkg/a.py", 3, 5, "race — on total"),
            Violation("DLC001", "/x/pkg/b.py", 1, 1, "untimed"),
            Violation("DLC601", "/x/pkg/a.py", 9, 2, "entropy")]


def test_render_is_byte_equal():
    from deeplearning_cfn_tpu.analysis.core import Violation as JViolation

    ours, theirs = _violations(), [JViolation(**v.to_dict()) for v in _violations()]
    for fn in ("render_text", "render_json"):
        assert getattr(runner, fn)(ours) == getattr(jrunner, fn)(theirs)
        assert getattr(runner, fn)([]) == getattr(jrunner, fn)([])


def test_baseline_write_apply_and_stale_are_byte_equal(tmp_path):
    from deeplearning_cfn_tpu.analysis.core import Violation as JViolation

    ours, theirs = _violations(), [JViolation(**v.to_dict()) for v in _violations()]
    runner.write_baseline(ours[:2], tmp_path / "ours.json", root=tmp_path)
    jrunner.write_baseline(theirs[:2], tmp_path / "theirs.json", root=tmp_path)
    assert (tmp_path / "ours.json").read_bytes() == (tmp_path / "theirs.json").read_bytes()
    base = runner.load_baseline(tmp_path / "ours.json")
    assert base == jrunner.load_baseline(tmp_path / "theirs.json")
    fresh, stale = runner.apply_baseline(ours[1:], base, root=tmp_path)
    jfresh, jstale = jrunner.apply_baseline(theirs[1:], base, root=tmp_path)
    assert [v.to_dict() for v in fresh] == [v.to_dict() for v in jfresh]
    assert stale == jstale and len(stale) == 1
    scoped = runner.apply_audit_baseline(ours, tmp_path / "ours.json", ["DLC201"], root=tmp_path)
    jscoped = jrunner.apply_audit_baseline(theirs, tmp_path / "theirs.json", ["DLC201"],
                                           root=tmp_path)
    assert [v.to_dict() for v in scoped[0]] == [v.to_dict() for v in jscoped[0]]
    assert scoped[1] == jscoped[1] == []


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: " ".join(f) or "plain")
def test_cli_lint_matches_jax(flags, fixture_dir, capsys):
    ours = _run(cli.main, [*flags, str(fixture_dir)], capsys)
    theirs = _run(jcli.main, [*flags, str(fixture_dir)], capsys)
    assert ours == theirs
    assert ours[0] == (1 if "cluster" in ours[1] or "chaos" in ours[1] else 0)


def test_cli_lint_baseline_paths_match_jax(fixture_dir, tmp_path, capsys):
    base = tmp_path / "base.json"
    flags = ["--concurrency", "--determinism", str(fixture_dir)]
    for main in (cli.main, jcli.main):
        assert main(["lint", *flags, "--baseline", str(base), "--write-baseline"]) == 0
    written = capsys.readouterr().out
    entries = json.loads(base.read_text())["entries"]
    entries.append({"rule": "DLC007", "path": "gone.py", "message": "fixed since"})
    base.write_text(json.dumps({"entries": entries}))
    ours = _run(cli.main, [*flags, "--baseline", str(base)], capsys)
    theirs = _run(jcli.main, [*flags, "--baseline", str(base)], capsys)
    assert ours == theirs and ours[0] == 0
    assert "stale baseline entry: DLC007 gone.py: fixed since" in ours[1]
    assert "wrote" in written
    base.write_text("{not json")
    ours = _run(cli.main, [*flags, "--baseline", str(base)], capsys)
    theirs = _run(jcli.main, [*flags, "--baseline", str(base)], capsys)
    assert ours == theirs and ours[0] == 2


def test_discovery_skips_build_trees_inside_a_target_only(tmp_path):
    """A checkout unpacked under a directory named ``build`` still lints;
    a ``build`` directory inside the target is skipped."""
    pkg = tmp_path / "build" / "arch" / "pkg"
    (pkg / "build").mkdir(parents=True)
    (pkg / "a.py").write_text("x = 1\n")
    (pkg / "build" / "gen.py").write_text("x = 1\n")
    assert list(runner.discover([pkg], tmp_path)) == [pkg / "a.py"]


def test_cli_lint_default_baseline_is_the_ports_own():
    assert runner.DEFAULT_BASELINE.name == "lint_baseline.json"
    assert runner.DEFAULT_BASELINE.parent.name == "analysis"
    assert runner.DEFAULT_BASELINE.parent.parent.name == "deeplearning_cfn_tpu_torch"
    assert runner.DEFAULT_TARGETS == ("deeplearning_cfn_tpu_torch", "chip_smoke.py")
