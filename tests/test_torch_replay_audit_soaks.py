"""The port's replay sentinel over the rest of the catalog's control plane
(``slow-disk``) and both fleet soaks, seed 0: each runs twice in-process,
byte-equal, and its canonical bytes equal the JAX package's.  The soaks run
shrunk (``soak_fleet`` at 1,000 agents, JAX's own test shrinks
``soak_failover`` the same way); ``test_torch_replay_audit.py`` holds the
other scenarios.
"""

import pytest

try:
    from deeplearning_cfn_tpu.analysis import replay_audit as jra
    from deeplearning_cfn_tpu.analysis import schedules as jschedules
except ImportError:  # the card's host
    jra = None

from deeplearning_cfn_tpu_torch.analysis import replay_audit as ra  # noqa: E402
from deeplearning_cfn_tpu_torch.analysis import schedules  # noqa: E402

pytestmark = pytest.mark.skipif(jra is None, reason="needs JAX, the reference")

SOAKS = {
    "soak_failover": lambda mod: lambda seed: mod.soak_failover(seed=seed),
    "soak_fleet_small": lambda mod: lambda seed: mod.soak_fleet(
        agents=1000, seed=seed, kill_count=20, senders=40),
}


def test_slow_disk_and_the_soaks_replay_byte_equal_and_equal_jaxs():
    first: dict[str, bytes] = {}

    def keeping(name, run, kind, audited):
        def wrapped(seed):
            report = run(seed)
            first.setdefault(name, ra.canonicalize(report))
            return report
        return ra.ReplayCase(name, kind, wrapped, audited)

    (disk,) = ra.default_cases(scenarios=["slow-disk"], soaks=False, device="cpu")
    cases = [keeping(disk.name, disk.run, disk.kind, disk.audited_file)]
    cases += [keeping(n, make(schedules), "soak", str(ra.SOAK_AUDITED_FILE))
              for n, make in SOAKS.items()]
    report = ra.run_replay_audit(cases=cases, seeds=(0,), journal=False)
    assert report.violations == [] and all(r.identical for r in report.replays)
    theirs = {"slow-disk": jra.canonicalize(
        jra.default_cases(scenarios=["slow-disk"], soaks=False)[0].run(0))}
    theirs.update({n: jra.canonicalize(make(jschedules)(0)) for n, make in SOAKS.items()})
    assert first == theirs


def test_default_cases_end_with_both_full_soaks():
    cases = ra.default_cases(device="cpu")
    assert [c.name for c in cases[-2:]] == ["soak_failover", "soak_fleet"]
    assert all(c.audited_file == str(ra.SOAK_AUDITED_FILE) for c in cases[-2:])
    assert ra.SOAK_AUDITED_FILE.relative_to(ra.REPO_ROOT).as_posix() == \
        "deeplearning_cfn_tpu_torch/analysis/schedules.py"
