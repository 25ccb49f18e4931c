"""The port's replay sentinel (``analysis/replay_audit.py``) against the JAX
package's.

- Every case of JAX ``tests/test_replay_audit.py`` runs twice, once as
  written and once on the port's package: canonicalization, the
  first-divergence pointer, a planted order-unstable case giving JAX's DLC610
  divergence path (``$.details.rounds[0]``), ``default_cases`` covering the
  catalog and both soaks, one real scenario and a shrunk soak byte-equal,
  the journaled event.
- The control-plane scenarios of the catalog, seed 0: the port's audit runs
  each twice, byte-equal, and its canonical bytes equal the JAX scenario's,
  except ``flaky-rpc`` seed 0, whose report differs from JAX's by design
  (the port's ``retry_call`` difference, kept deliberately).  The rest of the
  catalog's control plane and the soaks: ``test_torch_replay_audit_soaks.py``.
- The journal's ``replay_audit`` event folds through the port's
  ``obs/exporter.fold_replay_events`` as JAX's does through its own.
"""

from pathlib import Path

import pytest

try:
    from deeplearning_cfn_tpu.analysis import replay_audit as jra
    from deeplearning_cfn_tpu.obs import exporter as jexporter
except ImportError:  # the card's host
    jra = None

from deeplearning_cfn_tpu_torch.analysis import replay_audit as ra  # noqa: E402
from deeplearning_cfn_tpu_torch.obs import exporter  # noqa: E402

pytestmark = pytest.mark.skipif(jra is None, reason="needs JAX, the reference")

JAX_TESTS = Path(__file__).resolve().parent / "test_replay_audit.py"
SCENARIOS = ("alert-storm", "broker-failover", "degraded-pair-heal", "flaky-rpc", "partition",
             "shard-failover", "silent-death", "split-brain", "straggler")
# Seed 0 of flaky-rpc reports differently from JAX's by design.
DIFFERS_FROM_JAX = {"flaky-rpc"}


def _cases(pkg: str) -> dict:
    src = JAX_TESTS.read_text()
    if pkg == "torch":
        src = src.replace("deeplearning_cfn_tpu.", "deeplearning_cfn_tpu_torch.")
    ns = {"__name__": f"replay_cases_{pkg}", "__file__": str(JAX_TESTS)}
    exec(compile(src, f"{JAX_TESTS}[{pkg}]", "exec"), ns)
    return ns


_NS = {pkg: _cases(pkg) for pkg in ("jax", "torch")} if jra is not None else {}
_NAMES = sorted(n for n in _NS.get("jax", {}) if n.startswith("test_"))


@pytest.mark.parametrize("pkg", ["jax", "torch"])
@pytest.mark.parametrize("name", _NAMES)
def test_jax_replay_case(name, pkg, request):
    fn = _NS[pkg][name]
    args = fn.__code__.co_varnames[: fn.__code__.co_argcount]
    fn(**{a: request.getfixturevalue(a) for a in args})


def test_the_port_runs_its_own_copy():
    assert _NS["torch"]["run_replay_audit"] is ra.run_replay_audit
    assert len(_NAMES) >= 8


def replay_against_jax(names, seed=0):
    """The port's audit over ``names`` (each run twice), with its first
    run's canonical bytes kept, and JAX's bytes for the same cases."""
    first: dict[str, bytes] = {}

    def keeping(case):
        def run(s):
            report = case.run(s)
            first.setdefault(case.name, ra.canonicalize(report))
            return report
        return ra.ReplayCase(case.name, case.kind, run, case.audited_file)

    cases = [keeping(c) for c in ra.default_cases(scenarios=[n for n in names if "soak" not in n],
                                                  soaks=False, device="cpu")]
    return cases, first


def test_control_plane_scenarios_replay_byte_equal_and_equal_jaxs():
    cases, first = replay_against_jax(SCENARIOS)
    report = ra.run_replay_audit(cases=cases, seeds=(0,), journal=False)
    assert report.violations == [] and all(r.identical for r in report.replays)
    assert [r.name for r in report.replays] == sorted(SCENARIOS)
    theirs = {c.name: jra.canonicalize(c.run(0))
              for c in jra.default_cases(scenarios=sorted(set(SCENARIOS) - DIFFERS_FROM_JAX),
                                         soaks=False)}
    assert {n: first[n] for n in theirs} == theirs


def test_spawning_scenarios_are_named():
    from deeplearning_cfn_tpu_torch.chaos.scenarios import SCENARIOS as CATALOG, on_device

    spawning = {n for n in CATALOG if ra.spawns_ranks(n)}
    assert spawning == {"data-reshard-live", "gauntlet", "sched-flash-crowd", "slice-loss-live"}
    assert spawning <= {n for n in CATALOG if on_device(n)}


def test_journal_event_folds_like_jaxs():
    event = {"kind": "replay_audit", "clean": False, "cases": 3, "seeds": [0],
             "divergent": ["b", "a"]}
    assert exporter.fold_replay_events([event]) == jexporter.fold_replay_events([event])
    assert exporter.fold_replay_events([event])["divergent"] == ["a", "b"]
