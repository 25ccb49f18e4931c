"""The port's fleet scheduler (``sched/``, copies) against the JAX package's.

- Every case of JAX ``tests/test_sched.py`` runs twice, once as written and
  once with the package renamed to ``deeplearning_cfn_tpu_torch`` (specs,
  placer, arbiter, driver seams, the grad-accum round trip the restore needs,
  ``ClusterContract.restored``, the sched fold and family, ``cli sched``):
  the same assertions hold for both packages.
- Placement on seeded inventories and job sets: equal verdicts.
- The ledger: one history of submits, pages, resolves and reconciles drives
  an arbiter of each package; every persisted ledger string is equal, byte
  for byte, and so are the actions, the driver's calls and the journal's
  ``sched_*`` events; an arbiter resumed from either ledger behaves the same.
- ``cli sched --init/--submit``, a resume and a duplicate submit (exit 2):
  the port's stdout and exit codes equal JAX's ``cli.main``'s.
"""

import itertools
import json
from pathlib import Path

import numpy as np
import pytest

try:
    from deeplearning_cfn_tpu import cli as jcli
    from deeplearning_cfn_tpu import sched as jsched
    from deeplearning_cfn_tpu.obs import recorder as jrecorder
    from deeplearning_cfn_tpu.provision import events as jevents
except ImportError:  # the card's host
    jsched = None

from deeplearning_cfn_tpu_torch import cli, sched  # noqa: E402
from deeplearning_cfn_tpu_torch.obs import recorder  # noqa: E402
from deeplearning_cfn_tpu_torch.provision import events  # noqa: E402

pytestmark = pytest.mark.skipif(jsched is None, reason="needs JAX, the reference")

JAX_TESTS = Path(__file__).resolve().parent / "test_sched.py"


def _cases(pkg: str) -> dict:
    """JAX's ``test_sched.py`` executed with its imports of ``pkg``."""
    src = JAX_TESTS.read_text()
    if pkg == "torch":
        src = src.replace("deeplearning_cfn_tpu.", "deeplearning_cfn_tpu_torch.")
    ns = {"__name__": f"sched_cases_{pkg}", "__file__": str(JAX_TESTS)}
    exec(compile(src, f"{JAX_TESTS}[{pkg}]", "exec"), ns)
    return ns


_NS = {pkg: _cases(pkg) for pkg in ("jax", "torch")} if jsched is not None else {}
_NAMES = sorted(n for n in _NS.get("jax", {}) if n.startswith("test_"))


@pytest.mark.parametrize("pkg", ["jax", "torch"])
@pytest.mark.parametrize("name", _NAMES)
def test_jax_sched_case(name, pkg, request):
    ns = _NS[pkg]
    fn = ns[name]
    kwargs = {}
    for arg in fn.__code__.co_varnames[: fn.__code__.co_argcount]:
        # ``recorder`` is test_sched.py's fixture: a fresh process-wide recorder.
        kwargs[arg] = ns["configure"]() if arg == "recorder" else request.getfixturevalue(arg)
    fn(**kwargs)


def test_the_port_runs_its_own_copies():
    assert _NS["torch"]["FleetArbiter"] is sched.FleetArbiter
    assert _NS["jax"]["FleetArbiter"] is jsched.FleetArbiter
    assert len(_NAMES) >= 28


# --- placement on seeded inventories ---------------------------------------------


def _jobs(mod, rng):
    out = []
    for j in range(int(rng.integers(1, 7))):
        lo = int(rng.integers(1, 3))
        out.append(mod.JobSpec(name=f"job{j}", kind=["train", "serve"][int(rng.integers(2))],
                               priority=["prod-serve", "prod-train", "batch"][int(rng.integers(3))],
                               min_slices=lo, max_slices=lo + int(rng.integers(0, 3))))
    return out


@pytest.mark.parametrize("seed", range(12))
def test_place_equals_jax_on_seeded_inventories(seed):
    rng = np.random.default_rng(seed)
    inventory = {f"s{i}": int(rng.choice([2, 4, 8])) for i in range(int(rng.integers(1, 9)))}
    state = rng.bit_generator.state
    port_jobs = _jobs(sched, rng)
    rng.bit_generator.state = state
    jax_jobs = _jobs(jsched, rng)
    got = sched.place(port_jobs, inventory)
    want = jsched.place(jax_jobs, inventory)
    assert json.dumps(got.to_dict()) == json.dumps(want.to_dict())
    assert sched.verify_placement(got, port_jobs, inventory) == jsched.verify_placement(
        want, jax_jobs, inventory) == []
    for perm in itertools.islice(itertools.permutations(range(len(port_jobs))), 6):
        assert sched.place([port_jobs[i] for i in perm], inventory).to_dict() == got.to_dict()


# --- the ledger ------------------------------------------------------------------


class _Store:
    def __init__(self):
        self.writes: list[tuple[str, str]] = []

    def set(self, key, value):
        self.writes.append((key, value))

    def get(self, key):
        return next((v for k, v in reversed(self.writes) if k == key), None)


class _Manager:
    def __init__(self, calls):
        self.calls = calls

    def on_slice_loss(self, group, burst):
        self.calls.append(("loss", group, [e.instance_id for e in burst]))

    def arm_restore(self, group, ips):
        self.calls.append(("restore", group, list(ips)))


class _FrontEnd:
    def __init__(self, calls):
        self.calls = calls

    def add_replica(self, replica):
        self.calls.append(("add", replica))

    def retire_replica(self, name, force=False):
        self.calls.append(("retire", name, force))
        return name


def _history(side: str, seed: int) -> dict:
    """One seeded history against ``side``'s arbiter: jobs submitted, then
    rounds of serve alerts (firing/resolved, repeats, other rules) each
    followed by a reconcile."""
    mod, ev, rec_mod = ((sched, events, recorder) if side == "port"
                        else (jsched, jevents, jrecorder))
    rec_mod.configure()
    rng = np.random.default_rng(seed)
    calls: list = []
    bus_calls: list = []
    bus = ev.EventBus()
    bus.subscribe(lambda e: bus_calls.append((e.kind.value, e.group, e.instance_id,
                                              dict(e.detail)))
                  if e.kind is ev.EventKind.INSTANCE_TERMINATE else None)
    driver = mod.PreemptionDriver()
    driver.register_train("train", mod.TrainJobHandle(_Manager(calls), bus=bus))
    driver.register_train("nightly", mod.TrainJobHandle(_Manager(calls)))
    driver.register_serve("chat", mod.ServePoolHandle(_FrontEnd(calls), spawn=lambda n: n))
    store = _Store()
    inventory = {f"s{i}": 4 for i in range(5)}
    ips = {s: [f"10.0.{i}.{j}" for j in range(2)] for i, s in enumerate(inventory)}
    arbiter = mod.FleetArbiter(inventory, slice_ips=ips, store=store, driver=driver)
    arbiter.attach(bus)
    arbiter.submit(mod.JobSpec("chat", "serve", "prod-serve"))
    arbiter.submit(mod.JobSpec("train", "train", "prod-train", min_slices=1, max_slices=3))
    arbiter.submit(mod.JobSpec("nightly", "train", "batch", min_slices=1, max_slices=2))
    with pytest.raises(mod.SchedError):
        arbiter.submit(mod.JobSpec("train", "train", "batch"))
    actions = []
    for _ in range(20):
        for _ in range(int(rng.integers(0, 3))):
            rule = ["serve-queue-depth", "serve-ttft-p99", "step-time"][int(rng.integers(3))]
            state = ["firing", "resolved", "pending"][int(rng.integers(3))]
            bus.publish(ev.LifecycleEvent(kind=ev.EventKind.ALERT, group="fleet", detail={
                "rule": rule, "state": state, "value": float(rng.integers(0, 40)),
                "severity": "page"}))
        actions.append(arbiter.reconcile())
    journal = [{k: v for k, v in e.items() if k not in ("ts", "seq_no", "host", "pid")}
               for e in rec_mod.get_recorder().tail(4096) if e["kind"].startswith("sched_")]
    resumed = mod.FleetArbiter.resume(store)
    return {"writes": store.writes, "actions": actions, "calls": calls, "bus": bus_calls,
            "driver": driver.actions, "status": arbiter.status(), "journal": journal,
            "resumed": resumed.ledger() == arbiter.ledger()}


@pytest.mark.parametrize("seed", range(4))
def test_ledger_history_is_byte_equal_to_jax(seed):
    port, ref = _history("port", seed), _history("jax", seed)
    assert port["writes"] == ref["writes"]  # every persisted ledger, byte for byte
    assert port == ref
    assert port["resumed"] and len(port["writes"]) > 20
    assert any(a for a in port["actions"])  # the history preempts


# --- cli sched -------------------------------------------------------------------


def test_cli_sched_equals_jax(tmp_path, capsys):
    steps = [
        (["--init", "s0=4,s1=4,s2=8"], 0),
        (["--submit", "chat", "--kind", "serve", "--priority", "prod-serve"], 0),
        (["--submit", "train", "--priority", "prod-train", "--min-slices", "1",
          "--max-slices", "3"], 0),
        ([], 0),
        (["--submit", "chat", "--kind", "serve"], 2),
        (["--submit", "wide", "--min-slices", "9", "--max-slices", "9"], 0),
        (["--init", "s0"], 2),
    ]
    outs = {}
    for side, main in (("port", cli.main), ("jax", jcli.main)):
        ledger = tmp_path / f"{side}.json"
        outs[side] = []
        for argv, rc in steps:
            assert main(["sched", "--ledger", str(ledger), *argv]) == rc, (side, argv)
            outs[side].append(capsys.readouterr().out)
        outs[side].append(ledger.read_text())
    assert outs["port"] == outs["jax"]
    assert json.loads(outs["port"][3])["assignments"] == {"chat": ["s2"], "train": ["s0", "s1"]}
    with pytest.raises(SystemExit):
        cli.main(["sched", "--ledger", str(tmp_path / "none.json"), "--bogus"])
