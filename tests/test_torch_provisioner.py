"""The port's provisioning plane against the JAX package's, on the CPU.

``provision/local.py``, ``cluster/bootstrap.py``, ``provision/provisioner.py``,
``cluster/launcher.py``, ``cluster/startup.py`` and the ``Stager`` of
``provision/objectstore.py`` are copies.  Each scenario below drives the JAX
package's modules and the port's on the same spec, fault knobs and
``FakeClock`` (no test sleeps), one after the other into the same contract
root, and holds them equal, exactly:

- the outcome (the realized size, degradation, job violation, storage, or
  the ``ProvisionFailure`` message) and the fake clock's reading;
- every file under the contract root (``contract.json``, ``env.sh``,
  ``workers``, ``hosts``, ``storage.json``), byte for byte;
- ``describe()`` and ``delete()``;
- the flight journal's events (kinds and fields; not the wall time, host
  or pid of each line).

Then the launch and startup scripts of every committed template, equal
apart from the module prefix: a job module under ``deeplearning_cfn_tpu.``
runs as its counterpart under ``deeplearning_cfn_tpu_torch.``, and the
agent step execs the port's agent.
"""

import json
import shutil
from pathlib import Path

import pytest

try:
    from deeplearning_cfn_tpu.cluster import launcher as jlauncher
    from deeplearning_cfn_tpu.cluster import startup as jstartup
    from deeplearning_cfn_tpu.config import schema as jschema
    from deeplearning_cfn_tpu.config import template as jtemplate
    from deeplearning_cfn_tpu.obs import recorder as jrecorder
    from deeplearning_cfn_tpu.provision import local as jlocal
    from deeplearning_cfn_tpu.provision import objectstore as jobjectstore
    from deeplearning_cfn_tpu.provision import provisioner as jprovisioner
    from deeplearning_cfn_tpu.utils import timeouts as jtimeouts
except ImportError:  # the card's host has no JAX package to compare with
    jschema = None

from deeplearning_cfn_tpu_torch.cluster import launcher, startup  # noqa: E402
from deeplearning_cfn_tpu_torch.config import schema, template  # noqa: E402
from deeplearning_cfn_tpu_torch.obs import recorder  # noqa: E402
from deeplearning_cfn_tpu_torch.provision import local, objectstore, provisioner  # noqa: E402
from deeplearning_cfn_tpu_torch.utils import timeouts  # noqa: E402

pytestmark = pytest.mark.skipif(jschema is None, reason="needs the JAX package, the reference")

REPO = Path(__file__).resolve().parent.parent
TEMPLATES = sorted((REPO / "templates").glob("*.json"))
# The parameters each committed template requires (no default).
REQUIRED = {"local": {},
            "detection-cluster-private": {"Project": "example-project", "Network": "vpc-1",
                                          "Subnetwork": "subnet-1"}}
NAME = "test-cluster"
GROUP = f"{NAME}-workers"


def _sides():
    return {
        "jax": dict(schema=jschema, local=jlocal, provisioner=jprovisioner,
                    timeouts=jtimeouts, recorder=jrecorder),
        "port": dict(schema=schema, local=local, provisioner=provisioner,
                     timeouts=timeouts, recorder=recorder),
    }


def _spec(m, workers=4, min_workers=None, batch=None, slices=1, min_slices=None):
    s = m["schema"]
    return s.ClusterSpec(
        name=NAME,
        backend="local",
        pool=s.NodePool(accelerator_type="local-1", workers=workers, min_workers=min_workers,
                        slices=slices, min_slices=min_slices),
        storage=s.StorageSpec(kind="local"),
        timeouts=s.TimeoutSpec(cluster_ready_s=3300.0, controller_launch_s=600.0),
        job=s.JobSpec(global_batch_size=batch if batch is not None else workers * 8),
    )


# name: (spec kwargs, LocalBackend knobs, actions after the first provision)
SCENARIOS = {
    "happy": (dict(workers=4), {}, ["describe", "delete"]),
    "three-workers": (dict(workers=3, batch=33), {}, ["describe"]),
    "duplicate-events": (dict(workers=4), dict(duplicate_events=True), ["describe"]),
    "degrade": (dict(workers=6, min_workers=3, batch=24),
                dict(fail_instance_indices={GROUP: {1, 4}}), ["describe"]),
    "job-violation": (dict(workers=6, min_workers=5, batch=48),
                      dict(fail_instance_indices={GROUP: {5}}), ["describe"]),
    "below-minimum": (dict(workers=4, min_workers=2, batch=4),
                      dict(fail_instance_indices={GROUP: {0, 1, 2}}), []),
    "all-fail": (dict(workers=2), dict(fail_instance_indices={GROUP: {0, 1}}), []),
    "slow-launch": (dict(workers=2), dict(launch_delay_s=300.0), ["describe"]),
    "budget-exhausted": (dict(workers=2), dict(launch_delay_s=10_000.0), []),
    "multislice-degraded": (dict(workers=2, slices=2, min_slices=1, batch=8),
                            dict(fail_instance_indices={f"{GROUP}-s1": {0, 1}}), ["describe"]),
    "kill-then-recover": (dict(workers=3, batch=24), {},
                          ["kill", "describe", "recover", "describe", "delete"]),
    "fresh-process-recover": (dict(workers=2), {}, ["fresh-recover", "describe"]),
}


def _drive(m, root: Path, name: str) -> dict:
    spec_kw, knobs, actions = SCENARIOS[name]
    journal = root.parent / f"{root.name}.journal"
    journal.unlink(missing_ok=True)
    m["recorder"].configure(journal)
    clock = m["timeouts"].FakeClock()
    backend = m["local"].LocalBackend(clock=clock, **knobs)
    prov_mod = m["provisioner"]
    prov = prov_mod.Provisioner(backend, _spec(m, **spec_kw), contract_root=root)
    trace = []

    def outcome(call):
        try:
            r = call()
        except prov_mod.ProvisionFailure as e:
            return ("failure", str(e))
        return ("ok", r.realized_workers, r.degraded, r.degraded_slices, r.job_violation,
                r.storage.storage_id, r.storage.created, r.contract.to_message())

    trace.append(outcome(prov.provision))
    for action in actions:
        if action == "kill":
            victim = min(backend.describe_group(GROUP).instances, key=lambda i: i.index)
            backend.kill_instance(victim.instance_id)
            trace.append(("lost", sorted(prov._controller.lost_instances)))
        elif action == "describe":
            trace.append(("describe", prov.describe()))
        elif action == "delete":
            trace.append(("delete", prov.delete()))
        elif action == "recover":
            trace.append(outcome(prov.recover))
        elif action == "fresh-recover":
            fresh = prov_mod.Provisioner(backend, _spec(m, **spec_kw), contract_root=root)
            trace.append(outcome(fresh.recover))
            prov = fresh
    trace.append(("clock", clock.now()))
    files = {p.name: p.read_bytes() for p in sorted(root.iterdir()) if p.is_file()}
    m["recorder"].configure(None)
    events = [{k: v for k, v in e.items() if k not in ("ts", "host", "pid")}
              for e in m["recorder"].read_journal(journal)]
    return {"trace": trace, "files": files, "events": events}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_provisioning_scenario_matches_jax(tmp_path, name):
    root = tmp_path / "opt-deeplearning"
    runs = {}
    for side, m in _sides().items():
        runs[side] = _drive(m, root, name)
        shutil.rmtree(root, ignore_errors=True)
    jax_run, port = runs["jax"], runs["port"]
    assert port["trace"] == jax_run["trace"]
    assert port["files"] == jax_run["files"]
    assert port["events"] == jax_run["events"]
    assert any(e["kind"] == "lifecycle" for e in port["events"])


def test_scenarios_cover_the_outcomes(tmp_path):
    """The table exercises success, degradation, a job violation, each
    failure path and the recover paths (so the equalities above bite)."""
    runs = {name: _drive(_sides()["port"], tmp_path / name, name) for name in SCENARIOS}
    first = {name: run["trace"][0] for name, run in runs.items()}
    assert first["happy"][:3] == ("ok", 4, False)
    assert first["degrade"][:3] == ("ok", 4, True)
    assert "not divisible" in first["job-violation"][4]
    assert first["multislice-degraded"][3] == [f"{GROUP}-s1"]
    assert "minimum capacity" in first["below-minimum"][1]
    assert "instances-active" in first["budget-exhausted"][1]
    assert runs["slow-launch"]["trace"][-1] == ("clock", pytest.approx(300.0, abs=60.0))
    recovered = runs["kill-then-recover"]["trace"][3]
    assert recovered[0] == "ok" and recovered[6] is False  # storage reused, not created
    assert runs["fresh-process-recover"]["trace"][1][6] is False
    assert set(runs["happy"]["files"]) >= {"contract.json", "env.sh", "workers", "storage.json"}


def _remote_without_agents(side: str, port: int, root) -> list:
    """``remote_agents=True`` over a live broker with no agent: the previous
    generation's ready signal is scrubbed first, the wait reports progress
    each poll, and the budget ends in FAILURE, as JAX's."""
    s = _sides()[side]
    if side == "port":
        from deeplearning_cfn_tpu_torch.cluster import bootstrap, broker_backend
        from deeplearning_cfn_tpu_torch.provision.backend import ResourceSignal
    else:
        from deeplearning_cfn_tpu.cluster import bootstrap, broker_backend
        from deeplearning_cfn_tpu.provision.backend import ResourceSignal
    spec = _spec(s)
    spec.timeouts.controller_launch_s = 0.1
    spec.timeouts.cluster_ready_s = 0.6
    spec.timeouts.poll_interval_s = 0.2
    backend = broker_backend.BrokerRendezvousBackend(
        s["local"].LocalBackend(clock=s["timeouts"].FakeClock()), "127.0.0.1", port)
    ready = bootstrap.cluster_ready_resource(spec.name)
    backend.signal_resource(ready, ResourceSignal.SUCCESS)  # the previous generation's
    statuses = []
    prov = s["provisioner"].Provisioner(backend, spec, contract_root=root, remote_agents=True,
                                        progress=lambda _t, status: statuses.append(status))
    try:
        prov.provision()
        outcome = "ready"
    except s["provisioner"].ProvisionFailure as e:
        outcome = str(e)
    return [outcome, sorted(set(statuses)), backend.get_resource_signal(ready).value]


def test_remote_agents_name_the_broker_slice(tmp_path, monkeypatch):
    from deeplearning_cfn_tpu_torch.cluster.broker_client import BrokerProcess

    monkeypatch.delenv("DLCFN_BROKER_TOKEN", raising=False)
    refusals = []
    for side in ("port", "jax"):
        s = _sides()[side]
        with pytest.raises(ValueError) as err:
            s["provisioner"].Provisioner(s["local"].LocalBackend(clock=s["timeouts"].FakeClock()),
                                         _spec(s), contract_root=tmp_path, remote_agents=True)
        refusals.append(str(err.value))
    assert refusals[0] == refusals[1] and "BrokerRendezvousBackend" in refusals[0]
    with BrokerProcess() as broker:
        port = _remote_without_agents("port", broker.port, tmp_path / "port")
        assert port == _remote_without_agents("jax", broker.port, tmp_path / "jax")
    assert "did not become ready" in port[0] and port[2] == "FAILURE"
    assert port[1] == [f"{_spec(_sides()['port']).pool.num_workers}/"
                       f"{_spec(_sides()['port']).pool.num_workers} workers up"]


def test_worker_group_names_as_jax():
    for slices in (1, 2, 4):
        assert (provisioner.worker_group_names("c", slices)
                == jprovisioner.worker_group_names("c", slices))
    assert provisioner.worker_group_name("c") == jprovisioner.worker_group_name("c")


# --- launch and startup scripts of the committed templates ---------------------


def _port_text(text: str) -> str:
    """JAX's rendering as the port renders it: module paths under the port's package."""
    return text.replace("deeplearning_cfn_tpu.", "deeplearning_cfn_tpu_torch.")


def _rendered(path: Path):
    params = REQUIRED.get(path.stem, {"Project": "example-project"})
    return (jtemplate.render_template_file(path, dict(params)),
            template.render_template_file(path, dict(params)))


@pytest.mark.parametrize("path", TEMPLATES, ids=lambda p: p.stem)
def test_template_job_module_resolves_to_the_port(path):
    _, spec = _rendered(path)
    assert spec.job.module.startswith("deeplearning_cfn_tpu.examples.")
    resolved = launcher.resolve_job_module(spec.job.module)
    assert resolved == _port_text(spec.job.module)
    assert callable(__import__(resolved, fromlist=["main"]).main)


@pytest.mark.parametrize("path", TEMPLATES, ids=lambda p: p.stem)
def test_launch_scripts_equal_jax_s_apart_from_the_prefix(path):
    from deeplearning_cfn_tpu import cli as jcli

    from deeplearning_cfn_tpu_torch import cli

    jspec, spec = _rendered(path)
    jplan = jlauncher.build_launch_plan(jcli._hypothetical_contract(jspec), jspec.job)
    plan = launcher.build_launch_plan(cli._hypothetical_contract(spec), spec.job)
    assert plan.module == _port_text(jspec.job.module)
    assert (plan.num_parallel, plan.steps_per_epoch) == (jplan.num_parallel,
                                                         jplan.steps_per_epoch)
    assert len(plan.workers) == len(jplan.workers) == spec.pool.total_workers
    for w in plan.workers:
        assert plan.render_script(w.process_id) == _port_text(jplan.render_script(w.process_id))


@pytest.mark.parametrize("path", TEMPLATES, ids=lambda p: p.stem)
def test_startup_script_equals_jax_s_apart_from_the_prefix(path):
    jspec, spec = _rendered(path)
    script = startup.render_startup_script(spec)
    assert script == _port_text(jstartup.render_startup_script(jspec))
    assert script.rstrip().endswith("exec python3 -m deeplearning_cfn_tpu_torch.cluster.agent_main")


def test_startup_script_steps_as_jax():
    """Storage, staging (shared and per-worker), setup and the agent step on
    a spec that turns each on."""
    for kind, shared in (("filestore", True), ("gcs", False), ("local", True)):
        body = {"name": "steps", "backend": "local",
                "pool": {"accelerator_type": "local-1", "workers": 2, "slices": 2,
                         "min_slices": 1},
                "storage": {"kind": kind, "mount_point": "/mnt/shared data"},
                "staging": {"bucket": "bkt", "prefix": "p", "datasets": ["coco.tar", "x y.tar"],
                            "code": ["code.tar"], "data_on_shared_storage": shared},
                "setup": {"pip_packages": ["numpy==2.0", "einops"], "commands": ["echo hi"],
                          "activate_env": "/srv/env"},
                "job": {"global_batch_size": 8}}
        jspec = jschema.ClusterSpec.from_dict(json.loads(json.dumps(body))).validate()
        spec = schema.ClusterSpec.from_dict(json.loads(json.dumps(body))).validate()
        assert (startup.render_startup_script(spec)
                == _port_text(jstartup.render_startup_script(jspec)))


def test_job_module_resolution():
    resolve = launcher.resolve_job_module
    assert resolve("deeplearning_cfn_tpu.examples.llama_train") == (
        "deeplearning_cfn_tpu_torch.examples.llama_train")
    assert resolve("my_pkg.train") == "my_pkg.train"  # imported as named
    assert resolve("deeplearning_cfn_tpu_torch.examples.lenet_mnist") == (
        "deeplearning_cfn_tpu_torch.examples.lenet_mnist")
    for missing in ("deeplearning_cfn_tpu.examples.no_such_example",
                    "deeplearning_cfn_tpu.no_such_package.job"):
        with pytest.raises(launcher.LaunchError, match=missing.replace(".", r"\.")):
            resolve(missing)


def test_unported_job_module_fails_the_plan_with_its_name():
    spec = schema.ClusterSpec.from_dict({
        "name": "c", "backend": "local", "pool": {"accelerator_type": "local-1", "workers": 1},
        "job": {"global_batch_size": 8, "module": "deeplearning_cfn_tpu.examples.gone"}})
    contract = launcher.ClusterContract.build(
        cluster_name="c", coordinator_ip="10.0.0.2", other_worker_ips=[], chips_per_worker=1,
        storage_mount="/mnt/dlcfn")
    with pytest.raises(launcher.LaunchError, match="examples.gone"):
        launcher.build_launch_plan(contract, spec.job)


def test_launch_invariants_as_jax():
    """The invariants run.sh checked before mpirun refuse with JAX's messages."""
    cases = [({"require_even_workers": True, "global_batch_size": 3}, 3, None),
             ({"global_batch_size": 7}, 2, None),
             ({"global_batch_size": 8}, 2, "global_batch_size 8 not divisible by total chips 3")]
    for job, workers, violation in cases:
        out = []
        for s, lmod in ((jschema, jlauncher), (schema, launcher)):
            spec = s.JobSpec(**job)
            contract = lmod.ClusterContract.build(
                cluster_name="c", coordinator_ip="10.0.0.2",
                other_worker_ips=[f"10.0.0.{i + 3}" for i in range(workers - 1)],
                chips_per_worker=1, storage_mount="/mnt/dlcfn")
            try:
                lmod.build_launch_plan(contract, spec, violation)
                out.append("ok")
            except lmod.LaunchError as e:
                out.append(str(e))
        assert out[1] == out[0] and out[0] != "ok"


def test_stager_manifest_as_jax(tmp_path):
    src = tmp_path / "src"
    (src / "data").mkdir(parents=True)
    (src / "data" / "a.bin").write_bytes(bytes(range(256)) * 64)
    (src / "code.py").write_text("print('hi')\n")
    manifests = []
    for name, mod in (("jax", jobjectstore), ("port", objectstore)):
        store = mod.LocalObjectStore(tmp_path / name)
        stager = mod.Stager(store, prefix="runs/1")
        stager.stage_path(src / "data")
        stager.stage_path(src / "code.py", name="code")
        dest = stager.fetch_artifact("data.tar", tmp_path / f"{name}-out")
        assert (dest / "data" / "a.bin").read_bytes() == (src / "data" / "a.bin").read_bytes()
        manifests.append(([vars(a) for a in stager.manifest], store.list("runs/")))
    assert manifests[1] == manifests[0]
    with pytest.raises(FileNotFoundError):
        objectstore.Stager(objectstore.LocalObjectStore(tmp_path / "x")).stage_path(
            tmp_path / "missing")
