"""The port's operator commands against ``dlcfn``'s, on the CPU.

``validate``, ``create``, ``describe``, ``delete``, ``recover``, ``plan``,
``run`` (with ``--auto-recover``), ``startup-script``, ``stage`` and
``gen-scripts`` run through ``deeplearning_cfn_tpu_torch.cli.main`` and the
JAX package's ``cli.main`` on the same template, each with its own
``$DLCFN_ROOT`` and its local backend on a ``FakeClock``; the printed JSON is held equal apart from ``elapsed_s``
and ``contract_root``, and the rendered scripts apart from the module
prefix (a job module under ``deeplearning_cfn_tpu.`` runs as its
counterpart under ``deeplearning_cfn_tpu_torch.``).  ``run`` is driven with
a stand-in job module that loses the coordinator on demand, so the
recover-and-rerun loop and its refusal past ``--auto-recover N`` run on
both sides; the port's LeNet then trains through ``run`` on the CPU when
the template asks for it, and a template that does not ask trains on the
card or raises: it never falls back to the CPU.
"""

import json
import logging
import sys
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

try:
    from deeplearning_cfn_tpu import cli as jcli
except ImportError:  # the card's host has no JAX package to compare with
    jcli = None

from deeplearning_cfn_tpu_torch import cli  # noqa: E402

needs_jax = pytest.mark.skipif(jcli is None, reason="needs the JAX package, the reference")

TEMPLATE = {
    "Parameters": {
        "Workers": {"type": "int", "default": 2, "min": 1, "max": 16},
        "Accel": {"type": "str", "default": "local-1"},
    },
    "Cluster": {
        "name": "cli-test",
        "backend": "local",
        "pool": {"accelerator_type": {"ref": "Accel"}, "workers": {"ref": "Workers"}},
        "storage": {"kind": "local"},
        "staging": {"bucket": "stage-bucket", "prefix": "runs"},
        "job": {
            "name": "lenet",
            "module": "deeplearning_cfn_tpu.examples.lenet_mnist",
            "global_batch_size": 32,
            "steps_per_epoch_numerator": 60000,
            "args": {"steps": 3},
        },
    },
}
JOB_MODULE = "dlcfn_lifecycle_test_job"


def _port_text(text: str) -> str:
    return text.replace("deeplearning_cfn_tpu.", "deeplearning_cfn_tpu_torch.")


def _write(tmp_path, body, name="cluster.json"):
    path = tmp_path / name
    path.write_text(json.dumps(body))
    return str(path)


def _invoke(main, argv, capsys):
    """(rc, stdout, stderr) of one command; a SystemExit's message as rc."""
    try:
        rc = main(argv)
    except SystemExit as e:
        rc = ("exit", str(e))
    out = capsys.readouterr()
    return rc, out.out, out.err


def _json(text: str):
    """The command's JSON (its last JSON document), without run-dependent keys."""
    start = text.index("{")
    doc = json.loads(text[start:])
    if isinstance(doc, dict):
        for key in ("elapsed_s", "contract_root", "template_to_first_step_s"):
            doc.pop(key, None)
    return doc


@pytest.fixture(autouse=True)
def _no_log_records():
    """Both packages log to stderr; the comparisons read what the commands
    print there themselves."""
    logging.disable(logging.CRITICAL)
    yield
    logging.disable(logging.NOTSET)


@pytest.fixture(autouse=True)
def _fake_clock(monkeypatch):
    """The commands' local backends on a ``FakeClock``: the bootstrap's
    polls take no wall time."""
    from deeplearning_cfn_tpu_torch.provision import local
    from deeplearning_cfn_tpu_torch.utils.timeouts import FakeClock

    monkeypatch.setattr(local, "MonotonicClock", FakeClock)
    if jcli is not None:
        from deeplearning_cfn_tpu.provision import local as jlocal
        from deeplearning_cfn_tpu.utils.timeouts import FakeClock as JaxFakeClock

        monkeypatch.setattr(jlocal, "MonotonicClock", JaxFakeClock)


def _both(tmp_path, monkeypatch, capsys, argv, before=None):
    """The command on the JAX side, then on the port's, each in its own
    ``$DLCFN_ROOT`` (``before()`` runs ahead of each)."""
    out = {}
    for side, main in (("jax", jcli.main), ("port", cli.main)):
        monkeypatch.setenv("DLCFN_ROOT", str(tmp_path / f"{side}-root"))
        if before is not None:
            before()
        out[side] = _invoke(main, argv, capsys)
    return out["jax"], out["port"]


@needs_jax
@pytest.mark.parametrize("command", ["validate", "create", "recover", "delete", "describe"])
def test_command_prints_as_jax(tmp_path, monkeypatch, capsys, command):
    template = _write(tmp_path, TEMPLATE)
    extra = ["-P", "Workers=4"] if command != "delete" else []
    jax_side, port = _both(tmp_path, monkeypatch, capsys, [command, template, *extra])
    assert port[0] == jax_side[0]
    assert port[2].splitlines() == jax_side[2].splitlines()
    if port[0] == 0:
        assert _json(port[1]) == _json(jax_side[1])
    if command == "create":
        assert _json(port[1])["workers"] == 4 and (tmp_path / "port-root" / "env.sh").exists()
    if command == "delete":
        assert _json(port[1]) == {"storage_deleted": False, "broker": "none"}


@needs_jax
@pytest.mark.parametrize("command", ["plan", "startup-script"])
def test_rendering_command_prints_as_jax_apart_from_the_prefix(tmp_path, monkeypatch, capsys,
                                                                command):
    template = _write(tmp_path, TEMPLATE)
    jax_side, port = _both(tmp_path, monkeypatch, capsys, [command, template, "-P", "Workers=4"])
    assert port[0] == jax_side[0] == 0
    assert port[1] == _port_text(jax_side[1]).replace(str(tmp_path / "jax-root"),
                                                     str(tmp_path / "port-root"))
    if command == "plan":
        assert "python -m deeplearning_cfn_tpu_torch.examples.lenet_mnist --steps 3" in port[1]
        assert "NUM_PARALLEL=4" in port[1] and "deeplearning-worker3" in port[1]


@needs_jax
@pytest.mark.parametrize("live", [False, True], ids=["placeholder", "live-contract"])
def test_gen_scripts_as_jax(tmp_path, monkeypatch, capsys, live):
    template = _write(tmp_path, TEMPLATE)
    outs = {}
    for side, main in (("jax", jcli.main), ("port", cli.main)):
        monkeypatch.setenv("DLCFN_ROOT", str(tmp_path / f"{side}-root"))
        if live:
            assert main(["create", template]) == 0
            capsys.readouterr()
        out_dir = tmp_path / f"{side}-scripts"
        rc, out, err = _invoke(main, ["gen-scripts", template, "--out", str(out_dir)], capsys)
        assert rc == 0
        doc = json.loads(out)
        outs[side] = (doc["num_parallel"], err.count("WARNING"),
                      {p.split("/")[-1]: open(p).read() for p in doc["scripts"]})
    jnum, jwarn, jscripts = outs["jax"]
    num, warn, scripts = outs["port"]
    assert (num, warn) == (jnum, jwarn) and sorted(scripts) == sorted(jscripts)
    for host, text in scripts.items():
        want = _port_text(jscripts[host]).replace(str(tmp_path / "jax-root"),
                                                   str(tmp_path / "port-root"))
        assert text == want


@needs_jax
def test_stage_as_jax(tmp_path, monkeypatch, capsys):
    template = _write(tmp_path, TEMPLATE)
    data = tmp_path / "dataset"
    data.mkdir()
    (data / "part-0.bin").write_bytes(bytes(range(200)) * 10)
    jax_side, port = _both(tmp_path, monkeypatch, capsys,
                           ["stage", template, "--data", str(data), "--code", str(tmp_path)
                            + "/cluster.json"])
    assert port[0] == jax_side[0] == 0
    assert _json(port[1]) == _json(jax_side[1])
    assert (tmp_path / "port-root" / "buckets" / "stage-bucket" / "runs" / "dataset.tar").exists()


@needs_jax
@pytest.mark.parametrize("argv", [["-P", "Workers=99"], ["-P", "Nope=1"], ["-P", "Workers"]],
                         ids=["out-of-range", "unknown", "no-equals"])
def test_bad_parameters_exit_as_jax(tmp_path, monkeypatch, capsys, argv):
    template = _write(tmp_path, TEMPLATE)
    jax_side, port = _both(tmp_path, monkeypatch, capsys, ["validate", template, *argv])
    assert port[0] == jax_side[0] and port[0][0] == "exit"


@needs_jax
def test_missing_template_and_print_requests_off_gcp_exit_as_jax(tmp_path, monkeypatch, capsys):
    template = _write(tmp_path, TEMPLATE)
    for argv in (["validate", str(tmp_path / "missing.json")],
                 ["create", template, "--print-requests"]):
        jax_side, port = _both(tmp_path, monkeypatch, capsys, argv)
        assert port[0] == jax_side[0] and port[0][0] == "exit"


def _agents(port: int, root: Path, token: str, workers: int = 2):
    """The VMs' boot processes: the port's agent, one a worker, each with
    its own contract root."""
    import os
    import subprocess

    base = {k: v for k, v in os.environ.items() if not k.startswith("DLCFN_")}
    return [subprocess.Popen(
        [sys.executable, "-m", "deeplearning_cfn_tpu_torch.cluster.agent_main"],
        env={**base, "DLCFN_CLUSTER": "cli-test", "DLCFN_WORKER_INDEX": str(i),
             "DLCFN_BROKER": f"127.0.0.1:{port}", "DLCFN_GROUPS": "cli-test-workers",
             "DLCFN_BOOTSTRAP_BUDGET_S": "60", "DLCFN_POLL_INTERVAL_S": "0.1",
             "DLCFN_ROOT": str(root / f"vm{i}"), "DLCFN_BROKER_TOKEN": token},
        cwd=Path(__file__).resolve().parents[1], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for i in range(workers)]


@pytest.mark.parametrize("command", ["create", "run", "recover"])
def test_broker_names_its_slice(tmp_path, monkeypatch, capsys, lossy_job, command):
    """``--broker HOST:PORT``: the production topology, against a broker the
    port built.  The command publishes group state and waits for agent
    processes (the port's ``agent_main``, for the JAX command too: the wire
    is the same); every process writes the same contract, the operator's
    ambient token authenticates, and where the JAX package is there to
    compare with, both commands print the same JSON."""
    from deeplearning_cfn_tpu_torch.cluster.broker_client import BrokerProcess

    body = _job_template(args={"steps": 3})
    body["Cluster"]["timeouts"] = {"cluster_ready_s": 60.0, "controller_launch_s": 30.0,
                                   "poll_interval_s": 0.1}
    template = _write(tmp_path, body)
    monkeypatch.setenv("DLCFN_BROKER_TOKEN", "tok-lifecycle")
    outs = {}
    sides = [("port", cli.main)] + ([("jax", jcli.main)] if jcli is not None else [])
    for side, main in sides:
        # A broker each: agents that start ahead of the command would read
        # the other side's cluster before the command scrubs it.
        root = tmp_path / side
        monkeypatch.setenv("DLCFN_ROOT", str(root / "controller"))
        lossy_job.update(kills=0, calls=0)
        with BrokerProcess(token="tok-lifecycle") as broker:
            agents = _agents(broker.port, root, "tok-lifecycle")
            try:
                outs[side] = _invoke(main, [command, template, "--broker",
                                            f"127.0.0.1:{broker.port}"], capsys)
                logs = [a.communicate(timeout=60)[0] for a in agents]
            finally:
                for a in agents:
                    if a.poll() is None:
                        a.kill()
                        a.wait()
        assert [a.returncode for a in agents] == [0, 0], logs
        contracts = {(root / d / "contract.json").read_bytes()
                     for d in ("controller", "vm0", "vm1")}
        assert len(contracts) == 1
    port = outs["port"]
    assert port[0] == 0
    if "jax" in outs:
        assert outs["jax"][0] == 0
        assert _json(port[1]) == _json(outs["jax"][1])
    progress = [ln for ln in port[2].splitlines() if "CREATE_IN_PROGRESS" in ln]
    assert all(ln.endswith("2/2 workers up") for ln in progress)
    if command == "run":
        assert _json(port[1])["result"]["episode"] == 1


# --- run ------------------------------------------------------------------------


@pytest.fixture()
def lossy_job(monkeypatch):
    """A job module for the template: each call returns its episode number
    and, while ``kills`` lasts, loses the coordinator of the cluster the
    command provisioned (on whichever side's backend that is)."""
    backends, state = [], {"kills": 0, "calls": 0}
    for mod in (cli, jcli):
        if mod is None:
            continue
        orig = mod._backend_for

        def capture(*a, _orig=orig, **k):
            backends.append(_orig(*a, **k))
            return backends[-1]
        monkeypatch.setattr(mod, "_backend_for", capture)

    def main(argv):
        state["calls"] += 1
        if state["kills"]:
            state["kills"] -= 1
            backend = backends[-1]
            group = backend.describe_group("cli-test-workers")
            backend.kill_instance(min(group.instances, key=lambda i: i.index).instance_id)
        return {"episode": state["calls"], "argv": argv}

    monkeypatch.setitem(sys.modules, JOB_MODULE, types.SimpleNamespace(main=main))
    return state


def _job_template(module=JOB_MODULE, args=None):
    body = json.loads(json.dumps(TEMPLATE))
    body["Cluster"]["job"]["module"] = module
    if args is not None:
        body["Cluster"]["job"]["args"] = args
    return body


@needs_jax
@pytest.mark.parametrize("kills, budget", [(0, 1), (1, 1), (2, 1), (3, 2)])
def test_run_auto_recover_as_jax(tmp_path, monkeypatch, capsys, lossy_job, kills, budget):
    """Up to N recoveries, then the refusal: rc 1 and JAX's message once an
    episode still ends with a loss pending."""
    template = _write(tmp_path, _job_template())
    outs = {}
    for side, main in (("jax", jcli.main), ("port", cli.main)):
        monkeypatch.setenv("DLCFN_ROOT", str(tmp_path / f"{side}-root"))
        lossy_job.update(kills=kills, calls=0)
        outs[side] = _invoke(main, ["run", template, "--auto-recover", str(budget)], capsys)
    jax_side, port = outs["jax"], outs["port"]
    assert port[0] == jax_side[0]
    if kills > budget:
        assert port[0] == 1
        failed = [ln for ln in port[2].splitlines() if ln.startswith("RUN FAILED")]
        assert failed == [ln for ln in jax_side[2].splitlines() if ln.startswith("RUN FAILED")]
        assert failed[0].startswith(f"RUN FAILED: instance loss after {budget} recoveries")
    else:
        assert port[0] == 0
        record = json.loads(port[1].strip().splitlines()[-1])
        assert record == json.loads(jax_side[1].strip().splitlines()[-1])
        assert record["recoveries"] == kills and record["result"]["episode"] == kills + 1


@needs_jax
def test_run_without_auto_recover_runs_once_as_jax(tmp_path, monkeypatch, capsys, lossy_job):
    template = _write(tmp_path, _job_template(args={"steps": 3, "flag": "x y"}))
    jax_side, port = _both(tmp_path, monkeypatch, capsys, ["run", template],
                           before=lambda: lossy_job.update(kills=0, calls=0))
    assert port[0] == jax_side[0] == 0
    assert port[1].strip().splitlines()[-1] == jax_side[1].strip().splitlines()[-1]
    assert json.loads(port[1].strip().splitlines()[-1])["result"]["argv"] == [
        "--flag", "x y", "--steps", "3"]


@needs_jax
def test_run_fails_on_a_job_module_the_port_lacks(tmp_path, monkeypatch, capsys):
    template = _write(tmp_path, _job_template("deeplearning_cfn_tpu.examples.not_ported"))
    monkeypatch.setenv("DLCFN_ROOT", str(tmp_path / "root"))
    rc, _, err = _invoke(cli.main, ["run", template], capsys)
    assert rc == 1 and "RUN FAILED" in err and "examples.not_ported" in err


def test_run_trains_the_port_s_lenet_on_the_cpu_when_asked(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("DLCFN_ROOT", str(tmp_path / "root"))
    template = _write(tmp_path, _job_template(
        "deeplearning_cfn_tpu.examples.lenet_mnist",
        {"steps": 3, "device": "cpu", "log_every": 1,
         "checkpoint_dir": str(tmp_path / "mnt" / "ckpt")}))
    rc, out, _ = _invoke(cli.main, ["run", template, "--auto-recover", "1"], capsys)
    assert rc == 0
    record = json.loads(out.strip().splitlines()[-1])
    assert set(record) == {"job", "result", "recoveries", "template_to_first_step_s"}
    assert record["recoveries"] == 0 and record["template_to_first_step_s"] > 0
    result = record["result"]
    assert (result["device"], result["steps"], result["start_step"], result["end_step"]) == (
        "cpu", 3, 0, 3)
    # The checkpoint on the mount resumes the next run.
    rc, out, _ = _invoke(cli.main, ["run", template], capsys)
    assert rc == 0 and json.loads(out.strip().splitlines()[-1])["result"]["start_step"] == 3


def test_run_trains_on_the_card_by_default(tmp_path, monkeypatch, capsys):
    """The committed template's job trains on ``cuda``; without a card it
    raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would train on it")
    monkeypatch.setenv("DLCFN_ROOT", str(tmp_path / "root"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["run", str(Path(__file__).resolve().parent.parent / "templates/local.json")])
