"""The port's chaos catalog against the JAX package's.

The ten control-plane scenarios (virtual clocks, no trainer) and
``serve-replica-loss`` run on seeds 0 and 1: the port's report passes and
its ``to_dict()`` equals JAX's field for field (JAX's through
``json.loads(json.dumps(...))``, its tuples as JSON lists).  The one
exception is ``flaky-rpc`` on seed 0: JAX's report fails its clock check
alone, because ``sum()`` of floats rounds differently since Python 3.12
(one ulp off the clock's own additions), while the port compares with the
clock's own order of additions; a test pins that cause.  The serving
scenario's tiny f32 Llama carries JAX's seed-0 weights
(``interop.llama_params_from_jax``), and every greedy token equals JAX's.

``data-reshard-live`` runs seed 0 (its second seed is slow, as JAX's is):
the plane's record ids, partitions and consumption order equal JAX's on
the same shard files; its trainer runs on four CPU gloo ranks (2 slices x
fsdp 2) where JAX's runs one SPMD program over eight virtual devices, from
JAX's initial weights (``interop.dense_params_from_jax``) on the same
global batches, so the losses are held to JAX's within the scenario's own
tolerance (rtol 5e-3, atol 1e-4) and the invariants are JAX's.  Each JAX
report is computed once per module.
"""

import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax
    import jax.numpy as jnp

    from deeplearning_cfn_tpu.chaos import scenarios as jscenarios
    from deeplearning_cfn_tpu.models import llama as jllama
    from deeplearning_cfn_tpu.train import datastream as jdatastream
except ImportError:  # the card's host
    jax = None

from deeplearning_cfn_tpu_torch import cli, interop  # noqa: E402
from deeplearning_cfn_tpu_torch.chaos import scenarios  # noqa: E402
from deeplearning_cfn_tpu_torch.models import llama  # noqa: E402

pytestmark = pytest.mark.skipif(jax is None, reason="needs JAX, the reference")

HOST_ONLY = ["silent-death", "partition", "flaky-rpc", "slow-disk", "straggler",
             "broker-failover", "split-brain", "shard-failover", "degraded-pair-heal",
             "alert-storm"]
JAX_CATALOG = ["silent-death", "partition", "flaky-rpc", "slow-disk", "slice-loss-live",
               "data-reshard-live", "straggler", "serve-replica-loss", "broker-failover",
               "split-brain", "shard-failover", "degraded-pair-heal", "alert-storm",
               "sched-flash-crowd", "gauntlet"]
CLOCK_CHECK = "all waiting happened on the injected clock (no real sleeps)"
RTOL, ATOL = 5e-3, 1e-4


@pytest.fixture(scope="module")
def jax_report():
    """JAX's report of (scenario, seed), on the wire, each computed once."""
    cache = {}

    def get(name, seed):
        if (name, seed) not in cache:
            cache[name, seed] = json.loads(json.dumps(
                jscenarios.run_scenario(name, seed).to_dict()))
        return cache[name, seed]

    return get


@pytest.fixture(scope="module")
def serve_weights(tmp_path_factory):
    cfg = llama.LlamaConfig.tiny(vocab_size=64, seq_len=64, dtype=torch.float32)
    jcfg = jllama.LlamaConfig.tiny(vocab_size=64, seq_len=64, dtype=jnp.float32)
    params = jllama.init_params(jcfg, jax.random.key(0))
    path = tmp_path_factory.mktemp("serve") / "tiny.pt"
    torch.save(interop.llama_params_from_jax(cfg, jax.device_get(params)), path)
    return str(path)


def test_catalog_is_jax_in_jax_order():
    assert list(scenarios.SCENARIOS) == list(jscenarios.SCENARIOS) == JAX_CATALOG
    assert scenarios.SCENARIO_FAULTS == {k: tuple(v) for k, v in
                                         jscenarios.SCENARIO_FAULTS.items()}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", HOST_ONLY)
def test_host_scenario_report_equals_jax(name, seed, jax_report):
    port = scenarios.run_scenario(name, seed, device="cpu").to_dict()
    ref = jax_report(name, seed)
    assert port["passed"] and port["violations"] == [], port["violations"]
    assert json.loads(json.dumps(port)) == port  # the wire shape is JSON
    if name == "flaky-rpc" and not ref["passed"]:
        # JAX's sum() check, one ulp off on this seed (see the next test).
        assert ref["violations"] == [CLOCK_CHECK]
        at = port["invariants"].index(CLOCK_CHECK)
        assert port["invariants"][:at] + port["invariants"][at + 1:] == ref["invariants"]
        rest = {k: v for k, v in port.items() if k not in ("passed", "invariants",
                                                             "violations")}
        assert rest == {k: v for k, v in ref.items() if k in rest}
        return
    assert port == ref


def test_flaky_rpc_clock_check_cause_on_seed_0():
    """The burst phase of ``flaky-rpc`` on seed 0: the clock's now() is its
    sleeps added one by one (a left fold of ``+`` from 0.0), and ``sum()``
    of the same sleeps is one ulp more (compensated summation since Python
    3.12).  The port's check folds; its reported wait stays ``round(sum)``."""
    from deeplearning_cfn_tpu_torch.chaos.injectors import FlakyOpener, RecordingClock
    from deeplearning_cfn_tpu_torch.provision.gcp_transport import GoogleAuthTransport

    clock = RecordingClock()
    transport = GoogleAuthTransport(
        project="chaos", token_provider=lambda: ("tok", 1e18),
        opener=FlakyOpener(seed=0, error_rate=0.45, reset_rate=0.15), max_retries=8,
        backoff_s=0.05, clock=clock, seed=0)
    for i in range(20):
        transport("GET", f"projects/p/locations/z/nodes/n{i}", None)
    folded = 0.0
    for s in clock.sleeps:
        folded += s
    assert len(clock.sleeps) == 21
    assert clock.now() == folded == 7.294179573128128
    assert sum(clock.sleeps) == 7.294179573128129
    assert sum(clock.sleeps) - clock.now() == math.ulp(clock.now())
    report = scenarios.run_scenario("flaky-rpc", 0).to_dict()
    assert report["passed"] and CLOCK_CHECK in report["invariants"]


@pytest.mark.parametrize("seed", [0, 1])
def test_serve_replica_loss_equals_jax(seed, serve_weights, jax_report):
    port = scenarios.serve_replica_loss(seed, device="cpu", serve_weights=serve_weights)
    ref = jax_report("serve-replica-loss", seed)
    assert port.passed, port.violations
    assert port.to_dict() == ref
    # Every greedy token: JAX's undisturbed reference run on its own engine
    # (the JAX scenario holds its failover run equal to it).
    from deeplearning_cfn_tpu.analysis.schedules import VirtualClock
    from deeplearning_cfn_tpu.serve import (
        ContinuousBatchingEngine,
        ServeConfig,
        TrafficConfig,
        run_load,
    )

    jcfg = jllama.LlamaConfig.tiny(vocab_size=64, seq_len=64, dtype=jnp.float32)
    clock = VirtualClock()
    engine = ContinuousBatchingEngine(
        jcfg, jllama.init_params(jcfg, jax.random.key(0)),
        ServeConfig(num_slots=4, block_size=4, blocks_per_slot=8, prefill_len=16),
        clock=clock, name="ref", journal=False)
    theirs = run_load(engine, TrafficConfig(requests=80, seed=seed), clock).completions
    mine = port.observed["completions"]
    assert sorted(mine) == sorted(theirs)
    assert all(list(map(int, mine[k])) == list(map(int, theirs[k])) for k in theirs)


def _jax_plane(paths, seed):
    """JAX's phase 1 of ``data-reshard-live`` over the same shard files."""
    from deeplearning_cfn_tpu.cluster.contract import ClusterContract
    from deeplearning_cfn_tpu.train.records import Field, RecordSpec

    contract = ClusterContract.build(
        cluster_name="chaos-data", coordinator_ip="10.0.0.1",
        other_worker_ips=["10.0.0.2", "10.0.0.3", "10.0.0.4"], chips_per_worker=2,
        storage_mount="/mnt/none",
        slices={"s0": ["10.0.0.1", "10.0.0.2"], "s1": ["10.0.0.3", "10.0.0.4"]})
    spec = RecordSpec((Field("x", "uint8", (2,)), Field("y", "int32", ())))
    plane = jdatastream.DataStreamPlane(contract, paths, spec, batch_size=5, seed=seed,
                                        loop=False)
    ids = {h: [] for h in plane.hosts}
    iters = {h: plane.stream(h).batches() for h in plane.hosts}
    for _ in range(2):
        for h in list(plane.hosts):
            b = next(iters[h], None)
            if b is not None:
                ids[h].extend(int(v) for v in b.y)
    plane.reshard(contract.surviving(["s1"]))
    for h in tuple(plane.hosts):
        for b in iters[h]:
            ids[h].extend(int(v) for v in b.y)
    assigned = jdatastream.assign_shards(contract.datastream_hosts(), len(paths), seed, 0)
    return ids, plane.journal_progress(), assigned


def mlp_weights(seed, path):
    """JAX's initial MLP of the training scenarios (``_Net`` from
    ``PRNGKey(seed)``) as the port's state dict, saved at ``path``."""
    import flax.linen as nn

    class _Net(nn.Module):
        @nn.compact
        def __call__(self, x):
            x = x.reshape((x.shape[0], -1))
            x = nn.relu(nn.Dense(256, name="fc1")(x))
            x = nn.relu(nn.Dense(256, name="fc2")(x))
            return nn.Dense(10, name="head")(x)

    params = _Net().init(jax.random.PRNGKey(seed), np.zeros((32, 8, 8, 1), np.float32))
    torch.save(interop.dense_params_from_jax(jax.device_get(params["params"])), path)
    return str(path)


def test_data_plane_consumption_equals_jax(tmp_path):
    from deeplearning_cfn_tpu_torch.train.datastream import assign_shards

    paths, spec, total = scenarios.id_shards(tmp_path, 0)
    ids, snap = scenarios.plane_consumption(paths, spec, 0)
    jids, jsnap, jassigned = _jax_plane(paths, 0)
    assert ids == jids  # every host's ids, in consumption order
    wall = "records_per_s"  # the only wall-clock field
    assert {k: v for k, v in snap.items() if k != wall} == {
        k: v for k, v in jsnap.items() if k != wall}
    hosts = scenarios._data_contract().datastream_hosts()
    assert {h: list(w) for h, w in assign_shards(hosts, len(paths), 0, 0).items()} == {
        h: list(w) for h, w in jassigned.items()}
    assert sorted(v for v in sum(ids.values(), [])) == list(range(total))


def test_data_reshard_live_seed_0_holds_jax(tmp_path, jax_report):
    """The port's report passes with JAX's invariants, its losses held to
    JAX's (its trainer on four ranks, JAX's on eight virtual devices, the
    same weights and global batches)."""
    port = scenarios.data_reshard_live(0, device="cpu",
                                       weights=mlp_weights(0, tmp_path / "mlp.pt")).to_dict()
    ref = jax_report("data-reshard-live", 0)
    assert port["passed"] and port["violations"] == [], port["violations"]
    assert ref["passed"]
    assert port["invariants"] == ref["invariants"]
    d, r = port["details"], ref["details"]
    assert {k: d[k] for k in ("stop_step", "total_records", "shard_sizes")} == {
        k: r[k] for k in ("stop_step", "total_records", "shard_sizes")}
    np.testing.assert_allclose(d["straight_losses"], r["straight_losses"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(d["resumed_losses"], r["resumed_losses"], rtol=RTOL, atol=ATOL)
    assert d["resumed_losses"] == d["straight_losses"]


@pytest.mark.slow
def test_data_reshard_live_second_seed_holds():
    report = scenarios.data_reshard_live(1, device="cpu")
    assert report.passed, report.violations
    assert report.invariants


@pytest.mark.slow
@pytest.mark.parametrize("name", HOST_ONLY + ["serve-replica-loss", "data-reshard-live"])
def test_scenario_reports_deterministic_per_seed(name):
    first = scenarios.run_scenario(name, 0, device="cpu").to_dict()
    second = scenarios.run_scenario(name, 0, device="cpu").to_dict()
    assert json.dumps(first, sort_keys=True) == json.dumps(second, sort_keys=True)


def test_training_scenarios_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for name in ("data-reshard-live", "serve-replica-loss", "gauntlet"):
        with pytest.raises(RuntimeError):
            scenarios.run_scenario(name, 0)  # device "cuda" by default


def test_unknown_scenario_names_the_catalog():
    with pytest.raises(KeyError, match="flaky-rpc"):
        scenarios.run_scenario("no-such-scenario", 0)


def test_cli_chaos_lists_every_entry_with_its_faults(capsys):
    assert cli.main(["chaos", "--list"]) == 0
    out = capsys.readouterr().out
    for name in JAX_CATALOG:
        assert name in out
        assert "faults: " + ", ".join(scenarios.SCENARIO_FAULTS[name]) in out
    assert cli.main(["chaos", "--scenario", "nope"]) == 2


def test_cli_chaos_runs_a_scenario(capsys):
    assert cli.main(["chaos", "--scenario", "flaky-rpc", "--seed", "1", "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["scenario"] == "flaky-rpc" and report["seed"] == 1 and report["passed"]


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(5))
def test_chaos_soak_all_scenarios(seed):
    """JAX's soak (``tests/test_chaos.py:238``): every scenario but the
    gauntlet (its own file) passes on five seeds, on the CPU."""
    for name in (n for n in scenarios.SCENARIOS if n != "gauntlet"):
        report = scenarios.run_scenario(name, seed, device="cpu")
        assert report.passed, f"{name} seed={seed}: {report.violations}"
