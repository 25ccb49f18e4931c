"""The port's ``sched-flash-crowd`` chaos scenario against the JAX package's.

The port's scenario runs on four CPU gloo ranks (2 slices x fsdp 2, the
arbiter, SLO engine, driver and serve front end in rank 0's process); JAX's
runs one SPMD trainer over eight virtual devices (2 slices x fsdp 4).  The
serve pool's tiny f32 Llama carries JAX's seed-0 weights
(``interop.llama_params_from_jax``).  For seeds 0 and 1 the port's report
must pass, and its decisions equal JAX's: the fault schedule, the replica it
kills and when, the SLO timeline (the rounds the page fires and resolves),
the requests, completions and replays, the drain, the grad-accumulation
history and the arbiter's counters.  The meshes differ only by the device
count (4 ranks against 8 devices); the losses are each package's own MLP
held to its own uninterrupted run.
"""

import json

import pytest

torch = pytest.importorskip("torch")

try:
    import jax
    import jax.numpy as jnp

    from deeplearning_cfn_tpu.chaos import scenarios as jscenarios
    from deeplearning_cfn_tpu.models import llama as jllama
except ImportError:  # the card's host
    jax = None

from deeplearning_cfn_tpu_torch import cli, interop  # noqa: E402
from deeplearning_cfn_tpu_torch.chaos import scenarios  # noqa: E402
from deeplearning_cfn_tpu_torch.models import llama  # noqa: E402

pytestmark = pytest.mark.skipif(jax is None, reason="needs JAX, the reference")

DECISIONS = ("schedule", "kill_round", "victim", "timeline", "requests", "completions",
             "replayed", "drain_rounds", "grad_accum_mid", "grad_accum_final",
             "arbiter_counters")


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    cfg = llama.LlamaConfig.tiny(vocab_size=64, seq_len=64, dtype=torch.float32)
    jcfg = jllama.LlamaConfig.tiny(vocab_size=64, seq_len=64, dtype=jnp.float32)
    params = jllama.init_params(jcfg, jax.random.key(0))
    path = tmp_path_factory.mktemp("serve") / "tiny.pt"
    torch.save(interop.llama_params_from_jax(cfg, jax.device_get(params)), path)
    return str(path)


@pytest.mark.parametrize("seed", [0, 1])
def test_report_passes_and_its_decisions_equal_jax(seed, weights):
    port = scenarios.sched_flash_crowd(seed, device="cpu", serve_weights=weights).to_dict()
    # JAX's report on the wire (its timeline's tuples as JSON lists).
    ref = json.loads(json.dumps(jscenarios.run_scenario("sched-flash-crowd", seed).to_dict()))
    assert port["passed"] and port["violations"] == [], port["violations"]
    assert ref["passed"]
    assert {k: port["details"][k] for k in DECISIONS} == {k: ref["details"][k]
                                                          for k in DECISIONS}
    assert port["details"]["mid_topology"] == {"devices": 2, "axes": {"fsdp": 2}}
    assert ref["details"]["mid_topology"] == {"devices": 4, "axes": {"fsdp": 4}}
    assert port["details"]["post_topology"] == {"devices": 4, "axes": {"dp": 2, "fsdp": 2}}
    assert ref["details"]["post_topology"] == {"devices": 8, "axes": {"dp": 2, "fsdp": 4}}
    # JAX's invariants, and one more: the parked ranks came back.
    assert len(port["invariants"]) == len(ref["invariants"]) + 1
    assert port["details"]["parked_at"] < port["details"]["rejoined_at"]
    assert json.loads(json.dumps(port)) == port  # the report's wire shape is JSON


def test_scenario_is_listed(capsys):
    assert cli.main(["chaos", "--list"]) == 0
    out = capsys.readouterr().out
    assert "sched-flash-crowd" in out and "flash-crowd, replica-loss, preemption" in out
    assert list(scenarios.SCENARIOS) == [
        "silent-death", "partition", "flaky-rpc", "slow-disk", "slice-loss-live",
        "data-reshard-live", "straggler", "serve-replica-loss", "broker-failover",
        "split-brain", "shard-failover", "degraded-pair-heal", "alert-storm",
        "sched-flash-crowd", "gauntlet"]
    assert list(scenarios.SCENARIOS) == list(jscenarios.SCENARIOS)  # JAX's, in its order
