"""The recreate-and-resume tier against the JAX package's, on the CPU.

``cluster/recovery.py``'s ``RecoveryManager`` and ``run_with_recovery`` and
``utils/resilience.py``'s ``RetryPolicy`` are copies; each test drives the
JAX package's and the port's on the same spec, ``FakeClock`` and seeds and
holds them equal:

- the manager arms on the coordinator's loss, recreates the cluster on
  the retained storage and journals ``recovery_start``, the ``recover``
  span and ``recovery_done`` (fields equal; the span's seconds aside);
- ``run_with_recovery``: no loss, no recovery; its jittered
  ``recovery_backoff`` delays on the policy's clock; its refusal past
  ``max_recoveries`` (the same message);
- the full loop over LeNet — train five steps with a checkpoint every
  step, lose the coordinator, recover, resume at step 5, train five more
  — on the JAX initial weights carried into the port's LeNet and the same
  batches: the port's ten losses within JAX's own test tolerance (rtol
  2e-4) of JAX's loop, and bitwise the port's uninterrupted run;
- ``RetryPolicy``: the delays, the classification and the exhaustion.

And the examples' resume: a run resumed from its checkpoint trains on the
batches the straight run trains on from that step (the synthetic streams
used to start again from batch 0), bitwise the straight run.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax
    import jax.numpy as jnp

    from deeplearning_cfn_tpu.cluster import recovery as jrecovery
    from deeplearning_cfn_tpu.config import schema as jschema
    from deeplearning_cfn_tpu.models.lenet import LeNet as JaxLeNet
    from deeplearning_cfn_tpu.obs import recorder as jrecorder
    from deeplearning_cfn_tpu.parallel.mesh import MeshSpec, build_mesh
    from deeplearning_cfn_tpu.provision import local as jlocal
    from deeplearning_cfn_tpu.provision import provisioner as jprovisioner
    from deeplearning_cfn_tpu.train.checkpoint import Checkpointer as JaxCheckpointer
    from deeplearning_cfn_tpu.train.data import SyntheticDataset as JaxSyntheticDataset
    from deeplearning_cfn_tpu.train.trainer import Trainer as JaxTrainer
    from deeplearning_cfn_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
    from deeplearning_cfn_tpu.utils import resilience as jresilience
    from deeplearning_cfn_tpu.utils import timeouts as jtimeouts
except ImportError:  # the card's host: only the tests without the JAX reference run
    jax = None

from deeplearning_cfn_tpu_torch.cluster import recovery  # noqa: E402
from deeplearning_cfn_tpu_torch.config import schema  # noqa: E402
from deeplearning_cfn_tpu_torch.models.lenet import LeNet  # noqa: E402
from deeplearning_cfn_tpu_torch.obs import recorder  # noqa: E402
from deeplearning_cfn_tpu_torch.provision import local, provisioner  # noqa: E402
from deeplearning_cfn_tpu_torch.train.checkpoint import Checkpointer  # noqa: E402
from deeplearning_cfn_tpu_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from deeplearning_cfn_tpu_torch.utils import resilience, timeouts  # noqa: E402

needs_jax = pytest.mark.skipif(jax is None, reason="needs JAX, the reference")

NAME = "test-cluster"
GROUP = f"{NAME}-workers"
# JAX's own tolerance for its recovered trajectory (tests/test_recovery.py).
LOOP_RTOL = 2e-4


def _sides():
    return {
        "jax": dict(schema=jschema, local=jlocal, provisioner=jprovisioner, recovery=jrecovery,
                    recorder=jrecorder, timeouts=jtimeouts, resilience=jresilience),
        "port": dict(schema=schema, local=local, provisioner=provisioner, recovery=recovery,
                     recorder=recorder, timeouts=timeouts, resilience=resilience),
    }


def _provisioner(m, root, workers=4, clock=None):
    s = m["schema"]
    spec = s.ClusterSpec(
        name=NAME, backend="local",
        pool=s.NodePool(accelerator_type="local-1", workers=workers),
        storage=s.StorageSpec(kind="local"),
        timeouts=s.TimeoutSpec(cluster_ready_s=3300.0, controller_launch_s=600.0),
        job=s.JobSpec(global_batch_size=workers * 8))
    backend = m["local"].LocalBackend(clock=clock or m["timeouts"].FakeClock())
    return backend, m["provisioner"].Provisioner(backend, spec, contract_root=root)


def _kill_coordinator(backend):
    coord = min(backend.describe_group(GROUP).instances, key=lambda i: i.index)
    backend.kill_instance(coord.instance_id)


def _journal(m, path):
    """The journal's events without the wall time, host, pid and span seconds."""
    m["recorder"].configure(None)
    return [{k: v for k, v in e.items() if k not in ("ts", "host", "pid", "seconds")}
            for e in m["recorder"].read_journal(path)]


@needs_jax
def test_manager_arms_on_coordinator_loss_as_jax(tmp_path):
    out = {}
    for side, m in _sides().items():
        journal = tmp_path / f"{side}.jsonl"
        m["recorder"].configure(journal)
        backend, prov = _provisioner(m, tmp_path / side)
        result = prov.provision()
        manager = m["recovery"].RecoveryManager(prov)
        manager.attach(result)
        trace = [manager.needs_recovery]
        _kill_coordinator(backend)
        trace += [manager.needs_recovery, [e.instance_id for e in manager.losses]]
        recovered = manager.recover()
        trace += [manager.needs_recovery, recovered.contract.workers_count,
                  recovered.storage.storage_id == result.storage.storage_id,
                  recovered.storage.created, prov.describe()]
        # The new generation's controller re-arms the manager.
        _kill_coordinator(backend)
        trace.append(manager.needs_recovery)
        out[side] = (trace, _journal(m, journal))
    assert out["port"] == out["jax"]
    trace, events = out["port"]
    assert trace[:2] == [False, True] and trace[3] is False and trace[6] is False
    kinds = [e["kind"] for e in events]
    assert kinds.count("recovery_start") == kinds.count("recovery_done") == 1
    assert {"kind": "span", "span": "recover", "ok": True} in events


@needs_jax
def test_no_loss_means_no_recovery_as_jax(tmp_path):
    for side, m in _sides().items():
        _, prov = _provisioner(m, tmp_path / side)
        calls = []
        out, result, recoveries = m["recovery"].run_with_recovery(
            prov, lambda r: calls.append(r.contract.workers_count) or {"ok": True})
        assert (out, recoveries, calls) == ({"ok": True}, 0, [4])


@needs_jax
def test_recovery_backoff_and_give_up_as_jax(tmp_path):
    """Every episode loses the coordinator: two recoveries, each after a
    jittered backoff on the policy's clock, then the refusal."""
    out = {}
    for side, m in _sides().items():
        journal = tmp_path / f"{side}.jsonl"
        m["recorder"].configure(journal)
        clock = m["timeouts"].FakeClock()
        backend, prov = _provisioner(m, tmp_path / side, workers=2, clock=clock)
        policy = m["resilience"].RetryPolicy(base_s=1.0, cap_s=30.0, clock=clock, seed=7)
        episodes = []

        def train_once(result):
            episodes.append(result.storage.storage_id)
            _kill_coordinator(backend)
            return {"episode": len(episodes)}

        with pytest.raises(RuntimeError) as e:
            m["recovery"].run_with_recovery(prov, train_once, max_recoveries=2, policy=policy)
        out[side] = (str(e.value), episodes, clock.now(), _journal(m, journal))
    assert out["port"] == out["jax"]
    message, episodes, now, events = out["port"]
    assert message.startswith("instance loss after 2 recoveries; giving up")
    assert episodes == ["fs-0001"] * 3
    backoffs = [e["delay_s"] for e in events if e["kind"] == "recovery_backoff"]
    assert len(backoffs) == 2 and all(1.0 <= d <= 30.0 for d in backoffs)
    assert now >= sum(backoffs)


# --- the full loop over LeNet --------------------------------------------------


def _lenet_from_jax(params) -> dict:
    """Flax LeNet parameters (HWIO convs, [in, out] dense) as the port's."""
    p = jax.device_get(params)
    sd = {}
    for name in ("conv1", "conv2"):
        sd[f"{name}.weight"] = torch.from_numpy(np.transpose(np.asarray(p[name]["kernel"]),
                                                             (3, 2, 0, 1)).copy())
        sd[f"{name}.bias"] = torch.from_numpy(np.asarray(p[name]["bias"]).copy())
    for name in ("fc1", "fc2"):
        sd[f"{name}.weight"] = torch.from_numpy(np.asarray(p[name]["kernel"]).T.copy())
        sd[f"{name}.bias"] = torch.from_numpy(np.asarray(p[name]["bias"]).copy())
    return sd


@needs_jax
def test_kill_recover_resume_loop_over_lenet_matches_jax(tmp_path):
    batches = list(JaxSyntheticDataset.mnist_like(batch_size=32).batches(10))
    jcfg = dict(learning_rate=0.05, matmul_precision="float32")

    def jax_trainer():
        return JaxTrainer(JaxLeNet(), build_mesh(MeshSpec(), jax.devices()[:1]),
                          JaxTrainerConfig(**jcfg))

    jstate0 = jax_trainer().init(jax.random.key(0), jnp.asarray(batches[0].x))
    weights = _lenet_from_jax(jstate0.params)

    def port_trainer():
        t = Trainer(lambda g: LeNet(generator=g), TrainerConfig(**jcfg), device="cpu")
        state = t.init(seed=0)
        state.model.load_state_dict(weights, strict=True)
        return t, state

    losses = {}
    for side, m in _sides().items():
        backend, prov = _provisioner(m, tmp_path / f"{side}-root")
        ckpt_dir = tmp_path / f"{side}-mount" / "ckpt"
        episodes = []

        def train_once(result):
            if side == "jax":
                trainer = jax_trainer()
                state = trainer.init(jax.random.key(0), jnp.asarray(batches[0].x))
                ckpt = JaxCheckpointer(ckpt_dir, interval_s=None, every_steps=1,
                                       async_save=False)
            else:
                trainer, state = port_trainer()
                ckpt = Checkpointer(ckpt_dir, interval_s=None, every_steps=1,
                                    async_save=False)
            start = 0
            restored = ckpt.restore_latest(state)
            if restored is not None:
                state, start = restored
            state, ep_losses = trainer.fit(state, iter(batches[start:]), steps=5,
                                           checkpointer=ckpt)
            if side == "jax":
                ckpt.wait()
            ckpt.close()
            episodes.append((start, [float(x) for x in ep_losses]))
            if len(episodes) == 1:
                _kill_coordinator(backend)
            return {"final_step": start + len(ep_losses)}

        out, result, recoveries = m["recovery"].run_with_recovery(prov, train_once,
                                                                  max_recoveries=1)
        assert recoveries == 1 and out == {"final_step": 10}
        assert [start for start, _ in episodes] == [0, 5]
        assert not result.storage.created
        losses[side] = episodes[0][1] + episodes[1][1]

    trainer, state = port_trainer()
    _, straight = trainer.fit(state, iter(batches), steps=10)
    assert losses["port"] == [float(x) for x in straight]
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=LOOP_RTOL)


# --- RetryPolicy -----------------------------------------------------------------


@needs_jax
def test_retry_policy_as_jax():
    out = {}
    for side, m in _sides().items():
        r, t = m["resilience"], m["timeouts"]
        clock = t.FakeClock()
        policy = r.RetryPolicy(max_attempts=4, base_s=0.5, cap_s=8.0, clock=clock, seed=3)
        delays = [round(d, 12) for d, _ in zip(r.RetryPolicy(seed=11).delays(), range(12))]
        calls = []

        def flaky():
            calls.append(clock.now())
            if len(calls) < 3:
                raise ConnectionError("transient")
            return "done"

        got = policy.call(flaky)
        verdicts = [policy.is_retryable(e) for e in (
            r.Retryable("x"), r.Fatal("x"), OSError("x"), ValueError("x"),
            t.BudgetExhausted("phase", 1.0))]

        def always():
            raise r.Retryable("again")

        with pytest.raises(r.RetryExhausted) as e:
            r.RetryPolicy(max_attempts=3, clock=clock, seed=3).call(always)
        with pytest.raises(r.Fatal):
            policy.call(lambda: (_ for _ in ()).throw(r.Fatal("stop")))
        budget = t.TimeoutBudget(1.0, clock=t.FakeClock())
        with pytest.raises(t.BudgetExhausted):
            r.RetryPolicy(max_attempts=50, base_s=0.5, cap_s=0.5, seed=1).call(
                always, budget=budget, phase="probe")
        out[side] = (delays, got, calls, verdicts, str(e.value), e.value.attempts)
    assert out["port"] == out["jax"]
    assert out["port"][3] == [True, False, True, False, False]


def test_retry_policy_refuses_bad_bounds():
    with pytest.raises(ValueError, match="max_attempts"):
        resilience.RetryPolicy(max_attempts=0)
    with pytest.raises(ValueError, match="base_s"):
        resilience.RetryPolicy(base_s=2.0, cap_s=1.0)


# --- the examples resume on the straight run's batches -------------------------

EXAMPLES = {
    "lenet_mnist": ["--global_batch_size", "8"],
    "llama_train": ["--size", "tiny", "--seq_len", "16", "--global_batch_size", "2"],
    "bert_pretrain": ["--tiny", "--seq_len", "16", "--global_batch_size", "4"],
    "cifar10_train": ["--model", "vgg11", "--global_batch_size", "4"],
}


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_resumed_example_trains_on_the_straight_run_s_batches(tmp_path, name):
    """Two steps, then two more from the checkpoint: the four losses are
    bitwise those of four straight steps."""
    import importlib

    main = importlib.import_module(f"deeplearning_cfn_tpu_torch.examples.{name}").main
    argv = EXAMPLES[name] + ["--device", "cpu", "--log_every", "1"]

    def losses(result):
        return [h["loss"] for h in result["history"]]

    straight = main(argv + ["--steps", "4"])
    first = main(argv + ["--steps", "2", "--checkpoint_dir", str(tmp_path)])
    second = main(argv + ["--steps", "2", "--checkpoint_dir", str(tmp_path)])
    assert (first["start_step"], second["start_step"], second["end_step"]) == (0, 2, 4)
    assert losses(first) + losses(second) == losses(straight)
