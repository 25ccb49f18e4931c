"""The port's checkpointing against the JAX package's, on the CPU.

- The envelope family (``StateCheckpointer``, ``ObjectStoreCheckpointer``,
  ``FallbackCheckpointer``): the same envelope bytes as JAX's for the same
  state, each side reading the other's files, and the behaviours of JAX's
  tests (torn writes, corrupt hashes, ``TopologyMismatch``, ``max_to_keep``,
  breakers that degrade).  The copies the port keeps (``CircuitBreaker``,
  the clocks, ``TimeoutBudget``) are driven beside the originals.
- The DCP ``Checkpointer`` (``torch.distributed.checkpoint``): bit-for-bit
  round trips of every optimizer's state and of BatchNorm's statistics; 5
  steps + save + restore in a fresh trainer + 5 equal to 10 straight steps
  bit for bit (``tests/test_checkpoint.py``'s resume), and both within
  ``tests/test_torch_trainer.py``'s tolerance of the JAX trainer's
  uninterrupted run on the same weights; a restore that moves no weight
  before the first step and keeps every tensor's address; the policies,
  ``restore_raw``, idempotent saves, ``max_to_keep``, an uncommitted step
  never seen; ``fit(checkpointer=)``; ``--checkpoint_dir`` on the three
  examples, run twice.

On the card (``cuda``-marked, skipped here): a ``multi_step_fn(2)`` graph
captured on one state, a restore into that state, a replay, bitwise equal
to eager steps from the restored state; an async save followed at once by
an in-place step on the card, the checkpoint holding the pre-step values.
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax
    import jax.numpy as jnp

    from deeplearning_cfn_tpu.models import llama as jax_llama
    from deeplearning_cfn_tpu.parallel.mesh import MeshSpec, build_mesh
    from deeplearning_cfn_tpu.provision import objectstore as jax_objectstore
    from deeplearning_cfn_tpu.train import checkpoint as jax_ckpt
    from deeplearning_cfn_tpu.train import data as jax_data
    from deeplearning_cfn_tpu.train.trainer import TrainerConfig as JaxTrainerConfig
    from deeplearning_cfn_tpu.utils import resilience as jax_resilience
    from deeplearning_cfn_tpu.utils import timeouts as jax_timeouts
except ImportError:  # the card's host: only the tests without the JAX reference run
    jax = None

from deeplearning_cfn_tpu_torch import interop  # noqa: E402
from deeplearning_cfn_tpu_torch.models import llama, resnet  # noqa: E402
from deeplearning_cfn_tpu_torch.obs import recorder  # noqa: E402
from deeplearning_cfn_tpu_torch.provision.objectstore import LocalObjectStore  # noqa: E402
from deeplearning_cfn_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from deeplearning_cfn_tpu_torch.train import data, trainer  # noqa: E402
from deeplearning_cfn_tpu_torch.utils import resilience, timeouts  # noqa: E402

torch.set_num_threads(1)

needs_jax = pytest.mark.skipif(jax is None, reason="needs JAX, the reference")

TOPO = {"devices": 8, "axes": {"dp": 2, "fsdp": 4}}
STREAM = {"seed": 3, "epoch": 1, "host": "h0", "rng_key": 12345,
          "work": [[2, 5], [0, 0]], "done": [[1, 7]], "records_epoch": 12, "records_total": 40}
STATES = {
    "ints_floats": {"step": 3, "loss": 0.5, "lr": 1e-3},
    "nested": {"a": [1, 2.5, {"b": [True, None, "x"]}], "z": {"y": {"x": -0.0}}, "k": 2**40},
    "f32": {"w": np.array([0.1, 1 / 3, -2.5e-8, 3.4e38], np.float32).tolist(),
            "s": np.float32(0.1), "t": torch.tensor(1 / 3, dtype=torch.float32).item()},
}


# --- the envelope ------------------------------------------------------------


@needs_jax
@pytest.mark.parametrize("name", list(STATES))
@pytest.mark.parametrize("extra", ["v1", "v2", "v3"])
def test_envelope_bytes_equal_jax(name, extra):
    state = STATES[name]
    kw = {"v1": {}, "v2": {"mesh_topology": TOPO},
          "v3": {"mesh_topology": TOPO, "stream_state": STREAM}}[extra]
    ours = ckpt._envelope(7, state, **kw)
    theirs = jax_ckpt._envelope(7, state, **kw)
    assert ours == theirs
    assert ckpt._open_envelope(theirs) == jax_ckpt._open_envelope(ours)
    assert ckpt._open_envelope(ours)[1:] == (7, kw.get("mesh_topology"), kw.get("stream_state"))


@needs_jax
def test_envelope_tamper_and_non_finite():
    env = json.loads(ckpt._envelope(2, {"loss": 0.5}).decode())
    env["state"]["loss"] = 0.6
    assert ckpt._open_envelope(json.dumps(env).encode()) is None
    assert ckpt._open_envelope(b"\xff not json") is None
    # json_safe maps NaN to null on both sides.
    assert ckpt._envelope(1, {"x": float("nan")}) == jax_ckpt._envelope(1, {"x": float("nan")})


@needs_jax
def test_state_checkpointer_files_exchange_with_jax(tmp_path):
    ours = ckpt.StateCheckpointer(tmp_path / "a")
    ours.save(4, {"k": [1, 2]}, mesh_topology=TOPO, stream_state=STREAM)
    theirs = jax_ckpt.StateCheckpointer(tmp_path / "a")
    assert theirs.restore_latest(expected_topology=TOPO) == ({"k": [1, 2]}, 4)
    assert theirs.last_stream_state == STREAM
    theirs.save(6, {"k": [3]}, mesh_topology=TOPO)
    fresh = ckpt.StateCheckpointer(tmp_path / "a")
    assert fresh.restore_latest(expected_topology=TOPO) == ({"k": [3]}, 6)
    assert fresh.last_stream_state is None
    assert sorted(p.name for p in (tmp_path / "a").iterdir()) == [
        "state-00000004.json", "state-00000006.json"]


class TornIO(ckpt.CheckpointIO):
    """Writes half the bytes, then raises: a writer dying mid-write."""

    def __init__(self):
        self.armed = False

    def write_bytes(self, path, data):
        if self.armed:
            Path(path).write_bytes(data[: len(data) // 2])
            raise OSError("torn write")
        super().write_bytes(path, data)


def test_torn_write_leaves_previous_restorable(tmp_path):
    io = TornIO()
    ck = ckpt.StateCheckpointer(tmp_path, io=io)
    ck.save(1, {"w": 1})
    io.armed = True
    with pytest.raises(OSError, match="torn"):
        ck.save(2, {"w": 2})
    assert ck.steps() == [1]
    assert [p.name for p in tmp_path.iterdir()] == ["state-00000001.json"]  # no temp litter
    assert ck.restore_latest() == ({"w": 1}, 1)


def test_corrupt_sha_is_skipped(tmp_path):
    ck = ckpt.StateCheckpointer(tmp_path)
    ck.save(1, {"w": 1})
    ck.save(2, {"w": 2})
    f = tmp_path / "state-00000002.json"
    env = json.loads(f.read_text())
    env["state"]["w"] = 3
    f.write_text(json.dumps(env))
    assert ck.restore_latest() == ({"w": 1}, 1)


def test_topology_mismatch_raises(tmp_path):
    ck = ckpt.StateCheckpointer(tmp_path)
    ck.save(1, {"w": 1}, mesh_topology=TOPO)
    with pytest.raises(ckpt.TopologyMismatch) as err:
        ck.restore_latest(expected_topology={"devices": 4, "axes": {"fsdp": 4}})
    assert err.value.step == 1 and err.value.found == TOPO
    assert ck.restore_latest(expected_topology=dict(reversed(list(TOPO.items())))) == ({"w": 1}, 1)


def test_max_to_keep_holds(tmp_path):
    ck = ckpt.StateCheckpointer(tmp_path, max_to_keep=2)
    for step in range(1, 6):
        ck.save(step, {"s": step})
    assert ck.steps() == [4, 5]


@needs_jax
def test_object_store_checkpointer_exchanges_with_jax(tmp_path):
    ours = ckpt.ObjectStoreCheckpointer(LocalObjectStore(tmp_path))
    ours.save(3, {"w": [1.5]}, stream_state=STREAM)
    theirs = jax_ckpt.ObjectStoreCheckpointer(jax_objectstore.LocalObjectStore(tmp_path))
    assert theirs.restore_latest() == ({"w": [1.5]}, 3)
    assert theirs.last_stream_state == STREAM
    theirs.save(5, {"w": [2.5]})
    assert ours.steps() == [3, 5] and ours.restore_latest() == ({"w": [2.5]}, 5)
    store = LocalObjectStore(tmp_path)
    assert store.list("checkpoints") == ["checkpoints/state-00000003.json",
                                         "checkpoints/state-00000005.json"]
    with pytest.raises(ValueError, match="escapes"):
        store.put("../outside", b"x")


class FailingTier:
    accepts_stream_state = True

    def __init__(self):
        self.calls = 0

    def save(self, step, state, **kwargs):
        self.calls += 1
        raise OSError("disk gone")

    def restore_latest(self):
        raise OSError("disk gone")


def test_fallback_checkpointer_degrades_behind_breakers(tmp_path):
    clock = timeouts.FakeClock()
    bad, good = FailingTier(), ckpt.StateCheckpointer(tmp_path)
    journal = tmp_path / "journal.jsonl"
    recorder.configure(journal)
    try:
        chain = ckpt.FallbackCheckpointer([("local", bad), ("store", good)],
                                          failure_threshold=2, reset_after_s=10.0, clock=clock)
        for step in (1, 2, 3):
            assert chain.save(step, {"s": step}, stream_state=STREAM) == "store"
        assert bad.calls == 2  # the breaker opened after two failures
        assert chain.degraded and chain.breaker("local").state == "open"
        clock.advance(10.0)
        assert chain.breaker("local").state == "half-open"
        chain.save(4, {"s": 4})
        assert bad.calls == 3 and chain.breaker("local").state == "open"  # the probe failed
        assert chain.restore_latest() == ({"s": 4}, 4)
        assert chain.last_save_tier == "store"
        kinds = [json.loads(line)["kind"] for line in journal.read_text().splitlines()]
        assert "degraded" in kinds and "checkpoint_fallback" in kinds
    finally:
        recorder.configure(None)
    with pytest.raises(ckpt.CheckpointWriteError):
        ckpt.FallbackCheckpointer([("local", FailingTier())]).save(1, {})


# --- the copies ----------------------------------------------------------------

BREAKER_SCRIPTS = {
    "trip_and_recover": "FFF a S a",
    "probe_fails": "FFF a +5 a F a +5 a S a",
    "below_threshold": "FF S F a",
    "one_probe_only": "FFF +5 a a F +1 a +4 a",
}


@needs_jax
@pytest.mark.parametrize("script", list(BREAKER_SCRIPTS))
def test_circuit_breaker_copy_matches_the_original(script):
    def drive(mod, clock_mod):
        clock = clock_mod.FakeClock()
        b = mod.CircuitBreaker(name="t", failure_threshold=3, reset_after_s=5.0, clock=clock)
        seen = []
        for op in BREAKER_SCRIPTS[script].split():
            if op.startswith("+"):
                clock.advance(float(op[1:]))
            elif op == "a":
                seen.append(b.allow())
            else:
                for c in op:
                    b.record_failure() if c == "F" else b.record_success()
            seen.append((b.state, b.consecutive_failures))
        return seen

    assert drive(resilience, timeouts) == drive(jax_resilience, jax_timeouts)


def test_circuit_breaker_call_and_validation():
    b = resilience.CircuitBreaker(failure_threshold=1, clock=timeouts.FakeClock())
    with pytest.raises(ZeroDivisionError):
        b.call(lambda: 1 / 0)
    with pytest.raises(resilience.CircuitOpen):
        b.call(lambda: 1)
    with pytest.raises(ValueError):
        resilience.CircuitBreaker(failure_threshold=0)


@needs_jax
def test_clocks_and_budget_match_the_original():
    for mod in (timeouts, jax_timeouts):
        clock = mod.FakeClock(5.0)
        budget = mod.TimeoutBudget(10.0, clock=clock)
        budget.sleep(4.0, "a")
        clock.advance(3.0)
        assert (clock.now(), budget.elapsed_s, budget.remaining_s) == (12.0, 7.0, 3.0)
        with pytest.raises(mod.BudgetExhausted, match="phase 'b'"):
            budget.sleep(9.0, "b")
    assert isinstance(timeouts.MonotonicClock().now(), float)


# --- the DCP Checkpointer ----------------------------------------------------

SEQ, VOCAB, BATCH = 16, 64, 4
OPTIMIZERS = ["adamw", "lamb", "adafactor", "sgd", "momentum"]


def _llama_trainer(optimizer="adamw", **kw):
    cfg = llama.LlamaConfig.tiny(vocab_size=VOCAB, seq_len=SEQ, dtype=torch.float32)
    lr = 1e-2 if optimizer in ("adafactor", "sgd", "momentum") else 1e-3
    return llama.make_trainer(cfg, trainer.TrainerConfig(
        optimizer=optimizer, learning_rate=lr, weight_decay=0.1, grad_clip_norm=1.0,
        log_every=1, strategy="fsdp", **kw), device="cpu")


def _batches(n):
    return list(data.SyntheticTokenDataset(seq_len=SEQ, vocab_size=VOCAB,
                                           batch_size=BATCH).batches(n))


def _flat(state):
    """Every tensor of a TrainState's state dict, by path."""
    out = {}

    def walk(prefix, t):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(f"{prefix}.{k}" if prefix else str(k), v)
        elif isinstance(t, torch.Tensor):
            out[prefix] = t.detach().clone()

    walk("", state.state_dict())
    return out


def _assert_bitwise(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_round_trip_is_bitwise_for_every_optimizer(tmp_path, optimizer):
    t = _llama_trainer(optimizer)
    state, _ = t.fit(t.init(seed=0), iter(_batches(3)), steps=3, prefetch=0)
    want = _flat(state)
    ck = ckpt.Checkpointer(tmp_path, interval_s=None, async_save=False)
    ck.save(state.step, state)
    fresh = _llama_trainer(optimizer).init(seed=1)
    restored, step = ckpt.Checkpointer(tmp_path, interval_s=None).restore_latest(fresh)
    assert restored is fresh and step == 3 and fresh.step == 3
    _assert_bitwise(_flat(fresh), want)
    if optimizer != "sgd":  # stateless: no optimizer entry
        assert any(k.startswith("optimizer.state.layers.0.wq.") for k in want)


def test_round_trip_keeps_batchnorm_statistics_in_f32(tmp_path):
    arch = dict(stage_sizes=(1, 1), num_classes=10, dtype=torch.bfloat16)

    def make():
        return trainer.Trainer(lambda gen: resnet.ResNet(**arch, generator=gen),
                               trainer.TrainerConfig(has_train_arg=True, learning_rate=0.1,
                                                     weight_decay=1e-4),
                               device="cpu")

    ds = data.SyntheticDataset(shape=(16, 16, 3), num_classes=10, batch_size=4)
    t = make()
    state, _ = t.fit(t.init(seed=0), ds.batches(2), steps=2, prefetch=0)
    want = _flat(state)
    buffers = [k for k in want if k.startswith("model.") and k.endswith((".mean", ".var"))]
    assert buffers and all(want[k].dtype == torch.float32 for k in buffers)
    assert any("momentum_buffer" in k for k in want)
    ckpt.Checkpointer(tmp_path, interval_s=None, async_save=False).save(state.step, state)
    fresh = make().init(seed=1)
    ckpt.Checkpointer(tmp_path).restore_latest(fresh)
    _assert_bitwise(_flat(fresh), want)


def _jax_uninterrupted(steps, batches):
    """The JAX trainer's straight run from its own initial weights: the
    initial and final parameters (numpy) and the losses."""
    jcfg = jax_llama.LlamaConfig.tiny(vocab_size=VOCAB, seq_len=SEQ, dtype=jnp.float32)
    mesh = build_mesh(MeshSpec(), jax.devices()[:1])
    jt = jax_llama.make_trainer(jcfg, mesh, JaxTrainerConfig(
        optimizer="adamw", learning_rate=1e-3, weight_decay=0.1, grad_clip_norm=1.0,
        log_every=1, strategy="fsdp"))
    jstate = jt.init(jax.random.key(0), jnp.asarray(batches[0].x))
    init = jax.device_get(jstate.params)
    jstate, losses = jt.fit(jstate, iter(batches), steps=steps, prefetch=0)
    return init, jax.device_get(jstate.params), losses


@needs_jax
@pytest.mark.parametrize("async_save", [False, True])
def test_resume_equals_the_straight_run_and_jax(tmp_path, async_save):
    steps = 10
    jbatches = list(jax_data.SyntheticTokenDataset(seq_len=SEQ, vocab_size=VOCAB,
                                                   batch_size=BATCH).batches(steps))
    init, jfinal, jlosses = _jax_uninterrupted(steps, jbatches)
    cfg = llama.LlamaConfig.tiny(vocab_size=VOCAB, seq_len=SEQ, dtype=torch.float32)
    weights = interop.llama_params_from_jax(cfg, init)
    batches = _batches(steps)

    def start(seed):
        t = _llama_trainer()
        s = t.init(seed=seed)
        s.model.load_state_dict(weights)
        return t, s

    ta, sa = start(0)
    sa, straight = ta.fit(sa, iter(batches), steps=steps, prefetch=0)
    tb, sb = start(0)
    sb, first = tb.fit(sb, iter(batches[:5]), steps=5, prefetch=0)
    ck = ckpt.Checkpointer(tmp_path, interval_s=None, async_save=async_save)
    ck.save(sb.step, sb)
    ck.close()
    tc = _llama_trainer()
    sc = tc.init(seed=1)  # another start: the restore must replace it all
    _, step = ckpt.Checkpointer(tmp_path, interval_s=None).restore_latest(sc)
    assert step == 5
    sc, rest = tc.fit(sc, iter(batches[5:]), steps=5, prefetch=0)
    assert first + rest == straight  # bitwise
    _assert_bitwise(_flat(sc), _flat(sa))
    # Within tests/test_torch_trainer.py's tolerance of JAX's straight run.
    np.testing.assert_allclose(straight, jlosses, rtol=1e-5)
    final = interop.llama_params_from_jax(cfg, jfinal)
    for name, p in sc.model.state_dict().items():
        diff = np.abs(p.numpy() - final[name].numpy())
        assert diff.max() <= 1e-3 * steps, name
        assert np.mean(diff > 2e-6) <= 1e-3, (name, diff.max())


@pytest.mark.parametrize("optimizer", OPTIMIZERS)
def test_restore_moves_no_weight_before_the_first_step(tmp_path, optimizer):
    t = _llama_trainer(optimizer)
    state, _ = t.fit(t.init(seed=0), iter(_batches(2)), steps=2, prefetch=0)
    ckpt.Checkpointer(tmp_path, async_save=False).save(state.step, state)
    saved = {n: p.detach().clone() for n, p in state.model.named_parameters()}
    fresh = _llama_trainer(optimizer).init(seed=1)
    ckpt.Checkpointer(tmp_path).restore_latest(fresh)
    for n, p in fresh.model.named_parameters():
        assert torch.equal(p, saved[n]), n


def test_dcp_zero_step_init_would_move_adafactor_weights():
    """Why ``init_optimizer_state`` exists: DCP's own initialiser (a step at
    learning rate 0 on zero gradients) moves an Adafactor model, whose decay
    is not scaled by the learning rate."""
    from torch.distributed.checkpoint.state_dict import _init_optim_state

    state = _llama_trainer("adafactor").init(seed=0)
    before = state.model.embed.detach().clone()
    _init_optim_state(state.optimizer)
    assert not torch.equal(state.model.embed, before)


def test_restore_keeps_every_tensor_in_place(tmp_path):
    """A CUDA graph captured before a restore reads and writes the same
    addresses after it (``CapturedSteps``): nothing may be replaced."""
    t = _llama_trainer()
    state, _ = t.fit(t.init(seed=0), iter(_batches(2)), steps=2, prefetch=0)
    ckpt.Checkpointer(tmp_path, async_save=False).save(state.step, state)
    fresh = _llama_trainer().init(seed=1)
    fresh.state_dict()  # the optimizer state exists from here on
    live = lambda s: [x.data_ptr() for x in trainer.CapturedSteps._state_tensors(None, s)]  # noqa: E731
    before = live(fresh)
    ckpt.Checkpointer(tmp_path).restore_latest(fresh)
    assert live(fresh) == before
    _assert_bitwise(_flat(fresh), _flat(state))


def test_empty_directory_policies_and_idempotent_save(tmp_path):
    ck = ckpt.Checkpointer(tmp_path / "c", interval_s=None, every_steps=10, async_save=False)
    assert ck.latest_step() is None and ck.restore_latest({}) is None and ck.restore_raw() is None
    assert not ck.should_save(5) and ck.should_save(10) and not ck.should_save(0)
    assert ckpt.Checkpointer(tmp_path / "q", interval_s=0.0).should_save(1)
    state = {"w": torch.ones(2)}
    ck.save(3, state)
    ck.save(3, {"w": torch.zeros(2)})  # must not raise, must not overwrite
    target = {"w": torch.empty(2)}
    assert ck.restore_latest(target)[1] == 3 and torch.equal(target["w"], torch.ones(2))


def test_restore_raw_and_load_state_dict(tmp_path):
    t = _llama_trainer("adamw")
    state, _ = t.fit(t.init(seed=0), iter(_batches(2)), steps=2, prefetch=0)
    ck = ckpt.Checkpointer(tmp_path, async_save=True)
    ck.save(state.step, state)
    ck.wait()
    raw, step = ck.restore_raw()
    assert step == 2 and set(raw) == {"model", "optimizer", "step"}
    assert torch.equal(raw["model"]["layers.1.wq"], state.model.layers[1].wq)
    fresh = _llama_trainer("adamw").init(seed=3)
    fresh.load_state_dict(raw)
    _assert_bitwise(_flat(fresh), _flat(state))


def test_max_to_keep_and_uncommitted_steps_are_invisible(tmp_path):
    ck = ckpt.Checkpointer(tmp_path, interval_s=None, max_to_keep=2, async_save=True)
    for step in range(1, 5):
        ck.save(step, {"w": torch.full((3,), float(step))})
    ck.wait()
    assert ck.all_steps() == [3, 4]
    torn = tmp_path / ".step-00000009.tmp"  # a writer that died before its rename
    torn.mkdir()
    (torn / "__0_0.distcp").write_bytes(b"partial")
    (tmp_path / "step-00000010").mkdir()  # no metadata: not committed either
    assert ck.latest_step() == 4
    target = {"w": torch.zeros(3)}
    assert ck.restore_latest(target)[1] == 4 and torch.equal(target["w"], torch.full((3,), 4.0))


def test_fit_saves_on_the_policy_at_the_true_step(tmp_path):
    batches = _batches(6)
    t = _llama_trainer()
    ck = ckpt.Checkpointer(tmp_path, interval_s=None, every_steps=2, max_to_keep=5)
    state, _ = t.fit(t.init(seed=0), iter(batches[:4]), steps=4, prefetch=0, checkpointer=ck)
    ck.wait()
    assert ck.all_steps() == [2, 4]
    t2 = _llama_trainer()
    fresh, _ = ck.restore_latest(t2.init(seed=1))
    t2.fit(fresh, iter(batches[4:]), steps=2, prefetch=0, checkpointer=ck)
    ck.close()
    assert ck.all_steps() == [2, 4, 6] and fresh.step == 6


def test_fit_still_refuses_reshard_and_profiler():
    """The live reshard is ported (``tests/test_torch_reshard.py``): what
    ``fit`` still refuses is ``reshard=`` with a captured multi-step call,
    and a coordinator with no loss armed leaves a checkpointed fit as it
    was.  The profiler is ported (``tests/test_torch_profiler.py``) and
    profiles a checkpointed fit."""
    from deeplearning_cfn_tpu_torch.cluster.contract import ClusterContract
    from deeplearning_cfn_tpu_torch.cluster.recovery import LiveReshardManager
    from deeplearning_cfn_tpu_torch.obs.profiler import StepProfiler
    from deeplearning_cfn_tpu_torch.train.reshard import LiveReshardCoordinator

    t = _llama_trainer()
    contract = ClusterContract.build(cluster_name="c", coordinator_ip="10.0.0.1",
                                     other_worker_ips=["10.0.0.2"], chips_per_worker=1,
                                     storage_mount="/mnt/none",
                                     slices={"s0": ["10.0.0.1"], "s1": ["10.0.0.2"]})
    coordinator = LiveReshardCoordinator(manager=LiveReshardManager(contract),
                                         mesh_for=lambda c: None)
    with pytest.raises(ValueError, match="steps_per_call"):
        t.fit(t.init(seed=0), iter(_batches(2)), steps=2, steps_per_call=2,
              reshard=coordinator)
    _, plain = t.fit(t.init(seed=0), iter(_batches(2)), steps=2)
    _, paused = t.fit(t.init(seed=0), iter(_batches(2)), steps=2, reshard=coordinator)
    assert paused == plain and not coordinator.records
    prof = StepProfiler(name="fit")
    t.fit(t.init(seed=0), iter(_batches(1)), steps=1, profiler=prof)
    assert prof.snapshot()["steps"] == 1


# --- the examples' --checkpoint_dir ----------------------------------------

EXAMPLES = {
    "llama_train": ["--size", "tiny", "--seq_len", "16", "--global_batch_size", "2"],
    "bert_pretrain": ["--tiny", "--seq_len", "16", "--global_batch_size", "4"],
    "resnet_imagenet": ["--depth", "50", "--image_size", "32", "--global_batch_size", "2",
                        "--use_pallas_head"],
}


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_example_checkpoint_dir_resumes(tmp_path, name):
    import importlib

    main = importlib.import_module(f"deeplearning_cfn_tpu_torch.examples.{name}").main
    argv = EXAMPLES[name] + ["--device", "cpu", "--steps", "2", "--log_every", "1",
                             "--checkpoint_dir", str(tmp_path)]
    first = main(argv)
    assert first["start_step"] == 0 and first["steps"] == 2
    assert ckpt.Checkpointer(tmp_path).all_steps() == [2]
    second = main(argv)
    assert second["start_step"] == 2 and second["end_step"] == 4
    assert ckpt.Checkpointer(tmp_path).all_steps() == [2, 4]
    assert np.isfinite(second["final_loss"])


# --- on the card ---------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _card_resnet(device):
    """A four-stage ResNet with ResNet-50's head (the f32 fused dense) on
    32x32 uint8 images, Nesterov momentum; cuDNN deterministic."""
    arch = dict(stage_sizes=(1, 1, 1, 1), num_classes=1000, dtype=torch.bfloat16,
                use_pallas_head=True)
    ds = data.SyntheticDataset(shape=(32, 32, 3), num_classes=1000, batch_size=128,
                               dtype="uint8", pool_batches=4)
    cfg = trainer.TrainerConfig(learning_rate=0.1, has_train_arg=True, label_smoothing=0.1,
                                input_stats=ds.input_stats)
    return trainer.Trainer(lambda g: resnet.ResNet(**arch, generator=g), cfg, device=device), ds


@pytest.mark.cuda
def test_replay_after_a_restore_equals_eager_steps_on_card(cuda_device, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    t, ds = _card_resnet(cuda_device)
    stacks = [data.device_put_batch(s, cuda_device) for s in data.stack_batches(ds.batches(4), 2)]
    saved, _ = t.fit(t.init(seed=0), ds.batches(2), steps=2, prefetch=0)
    ckpt.Checkpointer(tmp_path, async_save=False).save(saved.step, saved)
    want = _flat(saved)
    state = t.init(seed=3)
    kfn = t.multi_step_fn(2)
    state, _ = kfn(state, *stacks[0])  # captured on the seed-3 state
    ckpt.Checkpointer(tmp_path).restore_latest(state)
    _assert_bitwise(_flat(state), want)
    state, replayed = kfn(state, *stacks[1])
    assert kfn.captures == 1 and state.step == 4
    eager = t.init(seed=4)
    ckpt.Checkpointer(tmp_path).restore_latest(eager)
    losses = []
    for i in range(2):
        eager, m = t.train_step(eager, stacks[1][0][i], stacks[1][1][i])
        losses.append(m["loss"])
    assert torch.equal(replayed, torch.stack(losses))
    _assert_bitwise(_flat(state), _flat(eager))


@pytest.mark.cuda
def test_async_save_overlapping_the_next_step_on_card(cuda_device, tmp_path):
    t, ds = _card_resnet(cuda_device)
    x, y = data.device_put_batch(next(iter(ds.batches(1))), cuda_device)
    state, _ = t.train_step(t.init(seed=0), x, y)
    before = _flat(state)
    ck = ckpt.Checkpointer(tmp_path, async_save=True)
    ck.save(state.step, state)
    state, _ = t.train_step(state, x, y)  # in place, on the stream that waits for the staging
    ck.wait()
    assert ck.last_save["staging_ms"] is not None
    raw, step = ck.restore_raw()
    assert step == 1
    assert torch.equal(raw["model"]["head.kernel"], before["model.head.kernel"].cpu())
    assert not torch.equal(state.model.head.kernel.cpu(), raw["model"]["head.kernel"])
    fresh = t.init(seed=1)
    ckpt.Checkpointer(tmp_path).restore_latest(fresh)
    _assert_bitwise(_flat(fresh), before)
