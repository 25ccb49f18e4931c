"""The port's live elastic reshard against the JAX package's, on the CPU.

Four gloo ranks (``tests/torch_dist_ranks.py``, one spawn for every case)
run a small MLP — JAX ``test_reshard.py``'s ``_MLP`` in ``nn.Linear``
layers, its initial weights carried from JAX through
``interop.dense_params_from_jax`` — with the port's cluster plane:

- **golden**: fsdp 4 -> 2 after two steps; the migrated parameters and
  optimizer state equal a fresh shard (``distribute_tensor``) of the state
  gathered before, byte for byte, with genuinely sharded leaves, for AdamW,
  LAMB and Adafactor (its factored ``v_row``/``v_col``);
- **live**: ``fit(reshard=)`` on 2 slices x fsdp 2 losing slice ``s1`` at
  the boundary before batch 2 -> 1 slice x fsdp 2 with accumulation 2,
  against JAX's ``fit`` with its live reshard on 8 virtual devices (2
  slices x fsdp 4 -> fsdp 4), the same weights and batches: every loss within
  ``RTOL``/``ATOL`` (f32: the two sides sum the same terms in another order
  and layout); every step checkpointed, the survivors' saves after the pause
  over their own group, the last restoring bitwise onto their mesh;
- **live0**: the terminate burst published on rank 0 only; every rank
  pauses at the same boundary, and ``on_commit=plane.reshard`` re-partitions
  a data stream over the survivors as JAX's plane does;
- **fallback**: ``force_fallback``: ``fit`` stops with the pre-pause losses,
  ``reshard_fallback`` journaled once, and the survivors' DCP restore onto
  their mesh with accumulation 2 lines up with the straight run within the
  JAX scenario's tolerance;
- **leaf**: the survivors' model on the new mesh has a leaf the old state
  lacks: ``reshard_fallback``, the trainer back on its old mesh.

In process (no spawn): ``ensure_hostable`` refuses where JAX's does; which
optimizer states migrate live and which take the fallback; a grow with no
process group takes the fallback (the spawn's ``regrow`` cases: a parked
slice comes back live, one whose ranks left takes the fallback);
``steps_per_call`` refused; a loss of the coordinator's slice raises.  The ``slice-loss-live`` chaos scenario (its own four-rank spawn)
holds its invariants on three seeds, its fault schedule JAX's, its report
byte-identical run over run.  A ``cuda`` test runs a two-rank live reshard
on the card.
"""

import itertools
import json
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import flax.linen as nn
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from deeplearning_cfn_tpu.analysis.schedules import VirtualClock as JVirtualClock
    from deeplearning_cfn_tpu.cluster import contract as jcontract
    from deeplearning_cfn_tpu.cluster.elasticity import ElasticityController, GroupPolicy
    from deeplearning_cfn_tpu.cluster.recovery import LiveReshardManager as JManager
    from deeplearning_cfn_tpu.parallel import mesh as jmesh
    from deeplearning_cfn_tpu.provision import events as jevents
    from deeplearning_cfn_tpu.train import datastream as jds
    from deeplearning_cfn_tpu.train import records as jrecords
    from deeplearning_cfn_tpu.train import reshard as jreshard
    from deeplearning_cfn_tpu.train.data import Batch as JBatch
    from deeplearning_cfn_tpu.train.trainer import Trainer as JTrainer
    from deeplearning_cfn_tpu.train.trainer import TrainerConfig as JConfig
except ImportError:  # the card's host: only the tests without the JAX reference run
    jax = None

from deeplearning_cfn_tpu_torch.analysis.schedules import VirtualClock  # noqa: E402
from deeplearning_cfn_tpu_torch.cluster.contract import ClusterContract  # noqa: E402
from deeplearning_cfn_tpu_torch.cluster.recovery import LiveReshardManager  # noqa: E402
from deeplearning_cfn_tpu_torch.obs.recorder import get_recorder  # noqa: E402
from deeplearning_cfn_tpu_torch.parallel.mesh import MeshSpec  # noqa: E402
from deeplearning_cfn_tpu_torch.train import reshard  # noqa: E402
from deeplearning_cfn_tpu_torch.train import trainer as trainer_lib  # noqa: E402
from deeplearning_cfn_tpu_torch.train.data import Batch  # noqa: E402

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tests"))
from torch_dist_ranks import MLP  # noqa: E402

needs_jax = pytest.mark.skipif(jax is None, reason="needs JAX, the reference")

# f32 losses of the same model on the same global batches, summed in another
# order (4 port ranks against 8 JAX devices, other microbatch splits).
RTOL, ATOL = 1e-5, 1e-6
# The JAX slice-loss-live scenario's continuity tolerance (chaos/scenarios.py).
SCENARIO_RTOL, SCENARIO_ATOL = 5e-3, 1e-4
STEPS, DIE_AT, GROW_AT, JOIN_TIMEOUT = 6, 2, 4, 300
BURST = ["10.0.0.3", "10.0.0.4", "10.0.0.3"]  # a duplicate in it, as JAX's


def _batches_np():
    rng = np.random.default_rng(1)
    return [(rng.normal(size=(32, 8, 8, 1)).astype(np.float32),
             rng.integers(0, 10, size=(32,)).astype(np.int64)) for _ in range(STEPS)]


# --- the JAX reference ---------------------------------------------------------


if jax is not None:
    class _MLP(nn.Module):
        @nn.compact
        def __call__(self, x):
            x = x.reshape((x.shape[0], -1))
            x = nn.relu(nn.Dense(256, name="fc1")(x))
            x = nn.relu(nn.Dense(256, name="fc2")(x))
            return nn.Dense(10, name="head")(x)


def _jax_contract():
    return jcontract.ClusterContract.build(
        cluster_name="live", coordinator_ip="10.0.0.1",
        other_worker_ips=["10.0.0.2", "10.0.0.3", "10.0.0.4"], chips_per_worker=2,
        storage_mount="/mnt/none",
        slices={"s0": ["10.0.0.1", "10.0.0.2"], "s1": ["10.0.0.3", "10.0.0.4"]})


def _jax_mesh_for(contract):
    n = contract.slices_count
    return jmesh.hybrid_mesh_for_slices(
        n, ici_spec=jmesh.MeshSpec.fsdp_parallel(contract.total_chips // n), dcn_axis="dp",
        devices=jmesh.virtual_cpu_devices(8)[: contract.total_chips])


def _jax_run(live: bool) -> dict:
    """JAX ``fit`` on the slice-loss-live layout, with the burst published
    while batch DIE_AT is made (``live``) or straight."""
    class Backend:
        def __init__(self):
            self.events = jevents.EventBus()

    vclock = JVirtualClock()
    controller = ElasticityController(backend=Backend(), coordinator_queue_name="coord",
                                      slice_loss_window_s=10.0, clock=vclock)
    controller.register(GroupPolicy("s0", 1, "sig-s0", coordinator=True))
    controller.register(GroupPolicy("s1", 1, "sig-s1"))
    controller.attach()
    manager = JManager(_jax_contract())
    manager.attach(controller)
    coordinator = jreshard.LiveReshardCoordinator(
        manager=manager, mesh_for=_jax_mesh_for, flush=controller.flush_slice_losses,
        clock=vclock)
    trainer = JTrainer(_MLP(), _jax_mesh_for(manager.contract), JConfig(
        optimizer="adamw", learning_rate=1e-3, strategy="fsdp", matmul_precision="float32",
        log_every=1))
    state = trainer.init(jax.random.PRNGKey(0), np.zeros((8, 8, 8, 1), np.float32))
    init = jax.tree_util.tree_map(np.asarray, jax.device_get(state.params))

    def batches():
        for i, (x, y) in enumerate(_batches_np()):
            if live and i == DIE_AT:
                for ip in BURST:
                    controller.backend.events.publish(jevents.LifecycleEvent(
                        kind=jevents.EventKind.INSTANCE_TERMINATE, group="s1", instance_id=ip,
                        detail={"reason": "preempted"}))
                    vclock.advance(0.5)
                vclock.advance(11.0)
            yield JBatch(x=x, y=y)

    state, losses = trainer.fit(state, batches(), steps=STEPS, prefetch=0,
                                reshard=coordinator if live else None)
    return {"init": init, "losses": losses, "live_total": coordinator.live_total,
            "grad_accum": trainer.config.grad_accum_steps,
            "topology": jreshard.mesh_topology(trainer.mesh)}


def _jax_plane_states(paths, seed):
    """JAX's data plane over the same four hosts: DIE_AT batches from each,
    then the reshard onto the survivors of slice s1."""
    spec = jrecords.RecordSpec((jrecords.Field("x", "uint8", (2,)),
                                jrecords.Field("y", "int32", ())))
    c = jcontract.ClusterContract.build(
        cluster_name="live", coordinator_ip="10.0.0.1",
        other_worker_ips=["10.0.0.2", "10.0.0.3", "10.0.0.4"], chips_per_worker=1,
        storage_mount="/mnt/none",
        slices={"s0": ["10.0.0.1", "10.0.0.2"], "s1": ["10.0.0.3", "10.0.0.4"]})
    plane = jds.DataStreamPlane(c, paths, spec, batch_size=2, seed=seed)
    for _ in range(DIE_AT):
        for host in plane.hosts:
            next(plane.stream(host).batches(1))
    plane.reshard(c.surviving({"s1"}))
    return plane.states()


# --- the spawn -------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(n: int, path: Path) -> list[dict]:
    """``torch_dist_ranks.py`` on ``path`` as ``n`` gloo processes; each
    rank's results.  A rank that fails or outlives the join timeout fails
    the test."""
    port = _free_port()
    procs = []
    for i in range(n):
        env = dict(os.environ, DEEPLEARNING_WORKERS_COUNT=str(n), DLCFN_PROCESS_ID=str(i),
                   DEEPLEARNING_COORDINATOR=f"127.0.0.1:{port}", OMP_NUM_THREADS="1",
                   PYTHONPATH=str(REPO))
        procs.append(subprocess.Popen([sys.executable, str(REPO / "tests" / "torch_dist_ranks.py"),
                                       str(path)], env=env, cwd=REPO, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    try:
        for p in procs:
            _, err = p.communicate(timeout=JOIN_TIMEOUT)
            assert p.returncode == 0, f"rank failed:\n{err[-3000:]}"
    except subprocess.TimeoutExpired:
        pytest.fail(f"ranks did not finish within {JOIN_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [pickle.loads(Path(f"{path}.rank{i}").read_bytes()) for i in range(n)]


def _record_shards(tmp_path, sizes=(9, 7, 8, 6, 5)):
    from deeplearning_cfn_tpu_torch.train import records

    spec = records.RecordSpec((records.Field("x", "uint8", (2,)),
                               records.Field("y", "int32", ())))
    paths, gid = [], 0
    for sid, n in enumerate(sizes):
        recs = []
        for _ in range(n):
            recs.append(spec.encode(x=np.full((2,), gid % 256, np.uint8), y=np.int32(gid)))
            gid += 1
        path = tmp_path / f"shard-{sid:02d}.dlc"
        records.write_records(path, spec, recs)
        paths.append(path)
    return paths


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX references and the four ranks' results of every case."""
    if jax is None:
        pytest.skip("needs JAX, the reference")
    tmp = tmp_path_factory.mktemp("reshard")
    live, straight = _jax_run(True), _jax_run(False)
    shards = _record_shards(tmp)
    base = dict(init=live["init"], batches=_batches_np(), die_at=DIE_AT, burst=BURST)
    cases = {
        "golden": {**base, "reshard": "golden"},
        "golden_lamb": {**base, "reshard": "golden", "optimizer": "lamb"},
        "golden_adafactor": {**base, "reshard": "golden", "optimizer": "adafactor"},
        "straight": {**base, "reshard": "straight"},
        "live": {**base, "reshard": "live", "events_on": [0, 1, 2, 3],
                 "dir": str(tmp / "ckpt_live")},
        "live0": {**base, "reshard": "live", "events_on": [0], "records": shards, "seed": 3},
        "fallback": {**base, "reshard": "fallback", "events_on": [0, 1, 2, 3],
                     "dir": str(tmp / "ckpt")},
        "leaf": {**base, "reshard": "live", "events_on": [0], "plant_leaf": True},
        "regrow": {**base, "regrow": True, "rejoin": True, "grow_at": GROW_AT},
        "regrow_absent": {**base, "regrow": True, "rejoin": False, "grow_at": GROW_AT},
    }
    path = tmp / "cases.pkl"
    path.write_bytes(pickle.dumps(cases))
    ranks = _spawn(4, path)
    return {"jax_live": live, "jax_straight": straight, "ranks": ranks,
            "jax_plane": _jax_plane_states(shards, 3)}


def _close(a, b, rtol, atol) -> bool:
    return len(a) == len(b) and bool(np.allclose(a, b, rtol=rtol, atol=atol))


# --- golden ---------------------------------------------------------------------


@pytest.mark.parametrize("case,moments", [("golden", {"exp_avg", "exp_avg_sq", "step"}),
                                          ("golden_lamb", {"mu", "nu", "step"}),
                                          ("golden_adafactor", {"v", "v_row", "v_col", "step"})])
def test_golden_migration_is_bitwise_a_fresh_shard(runs, case, moments):
    survivors, leavers = runs["ranks"][:2], runs["ranks"][2:]
    assert all(r[case]["left"] for r in leavers)
    for r in survivors:
        out = r[case]
        assert not out["left"]
        assert out["equal"] and all(out["equal"].values()), [
            k for k, ok in out["equal"].items() if not ok]
        assert set(out["opt_keys"]) == moments
        params = [k for k in out["sharded"] if k.startswith("model.")]
        opt = [k for k in out["sharded"] if k.startswith("optimizer.")]
        assert len(params) >= 2 and len(opt) >= 2, out["sharded"]
        assert out["topology"] == {"devices": 2, "axes": {"fsdp": 2}}


# --- fit(reshard=) ------------------------------------------------------------------


@needs_jax
def test_fit_live_reshard_holds_the_jax_losses(runs):
    ref = runs["jax_live"]
    assert ref["live_total"] == 1 and ref["grad_accum"] == 2
    for rank, r in enumerate(runs["ranks"]):
        out = r["live"]
        if rank < 2:
            assert _close(out["losses"], ref["losses"], RTOL, ATOL), (out["losses"],
                                                                      ref["losses"])
            assert out["step"] == STEPS and out["live_total"] == 1
            assert out["fallback_total"] == 0 and out["grad_accum"] == 2
            assert out["topology"] == {"devices": 2, "axes": {"fsdp": 2}}
            assert out["data"] == (rank, 2)
            assert out["journal"] == {"reshard": 1, "reshard_fallback": 0,
                                      "grad_accum_rescaled": 1, "slice_loss_coalesced": 1}
        else:
            assert out["left"] and out["losses"] == runs["ranks"][0]["live"]["losses"][:DIE_AT]
            assert out["live_total"] == 0 and out["journal"]["reshard"] == 0
        assert out["slices"] == 1 and out["degraded"]
    assert _close(runs["ranks"][0]["straight"]["losses"], runs["jax_straight"]["losses"],
                  RTOL, ATOL)


def test_live_run_is_bitwise_the_straight_run_before_the_pause(runs):
    for r in runs["ranks"]:
        assert r["live"]["losses"][:DIE_AT] == r["straight"]["losses"][:DIE_AT]
        assert r["live"]["paused_at"] == [DIE_AT]


def test_forced_fallback_stops_then_restores_on_the_survivors(runs):
    straight = runs["jax_straight"]["losses"]
    port_straight = runs["ranks"][0]["straight"]["losses"]
    for rank, r in enumerate(runs["ranks"]):
        out = r["fallback"]
        assert out["losses"] == port_straight[:DIE_AT] and out["step"] == DIE_AT
        if rank >= 2:
            assert out["left"] and out["journal"]["reshard_fallback"] == 0
            continue
        assert out["fallback_total"] == 1 and out["live_total"] == 0
        assert out["journal"]["reshard_fallback"] == 1 and out["journal"]["reshard"] == 0
        assert out["restore_step"] == DIE_AT and out["final_step"] == STEPS
        assert out["restored_accum"] == 2
        assert out["restored_topology"] == {"devices": 2, "axes": {"fsdp": 2}}
        curve = out["losses"] + out["resumed_losses"]
        assert _close(curve, straight, SCENARIO_RTOL, SCENARIO_ATOL), (curve, straight)
        assert _close(curve, port_straight, SCENARIO_RTOL, SCENARIO_ATOL)


def test_checkpoints_after_the_pause_save_over_the_survivors(runs):
    """Every step checkpointed through the live reshard: the saves after
    the pause go over the survivors' group (the departed ranks are not
    waited for), and the last restores bitwise onto the survivors' mesh."""
    for r in runs["ranks"][:2]:
        out = r["live"]
        assert out["saved_steps"] == [STEPS - 2, STEPS - 1, STEPS]  # max_to_keep 3
        assert out["restored_step"] == STEPS and out["restored_bitwise"]


def test_a_leaf_mismatch_on_the_new_mesh_takes_the_fallback(runs):
    """A ``ReshardError`` from laying the state out on the new mesh (a
    leaf the old state lacks) is journaled as ``reshard_fallback`` on every
    survivor, and the trainer is back on its old mesh, not on the new one
    with the old state."""
    for rank, r in enumerate(runs["ranks"]):
        out = r["leaf"]
        assert out["paused_at"] == [DIE_AT] and out["step"] == DIE_AT
        assert out["live_total"] == 0 and out["grad_accum"] == 1
        if rank >= 2:
            assert out["left"] and out["journal"]["reshard_fallback"] == 0
            continue
        assert out["fallback_total"] == 1
        assert out["journal"]["reshard_fallback"] == 1 and out["journal"]["reshard"] == 0
        assert out["topology"] == {"devices": 4, "axes": {"dp": 2, "fsdp": 2}}
        assert out["data"] == (rank, 4)


def test_a_leaf_mismatch_takes_the_fallback_on_one_device():
    t, state = _one_device("adamw")
    make = t.model_fn
    t.model_fn = lambda g: make(g) if g is not None else _with_leaf(make(g))
    binding = dict(vars(t))
    manager = LiveReshardManager(_port_contract())
    manager.on_slice_loss("s1", [])
    coordinator = reshard.LiveReshardCoordinator(manager=manager, mesh_for=lambda c: None)
    out, action = coordinator.execute(t, state, step=state.step)
    assert action == "stop" and out is state and coordinator.fallback_total == 1
    assert "planted" in coordinator.records[-1].reason
    assert vars(t).keys() == binding.keys()
    assert all(vars(t)[k] is v for k, v in binding.items())
    x, y = (torch.from_numpy(a) for a in _batches_np()[1])
    t.train_step(state, x, y)  # the old state trains on


def _with_leaf(model):
    model.register_buffer("planted", torch.zeros(1))
    return model


def test_events_on_rank_0_alone_pause_every_rank_at_one_step(runs):
    for rank, r in enumerate(runs["ranks"]):
        out = r["live0"]
        assert out["paused_at"] == [DIE_AT], rank
        assert out["journal"]["slice_loss_coalesced"] == (1 if rank == 0 else 0)
        assert len(out["losses"]) == (STEPS if rank < 2 else DIE_AT)
        assert out["left"] == (rank >= 2)
        assert out["slices"] == 1
    assert runs["ranks"][0]["live0"]["losses"] == runs["ranks"][0]["live"]["losses"]


@needs_jax
def test_on_commit_repartitions_the_data_stream_as_jax(runs):
    ref = runs["jax_plane"]
    assert len(ref) == 2
    for r in runs["ranks"][:2]:
        assert r["live0"]["plane_states"] == ref


# --- in process -------------------------------------------------------------------

HOSTABLE = {  # name: (shape, spec, mesh sizes, raises)
    "3-ranks-256": ((256, 256), ("fsdp", None), dict(fsdp=3), True),
    "3-ranks-255": ((255, 256), ("fsdp", None), dict(fsdp=3), False),
    "4-ranks-dim1": ((10, 256), (None, "fsdp"), dict(fsdp=4), False),
    "dp-fsdp-6": ((6, 4), (("dp", "fsdp"), None), dict(dp=2, fsdp=2), True),
    "dp-fsdp-8": ((8, 4), (("dp", "fsdp"), None), dict(dp=2, fsdp=2), False),
    "past-ndim": ((8,), (None, "fsdp"), dict(fsdp=2), True),
}


@needs_jax
@pytest.mark.parametrize("name", sorted(HOSTABLE))
def test_ensure_hostable_refuses_where_jax_does(name):
    shape, spec, sizes, raises = HOSTABLE[name]
    n = int(np.prod(list(sizes.values())))
    jm = jmesh.build_mesh(jmesh.MeshSpec(**sizes), jmesh.virtual_cpu_devices(8)[:n])
    port_sh = {"w": reshard.LeafSharding(MeshSpec(**sizes).axis_sizes(), spec)}
    jax_sh = {"w": NamedSharding(jm, P(*spec))}
    state = {"w": np.zeros(shape, np.float32)}
    if raises:
        with pytest.raises(jreshard.ReshardError, match="w"):
            jreshard.ensure_hostable(state, jax_sh)
        with pytest.raises(reshard.ReshardError, match="w"):
            reshard.ensure_hostable({"w": torch.zeros(shape)}, port_sh)
    else:
        jreshard.ensure_hostable(state, jax_sh)
        reshard.ensure_hostable({"w": torch.zeros(shape)}, port_sh)


def _one_device(optimizer: str):
    torch.manual_seed(0)
    t = trainer_lib.Trainer(lambda g: MLP(g), trainer_lib.TrainerConfig(
        optimizer=optimizer, learning_rate=1e-3, strategy="fsdp", log_every=1), device="cpu")
    state = t.init(seed=0)
    x, y = (torch.from_numpy(a) for a in _batches_np()[0])
    state, _ = t.train_step(state, x, y)
    return t, state


@pytest.mark.parametrize("optimizer,keys", [
    ("adamw", {"exp_avg", "exp_avg_sq", "step"}),
    ("lamb", {"mu", "nu", "step"}),
    ("adafactor", {"v", "v_row", "v_col", "step"}),
    ("momentum", {"momentum_buffer"}),
])
def test_which_optimizer_states_migrate_live(optimizer, keys):
    """Every state of the trainer's optimizers has a global view, so each
    migrates live; a state of another shape (planted) has none and takes
    the fallback, its reason recorded."""
    t, state = _one_device(optimizer)
    sh = reshard.state_shardings_for(t, state, None)
    assert {k for leaves in sh.opt_state.values() for k in leaves} == keys
    if optimizer == "adafactor":
        assert sh.opt_state["fc2.weight"]["v_row"].shape == (256,)
    p = next(iter(state.optimizer.state))
    state.optimizer.state[p]["planted"] = torch.zeros(3)
    with pytest.raises(reshard.ReshardError, match="planted"):
        reshard.state_shardings_for(t, state, None)
    manager = LiveReshardManager(_port_contract())
    manager.on_slice_loss("s1", [])
    coordinator = reshard.LiveReshardCoordinator(manager=manager, mesh_for=lambda c: None)
    before = sum(1 for e in get_recorder().tail(4096) if e.get("kind") == "reshard_fallback")
    out, action = coordinator.execute(t, state, step=state.step)
    assert action == "stop" and out is state and coordinator.fallback_pending
    assert "planted" in coordinator.records[-1].reason
    assert coordinator.fallback_contract.slices_count == 1
    after = sum(1 for e in get_recorder().tail(4096) if e.get("kind") == "reshard_fallback")
    assert after - before == 1


def _port_contract():
    return ClusterContract.build(
        cluster_name="live", coordinator_ip="10.0.0.1",
        other_worker_ips=["10.0.0.2", "10.0.0.3", "10.0.0.4"], chips_per_worker=1,
        storage_mount="/mnt/none",
        slices={"s0": ["10.0.0.1", "10.0.0.2"], "s1": ["10.0.0.3", "10.0.0.4"]})


def test_growing_the_mesh_is_not_executed_live(runs):
    """A grow is live only for ranks that parked in the process group: on one
    device (no group), and on four ranks whose returning slice left for good
    (its ranks never call ``rejoin``), it takes the fallback; the parked slice of the spawn's
    ``regrow`` case comes back live, accumulation 1 -> 2 -> 1."""
    t, state = _one_device("adamw")
    manager = LiveReshardManager(_port_contract().surviving({"s1"}))
    manager.arm_restore("s1", ["10.0.0.3", "10.0.0.4"])
    coordinator = reshard.LiveReshardCoordinator(manager=manager, mesh_for=lambda c: None)
    assert coordinator.pending()
    out, action = coordinator.execute(t, state, step=state.step)
    assert action == "stop" and out is state and coordinator.fallback_pending
    assert "process group" in coordinator.records[-1].reason
    assert coordinator.fallback_contract.slices_count == 2
    ranks = runs["ranks"]
    for r in ranks[:2]:
        assert [(b["action"], b["grad_accum"]) for b in r["regrow"]["boundaries"]] == [
            ("resume", 2), ("resume", 1)]
        assert r["regrow"]["live_total"] == 2 and r["regrow"]["step"] == STEPS
        assert [b["action"] for b in r["regrow_absent"]["boundaries"]] == ["resume", "stop"]
        assert r["regrow_absent"]["fallback_total"] == 1
    for r in ranks[2:]:
        assert r["regrow"]["rejoined_at"] == GROW_AT and r["regrow"]["step"] == STEPS
        assert r["regrow_absent"]["left"] and r["regrow_absent"]["rejoined_at"] is None
    assert ranks[0]["regrow"]["losses"][:DIE_AT] == ranks[0]["straight"]["losses"][:DIE_AT]
    assert _close(ranks[0]["regrow"]["losses"], ranks[0]["straight"]["losses"],
                  SCENARIO_RTOL, SCENARIO_ATOL)


def test_fit_refuses_steps_per_call_with_reshard():
    t, state = _one_device("adamw")
    coordinator = reshard.LiveReshardCoordinator(
        manager=LiveReshardManager(_port_contract()), mesh_for=lambda c: None)
    with pytest.raises(ValueError, match="steps_per_call"):
        t.fit(state, iter([]), steps=2, steps_per_call=2, reshard=coordinator)


def test_losing_the_coordinators_slice_raises_from_fit():
    t, state = _one_device("adamw")
    manager = LiveReshardManager(_port_contract())
    coordinator = reshard.LiveReshardCoordinator(manager=manager, mesh_for=lambda c: None,
                                                 clock=VirtualClock())
    x, y = (torch.from_numpy(a) for a in _batches_np()[0])

    def batches():
        for i in itertools.count():
            if i == 1:
                manager.on_slice_loss("s0", [])
            yield Batch(x=x, y=y)

    with pytest.raises(ValueError, match="coordinator"):
        t.fit(state, batches(), steps=3, prefetch=0, reshard=coordinator)


@pytest.mark.cuda
def test_two_rank_live_reshard_on_card(tmp_path):
    """Two processes on the one card over gloo: the MLP's live reshard from
    2 slices to 1, the burst on rank 0 only; rank 0 trains on with
    accumulation 2, its first steps bitwise the straight run's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    rng = np.random.default_rng(0)
    init = {"fc1": {"kernel": rng.normal(size=(64, 256)).astype(np.float32) * 0.1,
                    "bias": np.zeros(256, np.float32)},
            "fc2": {"kernel": rng.normal(size=(256, 256)).astype(np.float32) * 0.06,
                    "bias": np.zeros(256, np.float32)},
            "head": {"kernel": rng.normal(size=(256, 10)).astype(np.float32) * 0.06,
                     "bias": np.zeros(10, np.float32)}}
    base = dict(init=init, batches=_batches_np(), die_at=DIE_AT, burst=["10.0.0.2"],
                workers=2, device="cuda")
    cases = {"straight": {**base, "reshard": "straight"},
             "live": {**base, "reshard": "live", "events_on": [0],
                      "dir": str(tmp_path / "ckpt")}}
    path = tmp_path / "cases.pkl"
    path.write_bytes(pickle.dumps(cases))
    r0, r1 = _spawn(2, path)
    assert r0["live"]["live_total"] == 1 and r0["live"]["grad_accum"] == 2
    assert r0["live"]["topology"] == {"devices": 1, "axes": {}}
    assert r1["live"]["left"] and r1["live"]["paused_at"] == [DIE_AT]
    assert r0["live"]["losses"][:DIE_AT] == r0["straight"]["losses"][:DIE_AT]
    assert _close(r0["live"]["losses"], r0["straight"]["losses"], SCENARIO_RTOL, SCENARIO_ATOL)
    assert r0["live"]["restored_step"] == STEPS and r0["live"]["restored_bitwise"]


# --- the chaos scenario ---------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slice_loss_live_scenario_holds_its_invariants(seed):
    """The JAX package's ``slice-loss-live`` scenario on the port (four gloo
    ranks): every invariant holds; its fault schedule (the boundary of the
    loss, the burst's order) is JAX's for the seed."""
    from deeplearning_cfn_tpu_torch.analysis.schedules import interleavings
    from deeplearning_cfn_tpu_torch.chaos import run_scenario

    report = run_scenario("slice-loss-live", seed, device="cpu").to_dict()
    assert report["passed"], report["violations"]
    assert len(report["invariants"]) == 13 and report["schema_version"] == 2
    details = report["details"]
    assert details["die_at_step"] == 3 + seed % 3
    assert details["burst_order"] == list(interleavings(BURST, count=1, seed=seed)[0])
    if jax is not None:
        from deeplearning_cfn_tpu.analysis.schedules import interleavings as jinterleavings

        assert details["burst_order"] == list(jinterleavings(BURST, count=1, seed=seed)[0])
    assert details["grad_accum_after"] == 2 and details["fallback_restore_step"] == (
        details["die_at_step"])
    if seed == 0:  # deterministic per seed, byte for byte
        again = run_scenario("slice-loss-live", seed, device="cpu").to_dict()
        assert json.dumps(again, sort_keys=True) == json.dumps(report, sort_keys=True)


def test_chaos_command(capsys):
    from deeplearning_cfn_tpu_torch import cli

    assert cli.main(["chaos", "--list"]) == 0
    out = capsys.readouterr().out
    # The catalog in name order: alert-storm first, slice-loss-live among the rest.
    assert out.startswith("alert-storm") and "slice-loss, forced-fallback" in out
    assert "\nslice-loss-live " in out
    assert cli.main(["chaos", "--scenario", "bogus"]) == 2
    assert cli.main(["chaos"]) == 2


def test_chaos_runs_on_the_card_unless_asked_for_the_cpu():
    from deeplearning_cfn_tpu_torch import cli

    parser = cli.build_parser()
    assert parser.parse_args(["chaos", "--scenario", "slice-loss-live"]).device == "cuda"
    assert parser.parse_args(["chaos", "--device", "cpu"]).device == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["chaos", "--scenario", "slice-loss-live"])
