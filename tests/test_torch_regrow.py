"""The port's live regrowth (``train/reshard.py``'s grow direction), on four
CPU gloo ranks.

JAX re-meshes devices inside one process; the port's ranks are processes and
``torch.distributed`` cannot add a rank to a running group, so a slice comes
back only if its ranks parked in the group when it left
(``LiveReshardCoordinator.rejoin``).  One spawn of
``tests/torch_dist_ranks.py`` runs a small MLP (JAX ``test_reshard.py``'s
``_MLP``, its initial weights carried from JAX) on 2 slices x fsdp 2 with
AdamW:

- **straight**: eight steps, no loss;
- **regrow**: slice ``s1`` leaves at the boundary of batch ``DIE_AT``
  (accumulation 1 -> 2 on the survivors), its ranks park, and rejoin at the
  boundary of batch ``GROW_AT`` (2 -> 1, ``symmetric_accum``); the state each
  rank holds right after the grow is bitwise the survivors' (a returning
  rank's shards equal the survivor's of its fsdp index), every loss within
  the JAX scenario's tolerance of the straight run and of JAX's ``fit`` with
  the same shrink and grow on eight virtual devices;
- **absent**: the same, but the ranks of ``s1`` never call ``rejoin``, as
  processes that died: they leave for good, and the grow takes the fallback (``reshard_fallback``, ``"stop"``);
- **fsdp**: one fsdp axis over the four ranks (fsdp 4 -> 2 -> 4): the
  survivors' shards change at the grow, so every leaf is gathered on them
  and broadcast whole; each leaf after the grow equals the survivors' before
  it, on every rank, and the losses hold the straight fsdp 4 run;
- **released**: parked ranks whose slice never comes back are released by
  rank 0 at the end of its run (``rejoin`` returns None).
"""

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
    import jax
except ImportError:  # the card's host
    jax = None

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tests"))

torch.set_num_threads(1)

needs_jax = pytest.mark.skipif(jax is None, reason="needs JAX, the reference")

# The JAX sched-flash-crowd scenario's continuity tolerance (chaos/scenarios.py).
RTOL, ATOL = 5e-3, 1e-4
# f32 losses of one model on one global batch, summed in another order.
JAX_RTOL, JAX_ATOL = 1e-5, 1e-6
STEPS, DIE_AT, GROW_AT, JOIN_TIMEOUT = 8, 2, 5, 300
BURST = ["10.0.0.3", "10.0.0.4", "10.0.0.3"]


def _jax_run(grow: bool) -> dict:
    """JAX ``fit`` on the same layout (2 slices x fsdp 4 on 8 virtual
    devices): slice s1 lost at DIE_AT and, with ``grow``, restored at GROW_AT
    with ``symmetric_accum``; straight without."""
    import test_torch_reshard as ref

    class Backend:
        def __init__(self):
            self.events = ref.jevents.EventBus()

    vclock = ref.JVirtualClock()
    controller = ref.ElasticityController(backend=Backend(), coordinator_queue_name="coord",
                                          slice_loss_window_s=10.0, clock=vclock)
    controller.register(ref.GroupPolicy("s0", 1, "sig-s0", coordinator=True))
    controller.register(ref.GroupPolicy("s1", 1, "sig-s1"))
    controller.attach()
    manager = ref.JManager(ref._jax_contract())
    manager.attach(controller)
    coordinator = ref.jreshard.LiveReshardCoordinator(
        manager=manager, mesh_for=ref._jax_mesh_for, flush=controller.flush_slice_losses,
        clock=vclock, symmetric_accum=True)
    trainer = ref.JTrainer(ref._MLP(), ref._jax_mesh_for(manager.contract), ref.JConfig(
        optimizer="adamw", learning_rate=1e-3, strategy="fsdp", matmul_precision="float32",
        log_every=1))
    state = trainer.init(jax.random.PRNGKey(0), np.zeros((8, 8, 8, 1), np.float32))
    init = jax.tree_util.tree_map(np.asarray, jax.device_get(state.params))
    s1 = list(ref._jax_contract().slices["s1"])

    def batches():
        for i, (x, y) in enumerate(_batches_np()):
            if grow and i == DIE_AT:
                for ip in BURST:
                    controller.backend.events.publish(ref.jevents.LifecycleEvent(
                        kind=ref.jevents.EventKind.INSTANCE_TERMINATE, group="s1",
                        instance_id=ip, detail={"reason": "sched-preempt"}))
                    vclock.advance(0.5)
                vclock.advance(11.0)
            if grow and i == GROW_AT:
                manager.arm_restore("s1", s1)
            yield ref.JBatch(x=x, y=y)

    state, losses = trainer.fit(state, batches(), steps=STEPS, prefetch=0,
                                reshard=coordinator if grow else None)
    return {"init": init, "losses": losses, "live_total": coordinator.live_total,
            "grad_accum": trainer.config.grad_accum_steps}


def _batches_np():
    rng = np.random.default_rng(2)
    return [(rng.normal(size=(32, 8, 8, 1)).astype(np.float32),
             rng.integers(0, 10, size=(32,)).astype(np.int64)) for _ in range(STEPS)]


def _spawn(n: int, path: Path) -> list[dict]:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    if jax is None:
        pytest.skip("needs JAX, the reference (its initial weights)")
    tmp = tmp_path_factory.mktemp("regrow")
    live, straight = _jax_run(True), _jax_run(False)
    base = dict(init=live["init"], batches=_batches_np(), die_at=DIE_AT, grow_at=GROW_AT,
                burst=BURST)
    cases = {
        "straight": {**base, "reshard": "straight"},
        "regrow": {**base, "regrow": True, "rejoin": True},
        "absent": {**base, "regrow": True, "rejoin": False},
        "fsdp_straight": {**base, "reshard": "straight", "layout": "fsdp"},
        "fsdp": {**base, "regrow": True, "rejoin": True, "layout": "fsdp"},
        "released": {**base, "regrow": True, "rejoin": True, "grow_at": STEPS + 1},
    }
    path = tmp / "cases.pkl"
    path.write_bytes(pickle.dumps(cases))
    return {"jax_live": live, "jax_straight": straight, "ranks": _spawn(4, path)}


def _close(a, b, rtol, atol) -> bool:
    return len(a) == len(b) and bool(np.allclose(a, b, rtol=rtol, atol=atol))


def test_accumulation_goes_one_two_one(runs):
    for rank in runs["ranks"][:2]:
        got = rank["regrow"]
        assert [(b["step"], b["action"], b["grad_accum"]) for b in got["boundaries"]] == [
            (DIE_AT, "resume", 2), (GROW_AT, "resume", 1)]
        assert got["boundaries"][0]["topology"] == {"devices": 2, "axes": {"fsdp": 2}}
        assert got["topology"] == {"devices": 4, "axes": {"dp": 2, "fsdp": 2}}
        assert got["grad_accum"] == 1 and got["slices"] == 2
        assert got["live_total"] == 2 and got["fallback_total"] == 0
        assert got["journal"] == {"reshard": 2, "reshard_fallback": 0,
                                  "grad_accum_rescaled": 2,
                                  "slice_restore_armed": 1 if rank is runs["ranks"][0] else 0}
    assert runs["jax_live"]["grad_accum"] == 1 and runs["jax_live"]["live_total"] == 2


def test_returning_ranks_rejoin_at_the_grow_boundary(runs):
    for rank in runs["ranks"][2:]:
        got = rank["regrow"]
        assert got["rejoined_at"] == GROW_AT and not got["left"]
        assert [(b["step"], b["action"], b["grad_accum"]) for b in got["boundaries"]] == [
            (DIE_AT, "leave", 1), (GROW_AT, "rejoin", 1)]
        assert got["topology"] == {"devices": 4, "axes": {"dp": 2, "fsdp": 2}}
        assert got["step"] == STEPS and got["live_total"] == 1
        assert len(got["losses"]) == DIE_AT + STEPS - GROW_AT


def test_state_after_the_grow_is_bitwise_the_survivors(runs):
    r = [rank["regrow"]["snaps"] for rank in runs["ranks"]]
    for survivor, returning in ((0, 2), (1, 3)):
        before, after = r[survivor]["before"], r[survivor]["after"]
        assert before.keys() == after.keys() == r[returning]["after"].keys()
        for k in before:
            assert np.array_equal(before[k], after[k]), k  # pure data movement
            assert np.array_equal(after[k], r[returning]["after"][k]), k
    # The two fsdp shards differ: the comparison sees genuinely sharded leaves.
    assert not np.array_equal(r[0]["after"]["model.fc2.weight"], r[1]["after"]["model.fc2.weight"])


def test_losses_hold_the_straight_run_and_jax(runs):
    straight = runs["ranks"][0]["straight"]["losses"]
    for rank in runs["ranks"]:
        got = rank["regrow"]["losses"]
        if rank is runs["ranks"][2] or rank is runs["ranks"][3]:
            assert got[:DIE_AT] == straight[:DIE_AT]
            continue
        assert got[:DIE_AT] == straight[:DIE_AT]  # bitwise before the shrink
        assert _close(got, straight, RTOL, ATOL)
        assert _close(got, runs["jax_live"]["losses"], JAX_RTOL, JAX_ATOL)
    assert _close(straight, runs["jax_straight"]["losses"], JAX_RTOL, JAX_ATOL)
    # The returning ranks train the grown mesh's steps with the survivors.
    r0, r2 = runs["ranks"][0]["regrow"]["losses"], runs["ranks"][2]["regrow"]["losses"]
    assert r2[DIE_AT:] == r0[GROW_AT:]


def test_a_grow_of_a_slice_whose_ranks_left_takes_the_fallback(runs):
    for rank in runs["ranks"][:2]:
        got = rank["absent"]
        assert [(b["step"], b["action"]) for b in got["boundaries"]] == [
            (DIE_AT, "resume"), (GROW_AT, "stop")]
        assert got["fallback_pending"] and got["fallback_total"] == 1
        assert "not parked" in got["fallback_reason"]
        assert got["journal"]["reshard_fallback"] == 1
        assert len(got["losses"]) == GROW_AT and got["grad_accum"] == 2
    for rank in runs["ranks"][2:]:
        got = rank["absent"]
        assert got["left"] and got["rejoined_at"] is None and len(got["losses"]) == DIE_AT


def test_an_fsdp_mesh_regrows_by_whole_leaves(runs):
    ranks = runs["ranks"]
    before = ranks[0]["fsdp"]["snaps"]["before"]
    for rank in ranks:
        got = rank["fsdp"]
        after = got["snaps"]["after"]
        assert after.keys() == before.keys()
        for k in before:
            assert np.array_equal(after[k], before[k]), k
        assert got["topology"] == {"devices": 4, "axes": {"fsdp": 4}} and got["step"] == STEPS
    r0 = ranks[0]["fsdp"]
    assert [(b["topology"], b["grad_accum"]) for b in r0["boundaries"]] == [
        ({"devices": 2, "axes": {"fsdp": 2}}, 2), ({"devices": 4, "axes": {"fsdp": 4}}, 1)]
    straight = ranks[0]["fsdp_straight"]["losses"]
    assert r0["losses"][:DIE_AT] == straight[:DIE_AT]
    assert _close(r0["losses"], straight, RTOL, ATOL)


def test_parked_ranks_never_regrown_are_released(runs):
    for rank in runs["ranks"][:2]:
        got = rank["released"]
        assert got["live_total"] == 1 and got["grad_accum"] == 2 and len(got["losses"]) == STEPS
    for rank in runs["ranks"][2:]:
        got = rank["released"]
        assert got["left"] and got["rejoined_at"] is None and got["step"] is None
