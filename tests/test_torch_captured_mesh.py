"""``Trainer.multi_step_fn(k)`` over DDP, the bucketed sync and GPipe stages
against JAX's ``multi_step_fn(k)`` over the same mesh.

JAX's ``multi_step_fn`` jits k steps over any mesh.  The port captures its
k steps as one CUDA graph on the card (NCCL); the CPU runs the same body
(``Trainer._steps``) eagerly, which is what these tests hold: spawned gloo
ranks (``tests/torch_dist_ranks.py``, importing no JAX) run the tiny f32
Llama from the JAX package's initial weights through ``multi_step_fn(2)``
on four global batches (two calls), and the JAX trainer runs its
``multi_step_fn(2)`` on the same batches on the conftest's virtual CPU
devices.  The layouts:

- ``dp2``: the dp step over dp 2 (DDP's sync without its wrapper,
  ``overlap.DDPGradSync``; ``test_torch_overlap.py`` holds it bitwise to
  torch's own DDP);
- ``overlap2``: ``comms_overlap`` at a 32 KiB bucket target (several fused
  buckets), ``overlap2_int8`` with ``overlap_compress``.  JAX's Llama
  refuses ``comms_overlap`` (its ``embed`` spec names two axes), so these
  are held to JAX's dp ``multi_step_fn``, as ``test_torch_overlap.py``
  holds the bucketed step to JAX's dp step;
- ``pp2``: two GPipe stages, two microbatches; ``pp2_remat`` with
  ``TrainerConfig.remat`` (each stage's forward of each microbatch
  recomputed in its backward).

Each case also runs as four eager ``train_step`` calls in the same spawn:
the k-step body gives their losses, global gradient norm and final
parameters bit for bit.

Tolerances are those of ``test_torch_parallel_5b.py`` and
``test_torch_overlap.py`` for the same layouts: f32, the losses and the
first batch's gradient norm to 1e-5 relative; the parameters by the Adam
rule (at most 0.1% of a tensor's elements off by more than 2e-6, none by
more than lr a step).  The int8 sync is held to JAX's f32 run as
``test_torch_overlap.py`` holds the int8 curve to the f32 one (``rtol 5e-3,
atol 1e-3`` on the losses and the norm), and each of its parameter tensors
by its mean gap from JAX's f32 parameters (``INT8_PARAM_MEAN`` lr, from the
gaps measured over six seeds with margin): the sync is lossy, so a
near-zero gradient may take the other sign, and Adam then moves the two
runs apart by up to twice lr a step on that element.

The refusal: a CUDA graph cannot hold a gloo group's collectives, so
``mesh.capture_refusal`` names NCCL for a gloo mesh on the card (decided
here on the CPU with a one-rank gloo group).
"""

import dataclasses
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

from deeplearning_cfn_tpu.models import llama as jax_llama  # noqa: E402
from deeplearning_cfn_tpu.parallel.mesh import MeshSpec, build_mesh  # noqa: E402
from deeplearning_cfn_tpu.train import data as jax_data  # noqa: E402
from deeplearning_cfn_tpu.train.trainer import TrainerConfig as JaxTrainerConfig  # noqa: E402
from deeplearning_cfn_tpu.utils.compat import set_mesh  # noqa: E402
from deeplearning_cfn_tpu_torch import interop  # noqa: E402
from deeplearning_cfn_tpu_torch.models import llama  # noqa: E402
from deeplearning_cfn_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SEQ, K, BATCHES, GLOBAL_BATCH, JOIN_TIMEOUT = 16, 2, 4, 4, 420
TRAIN = dict(optimizer="adamw", learning_rate=1e-3, weight_decay=0.1, grad_clip_norm=1.0,
             log_every=1)
BUCKETS = dict(strategy="dp", comms_overlap=True, overlap_bucket_bytes=32 * 1024)
PP = dict(vocab_size=64, pp_stages=2, pp_microbatches=2)
CASES = {  # name: (mesh, config overrides, trainer overrides)
    "dp2": (dict(dp=2), dict(vocab_size=64), dict(strategy="dp")),
    "overlap2": (dict(dp=2), dict(vocab_size=64), BUCKETS),
    "overlap2_int8": (dict(dp=2), dict(vocab_size=64), dict(BUCKETS, overlap_compress=True)),
    "pp2": (dict(pp=2), PP, dict(strategy="dp")),
    "pp2_remat": (dict(pp=2), PP, dict(strategy="dp", remat=True)),
}
INT8_LOSS_TOL = dict(rtol=5e-3, atol=1e-3)
# The int8 run's parameters against JAX's f32 run: each tensor's mean gap,
# in units of lr.  Measured 0.215-0.270 over init and data seeds 0-5; with
# the buckets left unsynced (each rank on its own half batch) 1.72.
INT8_PARAM_MEAN = 0.4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(n: int, path: Path) -> list[dict]:
    """``torch_dist_ranks.py`` on ``path`` as ``n`` processes of one gloo
    group; each rank's results.  A rank that fails, or a group that outlives
    the join timeout, fails the test."""
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


def _jcfg(cfg_kw):
    return dataclasses.replace(jax_llama.LlamaConfig.tiny(seq_len=SEQ, dtype=jnp.float32),
                               **cfg_kw)


def _tcfg(cfg_kw):
    return dataclasses.replace(llama.LlamaConfig.tiny(dtype=torch.float32), **cfg_kw)


def _jax_kw(train_kw: dict) -> dict:
    return {k: v for k, v in train_kw.items() if not k.startswith(("comms_", "overlap_"))}


def _jax_reference(mesh_kw: dict, cfg_kw: dict, jax_kw: dict) -> dict:
    """JAX's ``multi_step_fn(K)`` over ``mesh_kw``: initial weights,
    batches, losses, the first batch's global gradient norm, final weights."""
    jcfg = _jcfg(cfg_kw)
    mesh = build_mesh(MeshSpec(**mesh_kw), jax.devices()[:2])
    jtrainer = jax_llama.make_trainer(jcfg, mesh, JaxTrainerConfig(**{**TRAIN, **jax_kw}))
    ds = jax_data.SyntheticTokenDataset(seq_len=SEQ, vocab_size=jcfg.vocab_size,
                                        batch_size=GLOBAL_BATCH)
    batches = [(np.asarray(b.x), np.asarray(b.y)) for b in ds.batches(BATCHES)]
    state = jtrainer.init(jax.random.key(0), jnp.asarray(batches[0][0]))
    init = jax.device_get(state.params)
    x0, y0 = (jnp.asarray(a) for a in batches[0])
    with set_mesh(mesh):
        grads = jax.jit(jax.grad(
            lambda p: jax_llama.causal_lm_loss(jcfg, p, x0, y0, mesh)[0]))(state.params)
    kfn = jtrainer.multi_step_fn(K)
    losses = []
    for c in range(0, BATCHES, K):
        xs, ys = (jnp.asarray(np.stack([b[j] for b in batches[c:c + K]])) for j in (0, 1))
        state, got = kfn(state, xs, ys)
        losses += [float(v) for v in np.asarray(got)]
    return {"init": init, "batches": batches, "losses": losses,
            "norm": float(optax.global_norm(grads)), "final": jax.device_get(state.params)}


def _ranks(tmp_path_factory, names: list[str]):
    """JAX's references and the ranks' runs of ``names`` (one spawn)."""
    refs, cases, computed = {}, {}, {}
    for name in names:
        mesh_kw, cfg_kw, train_kw = CASES[name]
        key = repr((mesh_kw, cfg_kw, _jax_kw(train_kw)))  # the dp cases share JAX's dp run
        if key not in computed:
            computed[key] = _jax_reference(mesh_kw, cfg_kw, _jax_kw(train_kw))
        ref = refs[name] = computed[key]
        case = {"mesh": mesh_kw, "cfg": {"max_seq_len": SEQ, **cfg_kw},
                "trainer": {**TRAIN, **train_kw}, "init": ref["init"], "batches": ref["batches"]}
        cases[name] = {**case, "steps_per_call": K}
        cases[f"{name}_eager"] = case
    path = tmp_path_factory.mktemp("captured_mesh") / "cases.pkl"
    path.write_bytes(pickle.dumps(cases))
    out = _spawn(2, path)
    return refs, {name: [r[name] for r in out] for name in cases}


# Two spawns, so that no test waits for all five cases' references.
@pytest.fixture(scope="module")
def dp_ranks(tmp_path_factory):
    return _ranks(tmp_path_factory, [n for n in CASES if not n.startswith("pp")])


@pytest.fixture(scope="module")
def pp_ranks(tmp_path_factory):
    return _ranks(tmp_path_factory, [n for n in CASES if n.startswith("pp")])


@pytest.fixture()
def ranks(request, name):
    return request.getfixturevalue("pp_ranks" if name.startswith("pp") else "dp_ranks")


def _merged_params(ranks) -> dict:
    """The whole model's parameters from the ranks (a pp rank holds its
    stage; every rank that holds a parameter holds the same)."""
    out = {}
    for r in ranks:
        for pname, v in r["params"].items():
            out.setdefault(pname, v)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_multi_step_matches_jax_multi_step(ranks, name):
    refs, got = ranks
    ref, rs = refs[name], got[name]
    int8 = CASES[name][2].get("overlap_compress", False)
    tol = INT8_LOSS_TOL if int8 else dict(rtol=1e-5)
    for r in rs:
        assert r["losses"] == rs[0]["losses"], "ranks disagree on the global loss"
        np.testing.assert_allclose(r["norm"], ref["norm"], **tol)
    assert len(rs[0]["losses"]) == BATCHES
    np.testing.assert_allclose(rs[0]["losses"], ref["losses"], **tol)
    assert ref["norm"] > TRAIN["grad_clip_norm"]  # the clip is active
    final = interop.llama_params_from_jax(_tcfg(CASES[name][1]), ref["final"])
    params = _merged_params(rs)
    assert params.keys() == final.keys()
    lr = TRAIN["learning_rate"]
    for pname, want in final.items():
        diff = np.abs(params[pname] - want.numpy())
        if int8:
            assert diff.mean() <= INT8_PARAM_MEAN * lr, (pname, diff.mean())
        else:
            assert diff.max() <= lr * BATCHES, (pname, diff.max())
            assert np.mean(diff > 2e-6) <= 1e-3, (pname, diff.max())
    if name.startswith("pp"):
        assert sorted(r["pp_rank"] for r in rs) == [0, 1]


@pytest.mark.parametrize("name", list(CASES))
def test_multi_step_body_is_bitwise_the_eager_steps(ranks, name):
    """The k-step body (what the card's graph captures) gives the eager
    ``train_step``s' losses, gradient norm and parameters bit for bit: the
    dp step, the bucketed syncs, GPipe with its stages' layouts exchanged
    once."""
    _, got = ranks
    for body, eager in zip(got[name], got[f"{name}_eager"]):
        assert body["losses"] == eager["losses"] and body["norm"] == eager["norm"]
        assert body["params"].keys() == eager["params"].keys()
        for pname, v in body["params"].items():
            np.testing.assert_array_equal(v, eager["params"][pname], err_msg=pname)
        assert body["ddp"] == eager["ddp"] == (name == "dp2")
        for a, b in zip(body.get("residual", []), eager.get("residual", [])):
            np.testing.assert_array_equal(a, b)


def test_capture_refusal_names_nccl_for_a_gloo_mesh_on_the_card():
    import torch.distributed as dist

    assert mesh_lib.capture_refusal(None, "cuda") is None
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    try:
        m = mesh_lib.build_mesh(mesh_lib.MeshSpec(dp=1))
        assert mesh_lib.capture_refusal(m, "cpu") is None
        for device in ("cuda", torch.device("cuda", 0)):
            why = mesh_lib.capture_refusal(m, device)
            assert why is not None and "NCCL" in why and "gloo" in why
    finally:
        dist.destroy_process_group()
