"""The rest of slice 5b against the JAX trainer over the same mesh.

Spawned gloo ranks on the CPU (``tests/torch_dist_ranks.py``, importing no
JAX) run three AdamW steps of the tiny Llama (``tiny_moe`` for the MoE
cases) from the JAX package's initial weights on the same global batches;
the JAX trainer runs them here over the same ``MeshSpec`` on the conftest's
virtual CPU devices.  The layouts the port refused before:

- two ranks: ``moe_tp2`` (each tp rank its columns of every expert),
  ``moe_sp2`` (one routing group over the two sequence blocks),
  ``pp2_remat`` (``TrainerConfig.remat`` over GPipe stages, each stage's
  forward of each microbatch checkpointed, its activations through
  ``parallel/p2p.py``'s host staging, which CUDA tensors on gloo take, here
  CPU tensors forced through it), ``sp2_ring_p2p`` (ring attention through
  the same staging), ``sp2_flash`` (the flash route under sp, its plain
  version: k/v gathered, the block's q rows at their causal offset, the
  keys before them and the diagonal block merged by their lse);
- four ranks: ``moe_ep2_tp2`` (experts over ep, their columns over tp),
  ``moe_sp2_dp2`` (two routing groups of two sequence blocks each),
  ``tp4_kv2`` (tp 4 over the tiny model's 2 kv heads: each rank gathers k
  and v and keeps its q heads' kv heads; ``tp4_kv2_fused`` the same through
  the fused ``wqkv``), ``sp2_pp2`` (the sequence split inside GPipe's
  stages).

Each case checks the losses (equal on every rank), the global norm of the
first batch's gradients, and the final parameters.  The MoE cases also
check layer 0's routing of the first batch: each rank's chosen experts,
claimed slots and kept claims, put in their group's token order, equal
JAX's routing arithmetic (``deeplearning_cfn_tpu/ops/moe.py:121-140``, as
``tests/test_torch_moe.py`` reads it) over the group's router
probabilities, to the last index.  ``pp2_remat`` runs beside ``pp2_plain``
(the same without remat) in one spawn: losses, the norm and every final
parameter bit for bit equal.

``llama_train``'s flags over the ranks train as one process does on the
same stream (the tiny preset is bf16: ``rtol 2e-2``): ``--experts 4 --tp
2``, ``--experts 4 --sp 2``, ``--pp 2 --remat`` on two ranks, ``--sp 2
--pp 2`` and ``--tp 4`` on four.  JAX's refusals stay: ring attention with
pipeline stages, and a tp that does not divide the heads.

Tolerances are ``test_torch_distributed.py``'s: f32; losses and the norm to
1e-5 relative; the parameters by the Adam rule (at most 0.1% of a tensor's
elements off by more than 2e-6, none by more than lr a step).
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
from deeplearning_cfn_tpu.ops import moe as jax_moe  # noqa: E402
from deeplearning_cfn_tpu.parallel.mesh import MeshSpec, build_mesh  # noqa: E402
from deeplearning_cfn_tpu.train import data as jax_data  # noqa: E402
from deeplearning_cfn_tpu.train.trainer import TrainerConfig as JaxTrainerConfig  # noqa: E402
from deeplearning_cfn_tpu.utils.compat import set_mesh  # noqa: E402
from deeplearning_cfn_tpu_torch import interop  # noqa: E402
from deeplearning_cfn_tpu_torch.models import llama  # noqa: E402
from deeplearning_cfn_tpu_torch.parallel.tensor_parallel import ModelParallel  # noqa: E402

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SEQ, STEPS, JOIN_TIMEOUT = 16, 3, 420
TRAIN = dict(optimizer="adamw", learning_rate=1e-3, weight_decay=0.1, grad_clip_norm=1.0,
             log_every=1)
# A capacity that drops claims, so that a group's count decides which.
MOE = dict(vocab_size=64, n_experts=4, moe_capacity_factor=0.5)
PP = dict(vocab_size=64, pp_stages=2, pp_microbatches=2)
CASES = {  # name: (ranks, mesh, config overrides, trainer overrides, global batch)
    "moe_tp2": (2, dict(tp=2), MOE, dict(strategy="fsdp"), 4),
    "moe_sp2": (2, dict(sp=2), MOE, dict(strategy="dp"), 4),
    "pp2_remat": (2, dict(pp=2), PP, dict(strategy="dp", remat=True), 4),
    "pp2_plain": (2, dict(pp=2), PP, dict(strategy="dp"), 4),
    "sp2_ring_p2p": (2, dict(sp=2), dict(vocab_size=64, use_ring_attention=True),
                     dict(strategy="dp"), 4),
    "sp2_flash": (2, dict(sp=2), dict(vocab_size=64), dict(strategy="dp"), 4),
    "moe_ep2_tp2": (4, dict(ep=2, tp=2), MOE, dict(strategy="fsdp"), 4),
    "moe_sp2_dp2": (4, dict(dp=2, sp=2), MOE, dict(strategy="dp"), 8),
    "tp4_kv2": (4, dict(tp=4), dict(vocab_size=64), dict(strategy="fsdp"), 4),
    "tp4_kv2_fused": (4, dict(tp=4), dict(vocab_size=64, fused_qkv=True), dict(strategy="fsdp"),
                      4),
    "sp2_pp2": (4, dict(pp=2, sp=2), PP, dict(strategy="dp"), 4),
}
STAGED = {"sp2_ring_p2p", "pp2_remat"}  # point-to-point forced through the host staging
# The card's flash route under sp, the kernel's plain version on the CPU:
# k/v gathered, the block's q rows at their offset (two passes merged).
ATTENTION = {"sp2_flash": "flash"}
EXAMPLE_ARGV = ["--size", "tiny", "--device", "cpu", "--seq_len", "32", "--global_batch_size",
                "4", "--steps", "3", "--log_every", "1"]
EXAMPLES = {  # name: (ranks, flags, the one-process run's flags)
    "example_moe_tp2": (2, ["--experts", "4", "--tp", "2"], ["--experts", "4"]),
    "example_moe_sp2": (2, ["--experts", "4", "--sp", "2"], ["--experts", "4"]),
    "example_pp2_remat": (2, ["--pp", "2", "--remat"], ["--remat"]),
    "example_sp2_pp2": (4, ["--sp", "2", "--pp", "2"], []),
    "example_tp4": (4, ["--tp", "4"], []),
}


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


def _jax_reference(name: str) -> dict:
    """The JAX trainer over the case's mesh: initial weights, batches,
    losses, the first batch's global gradient norm, final weights."""
    n, mesh_kw, cfg_kw, train_kw, batch = CASES[name]
    jcfg = _jcfg(cfg_kw)
    mesh = build_mesh(MeshSpec(**mesh_kw), jax.devices()[:n])
    jtrainer = jax_llama.make_trainer(jcfg, mesh, JaxTrainerConfig(**{**TRAIN, **train_kw}))
    ds = jax_data.SyntheticTokenDataset(seq_len=SEQ, vocab_size=jcfg.vocab_size, batch_size=batch)
    batches = [(np.asarray(b.x), np.asarray(b.y)) for b in ds.batches(STEPS)]
    state = jtrainer.init(jax.random.key(0), jnp.asarray(batches[0][0]))
    init = jax.device_get(state.params)
    x0, y0 = (jnp.asarray(a) for a in batches[0])
    with set_mesh(mesh):
        grads = jax.jit(jax.grad(
            lambda p: jax_llama.causal_lm_loss(jcfg, p, x0, y0, mesh)[0]))(state.params)
    losses = []
    for x, y in batches:
        state, metrics = jtrainer.train_step(
            state, *(jax.device_put(jnp.asarray(a), jtrainer.batch_sharding) for a in (x, y)))
        losses.append(float(metrics["loss"]))
    rank_case = {"mesh": mesh_kw, "cfg": {"max_seq_len": SEQ, **cfg_kw},
                 "trainer": {**TRAIN, **train_kw}, "init": init, "batches": batches,
                 "force_staging": name in STAGED, "attention": ATTENTION.get(name)}
    return {"rank_case": rank_case, "losses": losses, "norm": float(optax.global_norm(grads)),
            "final": jax.device_get(state.params), "lr": TRAIN["learning_rate"]}


def _example_reference(name: str) -> dict:
    """The example's flags for the ranks, and its single-process run here."""
    from deeplearning_cfn_tpu_torch.examples import llama_train

    _, flags, one = EXAMPLES[name]
    out = llama_train.main(EXAMPLE_ARGV + one)
    return {"rank_case": {"argv": EXAMPLE_ARGV + flags},
            "losses": [h["loss"] for h in out["history"]]}


def _run(tmp_path_factory, n: int) -> dict:
    names = [k for k, v in CASES.items() if v[0] == n]
    refs = {k: _jax_reference(k) for k in names}
    refs.update({k: _example_reference(k) for k, v in EXAMPLES.items() if v[0] == n})
    path = tmp_path_factory.mktemp(f"ranks{n}") / "cases.pkl"
    path.write_bytes(pickle.dumps({k: r["rank_case"] for k, r in refs.items()}))
    ranks = _spawn(n, path)
    return {k: (refs[k], [r[k] for r in ranks]) for k in refs}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return _run(tmp_path_factory, 2)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return _run(tmp_path_factory, 4)


def _merged_params(name, ranks) -> dict:
    """The whole model's parameters from the ranks: a pp rank's stage, the
    expert banks of the ep ranks concatenated in ep order (each already
    whole over tp); every rank that holds a parameter holds the same."""
    ep = CASES[name][1].get("ep", 1)
    out = {}
    for r in sorted(ranks, key=lambda r: r["ep_rank"]):
        for pname, v in r["params"].items():
            if ep > 1 and ".moe.w_" in pname:
                out.setdefault(pname, {})[r["ep_rank"]] = v
            else:
                out.setdefault(pname, v)
    return {k: np.concatenate([v[e] for e in range(ep)]) if isinstance(v, dict) else v
            for k, v in out.items()}


def _check(name, ref, ranks):
    for r in ranks:
        assert r["losses"] == ranks[0]["losses"], "ranks disagree on the global loss"
        np.testing.assert_allclose(r["norm"], ref["norm"], rtol=1e-5)
    np.testing.assert_allclose(ranks[0]["losses"], ref["losses"], rtol=1e-5)
    assert ref["norm"] > TRAIN["grad_clip_norm"]  # the clip is active
    final = interop.llama_params_from_jax(_tcfg(CASES[name][2]), ref["final"])
    got = _merged_params(name, ranks)
    assert got.keys() == final.keys()
    lr = ref["lr"]
    for pname, want in final.items():
        diff = np.abs(got[pname] - want.numpy())
        assert diff.max() <= lr * STEPS, (pname, diff.max())
        assert np.mean(diff > 2e-6) <= 1e-3, (pname, diff.max())


def _jax_routing(probs: np.ndarray, cfg_kw: dict):
    """JAX's routing arithmetic (``ops/moe.py:121-140``) over one group's
    ``[t, E]`` router probabilities: experts, slots, kept claims."""
    cfg = _jcfg(cfg_kw).moe
    E, k = cfg.n_experts, cfg.top_k
    t = probs.shape[0]
    C = jax_moe.expert_capacity(cfg, t)
    _, gate_idx = jax.lax.top_k(jnp.asarray(probs)[None], k)
    sel = jax.nn.one_hot(gate_idx, E, dtype=jnp.float32)
    sel_priority = jnp.swapaxes(sel, 1, 2).reshape(1, k * t, E)
    pos = (jnp.cumsum(sel_priority, axis=1) - sel_priority).reshape(1, k, t, E).swapaxes(1, 2)
    within = sel * (pos < C)
    slot = jnp.sum(pos * within, axis=-1).astype(jnp.int32)
    return np.asarray(gate_idx[0]), np.asarray(slot[0]), np.asarray(within.sum(-1)[0])


def _group_routing(ranks: list[dict], batch: int) -> dict:
    """One routing group's records from its sp ranks, in the group's token
    order: batch-major over the whole sequence."""
    by_sp = sorted(ranks, key=lambda r: r["sp_rank"])
    out = {}
    for key in ("probs", "expert", "slot", "kept"):
        blocks = [r["routing"][key].reshape(batch, -1, *r["routing"][key].shape[1:])
                  for r in by_sp]
        whole = np.concatenate(blocks, axis=1)
        out[key] = whole.reshape(-1, *whole.shape[2:])
    return out


def _check_routing(name, ranks):
    """Each routing group's decisions on the first batch equal JAX's."""
    _, mesh_kw, cfg_kw, _, batch = CASES[name]
    groups = {}
    for r in ranks:
        groups.setdefault((r["data_index"], r["tp_rank"], r["ep_rank"]), []).append(r)
    assert len(groups) == len(ranks) // mesh_kw.get("sp", 1)
    kept_all = []
    for members in groups.values():
        group = _group_routing(members, batch // len({k[0] for k in groups}))
        expert, slot, kept = _jax_routing(group["probs"], cfg_kw)
        np.testing.assert_array_equal(group["expert"], expert)
        np.testing.assert_array_equal(group["kept"], kept)
        np.testing.assert_array_equal(np.where(kept > 0, group["slot"], 0), slot)
        kept_all.append(kept)
    return np.concatenate(kept_all)


@pytest.mark.parametrize("name", ["moe_tp2", "moe_sp2", "pp2_remat", "sp2_ring_p2p",
                                  "sp2_flash"])
def test_two_rank_layouts_match_jax(two_ranks, name):
    ref, ranks = two_ranks[name]
    _check(name, ref, ranks)
    if name.startswith("moe"):
        kept = _check_routing(name, ranks)
        assert 0 < kept.mean() < 1  # the capacity drops claims: the group's count matters
    if name == "moe_tp2":  # each tp rank holds half of every expert's columns
        for r in ranks:
            assert r["sharded"]["layers.0.moe.w_gate"][-1] == 2
            assert r["sharded"]["layers.0.moe.w_down"][-1] == 1
    if name in STAGED:  # the ring's blocks, GPipe's activations through the host staging
        assert all(r["staged_bytes"] > 0 for r in ranks)


@pytest.mark.parametrize("name", ["moe_ep2_tp2", "moe_sp2_dp2", "tp4_kv2", "tp4_kv2_fused",
                                  "sp2_pp2"])
def test_four_rank_layouts_match_jax(four_ranks, name):
    ref, ranks = four_ranks[name]
    _check(name, ref, ranks)
    if name.startswith("moe"):
        _check_routing(name, ranks)
    if name == "moe_ep2_tp2":
        assert sorted((r["ep_rank"], r["tp_rank"]) for r in ranks) == [
            (0, 0), (0, 1), (1, 0), (1, 1)]
        assert ranks[0]["params"]["layers.0.moe.w_gate"].shape[0] == 2  # 4 experts over ep 2
    if name.startswith("tp4_kv2"):  # 2 kv heads over 4 ranks: half a kv head's columns a rank
        cfg = _tcfg(CASES[name][2])
        assert cfg.n_kv_heads % 4 and (cfg.n_kv_heads * cfg.head_dim) % 4 == 0
        assert all(r["loss_logits_width"] == cfg.vocab_size // 4 for r in ranks)


def test_remat_over_pipeline_stages_is_bitwise_the_plain_run(two_ranks):
    """``TrainerConfig.remat`` at pp 2: each stage's forward of each
    microbatch recomputed in its backward gives the losses, the gradient
    norm and the parameters of the run without it, bit for bit."""
    (_, remat), (_, plain) = two_ranks["pp2_remat"], two_ranks["pp2_plain"]
    for a, b in zip(remat, plain):
        assert a["losses"] == b["losses"] and a["norm"] == b["norm"]
        assert a["params"].keys() == b["params"].keys()
        for pname, v in a["params"].items():
            np.testing.assert_array_equal(v, b["params"][pname], err_msg=pname)


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_llama_train_flags_over_ranks(two_ranks, four_ranks, name):
    """The layouts through the normal entry point train as the example does
    in one process, from the same seed and stream."""
    ref, ranks = (two_ranks if EXAMPLES[name][0] == 2 else four_ranks)[name]
    flags = EXAMPLES[name][1]
    for r in ranks:
        assert r["losses"] == ranks[0]["losses"]
        for axis in ("tp", "sp", "pp"):
            if f"--{axis}" in flags:
                assert r["mesh"][axis] == int(flags[flags.index(f"--{axis}") + 1])
    np.testing.assert_allclose(ranks[0]["losses"], ref["losses"], rtol=2e-2)


def test_refusals_are_jaxs():
    """Ring attention with pipeline stages, and a tp that does not divide
    the heads, are refused by both packages; a tp that does not divide the
    kv heads is not."""
    with pytest.raises(ValueError, match="ring attention"):
        _tcfg(dict(PP, use_ring_attention=True))
    with pytest.raises(ValueError, match="ring attention"):
        _jcfg(dict(PP, use_ring_attention=True))
    cfg = _tcfg(dict(vocab_size=60))  # 4 heads, 2 kv heads; 60 splits over 3
    with pytest.raises(ValueError, match="n_heads"):
        llama._check_parallel(cfg, ModelParallel(tp=3), 1)
    llama._check_parallel(_tcfg(dict(vocab_size=64)), ModelParallel(tp=4), 1)
    jcfg = _jcfg(dict(vocab_size=60))
    mesh = build_mesh(MeshSpec(tp=3), jax.devices()[:3])
    with pytest.raises(ValueError):
        trainer = jax_llama.make_trainer(jcfg, mesh, JaxTrainerConfig(**TRAIN))
        trainer.init(jax.random.key(0), jnp.zeros((2, SEQ), jnp.int32))
