"""The port over several ranks against the JAX trainer over the same mesh.

Spawned gloo ranks on the CPU (``tests/torch_dist_ranks.py``, started with
the cluster contract's env, importing no JAX) run three steps of the tiny
Llama from the JAX package's initial weights on the same global batches; the
JAX trainer runs them here over the same ``MeshSpec`` on the conftest's
virtual CPU devices.  Cases:

- ``dp``: dp=2, DDP over the data ranks;
- ``fsdp``: fsdp=2, FSDP2, each parameter sharded on its spec's fsdp dim;
- ``adafactor_fsdp``: fsdp=2 at a width (dim 128, mlp 256) where Adafactor
  factors, so its row and column statistics span the shards;
- ``moe_dp``: MoE at dp=2, two routing groups (JAX's G = 2);
- ``moe_ep``: MoE at ep=2, the experts split over the two ranks;
- ``hsdp``: dp=2 × fsdp=2 on four ranks (HSDP);
- ``tp2``: tp=2, heads, MLP columns and the vocabulary split over the two
  ranks (``parallel/tensor_parallel.py``); ``tp2_fused``: the same with the
  fused ``wqkv`` and ``w_gate_up``, whose contiguous split over tp mixes q,
  k and v (gate and up) across the ranks, held to JAX's fused run;
- ``sp2``: sp=2, k and v gathered over the sequence's two blocks;
  ``sp2_ring`` (4 q heads, 4 kv heads) and ``sp2_ring_gqa`` (4 and 2) with
  ring attention;
- ``fsdp2_tp2``: fsdp=2 × tp=2 on four ranks, FSDP2 over tp ``DTensor`` s.

Each case checks the losses (equal on every rank: the global batch's), the
global norm of the first batch's gradients (across shards and expert
ranks), and the final parameters.  ``parallel.ring_attention`` and its
gradients are held to JAX's ``ring_attention`` at sp=2 and sp=4 (in the two
spawns).  Then ``multiprocess_smoke`` runs from the env contract: LeNet as
two processes, and the tiny Llama over fsdp=2 × tp=2 (``llama-fsdp``) as
four; the losses agree across the processes and fall.

Tolerances: f32; the ranks sum each gradient over the data ranks in another
order than XLA, so losses and the norm agree to 1e-5 relative, and the
parameters after three steps as ``tests/test_torch_trainer.py`` holds them
(Adam: at most 0.1% of a tensor's elements off by more than 2e-6, none by
more than lr a step).

Each spawn has a free port, ``torch.set_num_threads(1)`` in every rank, and
a join timeout that fails the test; several cases share one spawn.

The batch's reductions over the data ranks, at dp=2 against the JAX trainer
at ``MeshSpec(dp=2)`` (one spawn, three cases): ResNet's BatchNorm
statistics, BERT's masked count (another on each rank), and RetinaNet with
masks (BatchNorm, positive anchors, mask slots); each step's metrics to 1e-5
relative, the final parameters and running statistics to 1e-5 absolute.

Restores across a topology change (``tests/test_topology_restore.py``'s
slow path, on the DCP ``Checkpointer``): three steps on one mesh, a save,
a restore onto another layout into a state from another seed, two more
steps; the five losses and the final parameters held as above to the
port's uninterrupted single-rank run from the same weights.  Saved at
fsdp=2 (AdamW, LAMB, Adafactor at the factoring widths: their local state
saved with its global shape) and at ep=2 (MoE), restored at one rank;
saved at dp=2 (DDP), restored at fsdp=2.  ``mesh_topology`` of each mesh
equals the JAX package's of the same ``MeshSpec``.
"""

import dataclasses
import json
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
from deeplearning_cfn_tpu.train.reshard import mesh_topology as jax_mesh_topology  # noqa: E402
from deeplearning_cfn_tpu.train.trainer import TrainerConfig as JaxTrainerConfig  # noqa: E402
from deeplearning_cfn_tpu.utils.compat import set_mesh  # noqa: E402
from deeplearning_cfn_tpu_torch.models import llama  # noqa: E402
from deeplearning_cfn_tpu_torch.parallel import sharding  # noqa: E402
from deeplearning_cfn_tpu_torch.train import data as torch_data  # noqa: E402
from deeplearning_cfn_tpu_torch.train import trainer as trainer_lib  # noqa: E402
from deeplearning_cfn_tpu_torch.train.checkpoint import Checkpointer  # noqa: E402

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SEQ, STEPS, JOIN_TIMEOUT = 16, 3, 420
TRAIN = dict(optimizer="adamw", learning_rate=1e-3, weight_decay=0.1, grad_clip_norm=1.0,
             log_every=1)
WIDE = dict(vocab_size=256, dim=128, mlp_dim=256, n_heads=4, n_kv_heads=2)
CASES = {  # name: (ranks, mesh, config overrides, trainer overrides, global batch)
    "dp": (2, dict(dp=2), dict(vocab_size=64), dict(strategy="dp"), 4),
    "fsdp": (2, dict(fsdp=2), dict(vocab_size=64), dict(strategy="fsdp"), 4),
    "adafactor_fsdp": (2, dict(fsdp=2), WIDE,
                       dict(strategy="fsdp", optimizer="adafactor", learning_rate=1e-2), 4),
    "moe_dp": (2, dict(dp=2), dict(vocab_size=64, n_experts=4), dict(strategy="dp"), 4),
    "moe_ep": (2, dict(ep=2), dict(vocab_size=64, n_experts=4), dict(strategy="fsdp"), 4),
    "hsdp": (4, dict(dp=2, fsdp=2), dict(vocab_size=64), dict(strategy="fsdp"), 8),
    "tp2": (2, dict(tp=2), dict(vocab_size=64), dict(strategy="fsdp"), 4),
    "tp2_fused": (2, dict(tp=2), dict(vocab_size=64, fused_qkv=True), dict(strategy="fsdp"), 4),
    "sp2": (2, dict(sp=2), dict(vocab_size=64), dict(strategy="dp"), 4),
    "sp2_ring": (2, dict(sp=2), dict(vocab_size=64, n_kv_heads=4, use_ring_attention=True),
                 dict(strategy="dp"), 4),
    "sp2_ring_gqa": (2, dict(sp=2), dict(vocab_size=64, use_ring_attention=True),
                     dict(strategy="dp"), 4),
    "fsdp2_tp2": (4, dict(fsdp=2, tp=2), dict(vocab_size=64), dict(strategy="fsdp"), 8),
    "hybrid_fsdp2_dp2": (4, dict(dp=2, fsdp=2), dict(vocab_size=64), dict(strategy="fsdp"), 8),
}
# Cases on a hybrid mesh: name -> (ICI spec, DCN spec).
HYBRID = {"hybrid_fsdp2_dp2": (dict(fsdp=2), dict(dp=2))}
RING = {"ring_sp2": 2, "ring_sp4": 4}  # name: sp (= ranks)
RING_SHAPE = dict(B=2, S=32, Hq=4, Hkv=2, D=16)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _contract_env(n: int, pid: int, port: int, **extra) -> dict:
    env = dict(os.environ, **extra)
    env.update(DEEPLEARNING_WORKERS_COUNT=str(n), DLCFN_PROCESS_ID=str(pid),
               DEEPLEARNING_COORDINATOR=f"127.0.0.1:{port}", OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO))
    return env


def _spawn(n: int, argv: list[str], **env) -> list[str]:
    """Run ``argv`` as ``n`` processes of one group (``env`` added to their
    environment); their stdouts.  A rank that fails, or a group that
    outlives the join timeout, fails the test."""
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, *argv], env=_contract_env(n, i, port, **env),
                              cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for i in range(n)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=JOIN_TIMEOUT)
            assert p.returncode == 0, f"rank failed:\n{err[-3000:]}"
            outs.append(out)
    except subprocess.TimeoutExpired:
        pytest.fail(f"ranks did not finish within {JOIN_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def _jax_reference(name: str) -> dict:
    """The JAX trainer over the case's mesh: initial weights, batches,
    losses, the first batch's global gradient norm, final weights."""
    n, mesh_kw, cfg_kw, train_kw, batch = CASES[name]
    jcfg = dataclasses.replace(jax_llama.LlamaConfig.tiny(seq_len=SEQ, dtype=jnp.float32), **cfg_kw)
    if name in HYBRID:
        from deeplearning_cfn_tpu.parallel.mesh import build_hybrid_mesh

        ici, dcn = HYBRID[name]
        mesh = build_hybrid_mesh(MeshSpec(**ici), MeshSpec(**dcn), jax.devices()[:n])
    else:
        mesh = build_mesh(MeshSpec(**mesh_kw), jax.devices()[:n])
    cfg = JaxTrainerConfig(**{**TRAIN, **train_kw})
    jtrainer = jax_llama.make_trainer(jcfg, mesh, cfg)
    ds = jax_data.SyntheticTokenDataset(seq_len=SEQ, vocab_size=jcfg.vocab_size, batch_size=batch)
    batches = [(np.asarray(b.x), np.asarray(b.y)) for b in ds.batches(STEPS)]
    state = jtrainer.init(jax.random.key(0), jnp.asarray(batches[0][0]))
    init = jax.device_get(state.params)
    x0, y0 = (jnp.asarray(a) for a in batches[0])
    with set_mesh(mesh):
        grads = jax.jit(jax.grad(
            lambda p: jax_llama.causal_lm_loss(jcfg, p, x0, y0, mesh)[0]))(state.params)
    norm = float(optax.global_norm(grads))
    losses, aux = [], []
    for x, y in batches:
        state, metrics = jtrainer.train_step(
            state, *(jax.device_put(jnp.asarray(a), jtrainer.batch_sharding) for a in (x, y)))
        losses.append(float(metrics["loss"]))
        if "moe_aux_loss" in metrics:
            aux.append(float(metrics["moe_aux_loss"]))
    rank_case = {"mesh": mesh_kw, "cfg": {"max_seq_len": SEQ, **cfg_kw},
                 "trainer": {**TRAIN, **train_kw}, "init": init, "batches": batches}
    if name in HYBRID:
        rank_case["hybrid"] = HYBRID[name]
    return {"rank_case": rank_case, "losses": losses, "aux": aux, "norm": norm,
            "final": jax.device_get(state.params), "lr": cfg.learning_rate}


def _jax_ring_reference(name: str) -> dict:
    """JAX's ``ring_attention`` over ``MeshSpec(sp=n)`` on seeded f32
    inputs: the output and the gradients of q, k, v for a seeded cotangent."""
    from deeplearning_cfn_tpu.parallel.ring_attention import ring_attention

    sp = RING[name]
    B, S, Hq, Hkv, D = RING_SHAPE.values()
    rng = np.random.default_rng(sp)
    q = rng.standard_normal((B, S, Hq, D), dtype=np.float32)
    k, v = (rng.standard_normal((B, S, Hkv, D), dtype=np.float32) for _ in range(2))
    g = rng.standard_normal((B, S, Hq, D), dtype=np.float32)
    mesh = build_mesh(MeshSpec(sp=sp), jax.devices()[:sp])
    with set_mesh(mesh):
        out, vjp = jax.vjp(lambda *a: ring_attention(*a, mesh, causal=True), q, k, v)
        dq, dk, dv = vjp(jnp.asarray(g))
    want = {"out": out, "dq": dq, "dk": dk, "dv": dv}
    return {"rank_case": {"ring": True, "mesh": {"sp": sp}, "q": q, "k": k, "v": v, "g": g},
            "want": {n: np.asarray(a) for n, a in want.items()}}


EXAMPLE_ARGV = ["--size", "tiny", "--device", "cpu", "--seq_len", "32", "--global_batch_size",
                "4", "--steps", "3", "--log_every", "1"]
EXAMPLES = {"example_tp2": ["--tp", "2"], "example_sp2_ring": ["--sp", "2", "--ring_attention"]}


def _example_reference(name: str) -> dict:
    """The example's flags for the ranks, and its single-process run here."""
    from deeplearning_cfn_tpu_torch.examples import llama_train

    out = llama_train.main(EXAMPLE_ARGV)
    return {"rank_case": {"argv": EXAMPLE_ARGV + EXAMPLES[name]},
            "losses": [h["loss"] for h in out["history"]]}


EP_FSDP = ("ep_fsdp_save", "ep_fsdp_restore", "ep_fsdp_straight")
EP_FSDP_CFG = dict(vocab_size=64, n_experts=4)


def _ep_fsdp_reference(name: str, root: Path) -> dict:
    """MoE at ep=2 x fsdp=2 from JAX's initial weights: saved after three
    steps, restored into a state from another seed for two more, or five
    straight."""
    jcfg = dataclasses.replace(jax_llama.LlamaConfig.tiny(seq_len=SEQ, dtype=jnp.float32),
                               **EP_FSDP_CFG)
    init = jax.device_get(jax_llama.init_params(jcfg, jax.random.key(0)))
    ds = jax_data.SyntheticTokenDataset(seq_len=SEQ, vocab_size=64, batch_size=8)
    case = {"mesh": dict(ep=2, fsdp=2), "cfg": {"max_seq_len": SEQ, **EP_FSDP_CFG},
            "trainer": {**TRAIN, "strategy": "fsdp"}, "init": init,
            "batches": [(np.asarray(b.x), np.asarray(b.y)) for b in ds.batches(5)],
            "steps": STEPS, "dir": str(root / "ep_fsdp")}
    if name != "ep_fsdp_straight":
        case["mode"] = name.rsplit("_", 1)[1]
    return {"rank_case": case, "init": init}


def _reference(name: str, root: Path | None = None) -> dict:
    if name in EP_FSDP:
        return _ep_fsdp_reference(name, root)
    if name == "default_mesh_slices":
        return {"rank_case": {"default_mesh": "fsdp", "slices": 2}}
    if name in CASES:
        return _jax_reference(name)
    return _jax_ring_reference(name) if name in RING else _example_reference(name)


def _run_ranks(tmp_path_factory, names: list[str]) -> dict:
    n = CASES[names[0]][0]
    root = tmp_path_factory.mktemp("ranks")
    refs = {name: _reference(name, root) for name in names}
    path = root / "cases.pkl"
    path.write_bytes(pickle.dumps({k: r["rank_case"] for k, r in refs.items()}))
    _spawn(n, [str(REPO / "tests" / "torch_dist_ranks.py"), str(path)])
    ranks = [pickle.loads(Path(f"{path}.rank{i}").read_bytes()) for i in range(n)]
    return {name: (refs[name], [r[name] for r in ranks]) for name in names}


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    return _run_ranks(tmp_path_factory,
                      [k for k, v in CASES.items() if v[0] == 2] + ["ring_sp2", *EXAMPLES])


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return _run_ranks(tmp_path_factory, ["hsdp", "fsdp2_tp2", "ring_sp4", "hybrid_fsdp2_dp2",
                                         *EP_FSDP, "default_mesh_slices"])


def _check(name, ref, ranks):
    from deeplearning_cfn_tpu_torch import interop

    for r in ranks:
        assert r["losses"] == ranks[0]["losses"], "ranks disagree on the global loss"
        np.testing.assert_allclose(r["norm"], ref["norm"], rtol=1e-5)
    np.testing.assert_allclose(ranks[0]["losses"], ref["losses"], rtol=1e-5)
    assert ref["norm"] > TRAIN["grad_clip_norm"]  # the clip is active
    cfg_kw = CASES[name][2]
    tcfg = dataclasses.replace(llama.LlamaConfig.tiny(dtype=torch.float32), **cfg_kw)
    final = interop.llama_params_from_jax(tcfg, ref["final"])
    ep = CASES[name][1].get("ep", 1)
    by_ep = {r["ep_rank"]: r["params"] for r in ranks}
    lr = ref["lr"]
    for pname, want in final.items():
        parts = [by_ep[e][pname] for e in range(ep)]
        got = parts[0] if ep == 1 or ".moe.w_" not in pname else np.concatenate(parts)
        diff = np.abs(got - want.numpy())
        assert diff.max() <= lr * STEPS, (pname, diff.max())
        assert np.mean(diff > 2e-6) <= 1e-3, (pname, diff.max())
    return tcfg


def _check_sharding(tcfg, rank):
    """Every parameter the specs shard is a DTensor sharded on its fsdp dim;
    the ones they replicate (norms, the router) are whole."""
    specs = llama.param_specs(tcfg)
    want = {n: sharding.fsdp_dim(s) for n, s in specs.items() if sharding.fsdp_dim(s) is not None}
    assert {n: dims[-1] for n, dims in rank["sharded"].items()} == want
    assert any(n.endswith("norm") for n in specs if n not in want)


def test_dp_is_ddp_and_matches_jax(two_ranks):
    ref, ranks = two_ranks["dp"]
    _check("dp", ref, ranks)
    assert all(r["ddp"] and not r["sharded"] for r in ranks)


def test_fsdp_shards_on_the_spec_dims_and_matches_jax(two_ranks):
    ref, ranks = two_ranks["fsdp"]
    tcfg = _check("fsdp", ref, ranks)
    _check_sharding(tcfg, ranks[0])


def test_adafactor_under_fsdp_matches_jax(two_ranks):
    ref, ranks = two_ranks["adafactor_fsdp"]
    tcfg = _check("adafactor_fsdp", ref, ranks)
    _check_sharding(tcfg, ranks[0])
    # The widths that make Adafactor factor, with the factored dims sharded.
    assert ranks[0]["sharded"]["embed"] == [1] and ranks[0]["sharded"]["layers.0.wq"] == [0]


def test_moe_two_routing_groups_match_jax(two_ranks):
    ref, ranks = two_ranks["moe_dp"]
    _check("moe_dp", ref, ranks)
    np.testing.assert_allclose(ranks[0]["aux"], ref["aux"], rtol=1e-5)


def test_moe_expert_parallel_matches_jax(two_ranks):
    ref, ranks = two_ranks["moe_ep"]
    _check("moe_ep", ref, ranks)
    np.testing.assert_allclose(ranks[0]["aux"], ref["aux"], rtol=1e-5)
    assert sorted(r["ep_rank"] for r in ranks) == [0, 1]
    assert ranks[0]["params"]["layers.0.moe.w_gate"].shape[0] == 2  # 4 experts over ep=2


def test_hsdp_on_four_ranks_matches_jax(four_ranks):
    ref, ranks = four_ranks["hsdp"]
    tcfg = _check("hsdp", ref, ranks)
    _check_sharding(tcfg, ranks[0])


def _check_tp_sharding(tcfg, ranks):
    """Every parameter whose spec has a tp dim is a DTensor sharded on its
    fsdp dim and on its tp dim (FSDP2 over the tp DTensor); the norms are
    whole; the two tp ranks are both there.  The loss reads each rank's
    half of the vocabulary's logits, and its vocab-parallel nll is the whole
    vocabulary's."""
    specs = llama.param_specs(tcfg)
    want = {n: [sharding.fsdp_dim(s), sharding.tp_dim(s)] for n, s in specs.items()
            if sharding.tp_dim(s) is not None}
    for r in ranks:
        assert r["sharded"] == want
        assert r["loss_logits_width"] == tcfg.vocab_size // 2
        assert r["nll_gap"] <= 1e-5
    assert sorted({r["tp_rank"] for r in ranks}) == [0, 1]


@pytest.mark.parametrize("tp", [2, 4])
def test_interop_cuts_each_tensor_to_a_tp_ranks_share(tp):
    """``llama_params_from_jax(tp_rank=r, tp_size=tp)``: every tensor whose
    spec has a tp dim cut to rank r's contiguous share of it (the ranks'
    shares concatenate to the whole), the others whole."""
    from deeplearning_cfn_tpu_torch import interop

    cfg_kw = dict(vocab_size=64, n_heads=4, n_kv_heads=4)
    jcfg = dataclasses.replace(jax_llama.LlamaConfig.tiny(seq_len=SEQ, dtype=jnp.float32), **cfg_kw)
    tcfg = dataclasses.replace(llama.LlamaConfig.tiny(dtype=torch.float32), **cfg_kw)
    init = jax.device_get(jax_llama.init_params(jcfg, jax.random.key(0)))
    whole = interop.llama_params_from_jax(tcfg, init)
    parts = [interop.llama_params_from_jax(tcfg, init, tp_rank=r, tp_size=tp) for r in range(tp)]
    for name, spec in llama.param_specs(tcfg).items():
        d = sharding.tp_dim(spec)
        if d is None:
            assert all(torch.equal(p[name], whole[name]) for p in parts), name
            continue
        assert parts[0][name].shape[d] * tp == whole[name].shape[d], name
        assert torch.equal(torch.cat([p[name] for p in parts], dim=d), whole[name]), name


@pytest.mark.parametrize("layout", ["moe_ep2_tp2", "kv2_tp4"])
def test_interop_cuts_expert_banks_and_kv_columns_to_a_ranks_share(layout):
    """The layouts the port added to ``test_interop_cuts_each_tensor_to_a_tp_ranks_share``'s:
    the expert banks cut over ep (the expert axis) and then over tp (their
    spec's ``m`` dim), and ``wk``/``wv`` over a tp that does not divide the
    kv heads (each rank a contiguous quarter of 2 heads' columns, half a
    head): the ranks' shares tile the whole tensor, as ``distribute_tp``
    chunks it after ``MoE.shard_experts``."""
    from deeplearning_cfn_tpu_torch import interop

    cfg_kw, ep, tp = ((dict(vocab_size=64, n_experts=4), 2, 2) if layout == "moe_ep2_tp2"
                      else (dict(vocab_size=64), 1, 4))
    jcfg = dataclasses.replace(jax_llama.LlamaConfig.tiny(seq_len=SEQ, dtype=jnp.float32), **cfg_kw)
    tcfg = dataclasses.replace(llama.LlamaConfig.tiny(dtype=torch.float32), **cfg_kw)
    init = jax.device_get(jax_llama.init_params(jcfg, jax.random.key(0)))
    whole = interop.llama_params_from_jax(tcfg, init)
    parts = {(e, t): interop.llama_params_from_jax(tcfg, init, ep_rank=e, ep_size=ep,
                                                   tp_rank=t, tp_size=tp)
             for e in range(ep) for t in range(tp)}
    for name, spec in llama.param_specs(tcfg).items():
        d = sharding.tp_dim(spec)
        split_ep = ep > 1 and sharding.axis_dim(spec, "ep") is not None
        rows = [torch.cat([parts[e, t][name] for t in range(tp)], dim=d) if d is not None
                else parts[e, 0][name] for e in range(ep)]
        got = torch.cat(rows) if split_ep else rows[0]
        assert torch.equal(got, whole[name]), name
        for e in range(ep):
            for t in range(tp):
                want = whole[name].chunk(ep)[e] if split_ep else whole[name]
                if d is not None:
                    want = want.chunk(tp, dim=d)[t]
                assert torch.equal(parts[e, t][name], want), (name, e, t)
    if layout == "kv2_tp4":
        assert parts[0, 0]["layers.0.wk"].shape[1] * 2 == tcfg.head_dim


@pytest.mark.parametrize("name", ["tp2", "tp2_fused"])
def test_tensor_parallel_matches_jax(two_ranks, name):
    ref, ranks = two_ranks[name]
    tcfg = _check(name, ref, ranks)
    _check_tp_sharding(tcfg, ranks)


@pytest.mark.parametrize("name", ["sp2", "sp2_ring", "sp2_ring_gqa"])
def test_sequence_parallel_matches_jax(two_ranks, name):
    """The sequence split over two ranks: k/v gathered over sp, or ring
    attention (compact GQA k/v in ``sp2_ring_gqa``); the loss's count and
    every gradient the whole sequence's."""
    ref, ranks = two_ranks[name]
    _check(name, ref, ranks)
    assert all(r["ddp"] and not r["sharded"] for r in ranks)


def test_fsdp2_tp2_on_four_ranks_matches_jax(four_ranks):
    ref, ranks = four_ranks["fsdp2_tp2"]
    tcfg = _check("fsdp2_tp2", ref, ranks)
    _check_tp_sharding(tcfg, ranks)


def test_llama_on_a_hybrid_mesh_matches_jax(four_ranks):
    """FSDP2 within each node (ICI fsdp=2) and data parallel across the two
    (DCN dp=2): the ranks' grid is JAX's device grid, FSDP2 shards within a
    node, and losses, norm and parameters are held to JAX's on its hybrid
    mesh."""
    from deeplearning_cfn_tpu_torch.parallel.mesh import MeshSpec as TorchMeshSpec
    from deeplearning_cfn_tpu_torch.parallel.mesh import hybrid_rank_grid

    ref, ranks = four_ranks["hybrid_fsdp2_dp2"]
    tcfg = _check("hybrid_fsdp2_dp2", ref, ranks)
    _check_sharding(tcfg, ranks[0])
    ici, dcn = HYBRID["hybrid_fsdp2_dp2"]
    grid = hybrid_rank_grid(TorchMeshSpec(**ici), TorchMeshSpec(**dcn), 4).tolist()
    assert all(r["mesh_grid"] == grid for r in ranks)


def test_default_mesh_takes_the_slice_count(four_ranks):
    """``DEEPLEARNING_SLICES_COUNT=2`` over four ranks: ``default_mesh("fsdp")``
    is JAX's, fsdp=2 within each node and dp=2 across them."""
    _, ranks = four_ranks["default_mesh_slices"]
    for r in ranks:
        assert r["sizes"] == {"dp": 2, "fsdp": 2, "pp": 1, "sp": 1, "tp": 1, "ep": 1}
        assert np.asarray(r["grid"]).reshape(2, 2).tolist() == [[0, 1], [2, 3]]


def test_ep_fsdp_checkpoint_restores_bitwise_with_jax_global_view(four_ranks):
    """Experts split over ep=2 and sharded by FSDP2 over fsdp=2 (a 2-D
    ``DTensor`` in the checkpoint): saved after three steps, restored into a
    state from another seed, two more steps bitwise the five straight; the
    checkpoint's global shapes are JAX's per-layer leaves."""
    from torch.distributed.checkpoint import FileSystemReader

    (ref, saved), (_, restored), (_, straight) = (four_ranks[n] for n in EP_FSDP)
    for s_, r, full in zip(saved, restored, straight):
        assert s_["losses"] + r["losses"] == full["losses"]
        assert r["params"].keys() == full["params"].keys()
        for pname, want in full["params"].items():
            np.testing.assert_array_equal(r["params"][pname], want, err_msg=pname)
    assert sorted({r["ep_rank"] for r in saved}) == [0, 1]
    step_dir = Path(ref["rank_case"]["dir"]) / f"step-{STEPS:08d}"
    meta = FileSystemReader(str(step_dir)).read_metadata().state_dict_metadata
    for leaf, stacked in ref["init"]["layers"]["moe"].items():
        want = tuple(np.asarray(stacked).shape[1:])
        assert tuple(meta[f"model.layers.0.moe.{leaf}"].size) == want, leaf
        if leaf != "router":
            assert tuple(meta[f"optimizer.state.layers.0.moe.{leaf}.exp_avg"].size) == want


@pytest.mark.parametrize("name", list(RING))
def test_ring_attention_and_its_gradients_match_jax(two_ranks, four_ranks, name):
    ref, ranks = (two_ranks if RING[name] == 2 else four_ranks)[name]
    by_rank = sorted(ranks, key=lambda r: r["sp_rank"])
    assert [r["sp_rank"] for r in by_rank] == list(range(RING[name]))
    for key, want in ref["want"].items():
        got = np.concatenate([r[key] for r in by_rank], axis=1)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("name", list(EXAMPLES))
def test_llama_train_flags_over_two_ranks(two_ranks, name):
    """``llama_train --tp 2`` and ``--sp 2 --ring_attention`` as two ranks
    train as the example does in one process, from the same seed and stream
    (the tiny preset is bf16: the ranks sum in another order, so the losses
    agree to 2e-2; the layouts' f32 parity with JAX is held above)."""
    ref, ranks = two_ranks[name]
    axis = EXAMPLES[name][0].removeprefix("--")
    for r in ranks:
        assert r["losses"] == ranks[0]["losses"] and r["mesh"][axis] == 2
    np.testing.assert_allclose(ranks[0]["losses"], ref["losses"], rtol=2e-2)


def test_multiprocess_smoke_llama_fsdp_over_fsdp_and_tp():
    """``DLCFN_SMOKE_MODEL=llama-fsdp`` as four processes: fsdp=2 × tp=2,
    FSDP2's gathers and the tp collectives across the processes."""
    outs = _spawn(4, ["-m", "deeplearning_cfn_tpu_torch.examples.multiprocess_smoke",
                      "--device", "cpu"], DLCFN_SMOKE_MODEL="llama-fsdp", DLCFN_SMOKE_STEPS="6")
    results = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    assert [r["process_id"] for r in results] == [0, 1, 2, 3]
    for r in results:
        assert r["model"] == "llama-fsdp" and r["mesh"]["fsdp"] == 2 and r["mesh"]["tp"] == 2
        assert r["losses"] == results[0]["losses"]
    losses = results[0]["losses"]
    assert np.isfinite(losses).all() and losses[-1] < 0.5 * losses[0], losses


def test_multiprocess_smoke_lenet_from_the_env_contract():
    outs = _spawn(2, ["-m", "deeplearning_cfn_tpu_torch.examples.multiprocess_smoke",
                      "--device", "cpu"])
    results = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    assert [r["process_id"] for r in results] == [0, 1]
    assert all(r["processes"] == 2 and r["model"] == "lenet" for r in results)
    assert results[0]["losses"] == results[1]["losses"]
    losses = results[0]["losses"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


# --- restores across a topology change ---------------------------------------

SAVED_STEPS, CKPT_STEPS = 3, 5
CKPT_CASES = {  # name: (config, trainer overrides, saved on, restored on: None = one rank)
    "fsdp_to_one": (dict(vocab_size=64), dict(strategy="fsdp"), dict(fsdp=2), None),
    "lamb_fsdp_to_one": (dict(vocab_size=64), dict(strategy="fsdp", optimizer="lamb"),
                         dict(fsdp=2), None),
    "adafactor_fsdp_to_one": (WIDE, dict(strategy="fsdp", optimizer="adafactor",
                                         learning_rate=1e-2), dict(fsdp=2), None),
    "moe_ep_to_one": (dict(vocab_size=64, n_experts=4), dict(strategy="fsdp"), dict(ep=2), None),
    "dp_to_fsdp": (dict(vocab_size=64), dict(strategy="dp"), dict(dp=2), dict(fsdp=2)),
}


def _ckpt_case(name, root, mode):
    cfg_kw, train_kw, saved_on, restored_on = CKPT_CASES[name]
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(seq_len=SEQ, dtype=torch.float32), **cfg_kw)
    init = {k: v.numpy() for k, v in llama.Llama(cfg, torch.Generator().manual_seed(0))
            .state_dict().items()}
    ds = torch_data.SyntheticTokenDataset(seq_len=SEQ, vocab_size=cfg.vocab_size, batch_size=4)
    trainer_kw = {**TRAIN, **train_kw}
    if mode == "restore":
        trainer_kw["strategy"] = "fsdp"
    return {"mesh": saved_on if mode == "save" else restored_on, "mode": mode, "torch_init": True,
            "cfg": {"max_seq_len": SEQ, **cfg_kw}, "trainer": trainer_kw, "init": init,
            "batches": [(b.x, b.y) for b in ds.batches(CKPT_STEPS)], "steps": SAVED_STEPS,
            "dir": str(root / name)}


def _spawn_cases(tmp_path_factory, cases: dict) -> list[dict]:
    path = tmp_path_factory.mktemp("ckpt-ranks") / "cases.pkl"
    path.write_bytes(pickle.dumps(cases))
    _spawn(2, [str(REPO / "tests" / "torch_dist_ranks.py"), str(path)])
    return [pickle.loads(Path(f"{path}.rank{i}").read_bytes()) for i in range(2)]


@pytest.fixture(scope="module")
def topology_restores(tmp_path_factory):
    """Every case saved on its mesh (one spawn), then restored: on two ranks
    (a second spawn) or here on one."""
    root = tmp_path_factory.mktemp("ckpts")
    saved = _spawn_cases(tmp_path_factory, {n: _ckpt_case(n, root, "save") for n in CKPT_CASES})
    on_two = [n for n, c in CKPT_CASES.items() if c[3] is not None]
    restored = _spawn_cases(tmp_path_factory,
                            {n: _ckpt_case(n, root, "restore") for n in on_two})
    out = {}
    for name, (cfg_kw, train_kw, saved_on, restored_on) in CKPT_CASES.items():
        case = _ckpt_case(name, root, "restore")
        cfg = dataclasses.replace(llama.LlamaConfig.tiny(dtype=torch.float32), **cfg_kw)
        weights = {k: torch.from_numpy(v) for k, v in case["init"].items()}

        def make(seed, weights=weights, cfg=cfg, case=case):
            def model_fn(generator):
                model = llama.Llama(cfg, generator)
                if weights is not None:
                    model.load_state_dict(weights)
                return model

            t = trainer_lib.Trainer(model_fn, trainer_lib.TrainerConfig(**case["trainer"]),
                                    loss_fn=llama.causal_lm_loss, device="cpu")
            return t, t.init(seed=seed)

        t, state = make(0)  # the uninterrupted single-rank run
        straight = []
        for x, y in case["batches"]:
            state, metrics = t.train_step(state, torch.from_numpy(x), torch.from_numpy(y))
            straight.append(float(metrics["loss"]))
        ref = {n: p.detach().numpy() for n, p in state.model.named_parameters()}
        if restored_on is None:
            t, state = make(1, weights=None)
            _, step = Checkpointer(case["dir"]).restore_latest(state)
            assert step == SAVED_STEPS
            after = []
            for x, y in case["batches"][SAVED_STEPS:]:
                state, metrics = t.train_step(state, torch.from_numpy(x), torch.from_numpy(y))
                after.append(float(metrics["loss"]))
            ends = [{"losses": after, "params": {n: p.detach().numpy()
                                                 for n, p in state.model.named_parameters()}}]
        else:
            ends = [r[name] for r in restored]
        out[name] = {"saved": [r[name] for r in saved], "ends": ends, "straight": straight,
                     "ref": ref, "lr": case["trainer"]["learning_rate"]}
    return out


@pytest.mark.parametrize("name", list(CKPT_CASES))
def test_restore_across_a_topology_change_continues_the_single_rank_run(topology_restores, name):
    got = topology_restores[name]
    saved_on, restored_on = CKPT_CASES[name][2:]
    for r in got["saved"]:
        assert r["topology"] == jax_mesh_topology(build_mesh(MeshSpec(**saved_on),
                                                             jax.devices()[:2]))
    for end in got["ends"]:
        np.testing.assert_allclose(got["saved"][0]["losses"] + end["losses"], got["straight"],
                                   rtol=1e-5)
        lr = got["lr"]
        for pname, want in got["ref"].items():
            diff = np.abs(end["params"][pname] - want)
            assert diff.max() <= lr * CKPT_STEPS, (pname, diff.max())
            assert np.mean(diff > 2e-6) <= 1e-3, (pname, diff.max())
    if restored_on is not None:
        assert got["ends"][0]["topology"] == {"devices": 2, "axes": {"fsdp": 2}}


# --- the batch's reductions over the data ranks ------------------------------
#
# JAX's dp step is one GSPMD program over the global batch: BatchNorm's
# statistics and the counts that losses divide by are the whole batch's.  The
# port runs each rank's shard and averages gradients and metrics, so it
# reduces those over the data ranks (``parallel/data_ranks.py``).  Each case
# runs three steps at dp=2 from the JAX weights on batches whose halves
# differ (other statistics, other counts a rank) and holds every step's
# metrics to 1e-5 relative and the final parameters and running statistics to
# 1e-5 absolute (the single-rank trainer tests' tolerance), on both ranks.

MODEL_STEPS = 3
RESNET = dict(stage_sizes=(1, 1), num_filters=8, num_classes=10)
DET = dict(num_classes=4, backbone_stages=(1, 1, 1, 1), fpn_channels=32, with_masks=True)


def _put(jtrainer, tree):
    return jax.tree_util.tree_map(
        lambda a: jax.device_put(jnp.asarray(a), jtrainer.batch_sharding), tree)


def _jax_model_reference(name: str) -> dict:
    """The JAX trainer at ``MeshSpec(dp=2)``: the rank case (the port's state
    dict from the JAX initial weights, the batches), every step's metrics,
    and the final state as the port's state dict (numpy)."""
    from deeplearning_cfn_tpu.models import bert as jax_bert
    from deeplearning_cfn_tpu.models import resnet as jax_resnet
    from deeplearning_cfn_tpu.models import retinanet as jax_retinanet
    from deeplearning_cfn_tpu.train.trainer import Trainer as JaxTrainer
    from deeplearning_cfn_tpu_torch import interop
    from deeplearning_cfn_tpu_torch.models import bert

    mesh = build_mesh(MeshSpec(dp=2), jax.devices()[:2])
    case = {"model": name, "mesh": {"dp": 2}}
    kw = dict(loss_fn=None, stateful_loss_fn=None)
    if name == "resnet":
        ds = jax_data.SyntheticDataset(shape=(32, 32, 3), num_classes=10, batch_size=8,
                                       dtype="uint8")
        cfg = dict(strategy="dp", learning_rate=0.1, has_train_arg=True, label_smoothing=0.1,
                   weight_decay=1e-4, input_stats=ds.input_stats, log_every=1)
        model, case["arch"] = jax_resnet.ResNet(**RESNET), RESNET

        def convert(v):
            return interop.resnet_params_from_jax(v["params"], v["batch_stats"])
    elif name == "bert":
        arch = dict(vocab_size=64, seq_len=SEQ)
        ds = jax_data.SyntheticMLMDataset(seq_len=SEQ, vocab_size=64, batch_size=4)
        cfg = dict(strategy="dp", optimizer="momentum", learning_rate=0.1, log_every=1)
        model, case["arch"] = jax_bert.BertEncoder(jax_bert.BertConfig.tiny(**arch)), arch
        kw["loss_fn"] = jax_bert.mlm_loss(model)

        def convert(v):
            return interop.bert_params_from_jax(bert.BertConfig.tiny(**arch), v["params"])
    else:
        size = case["image_size"] = 64
        ds = jax_data.SyntheticDetectionDataset(image_size=size, num_classes=4, max_boxes=3,
                                                batch_size=4, with_masks=True)
        cfg = dict(strategy="dp", learning_rate=0.01, has_train_arg=True, grad_clip_norm=10.0,
                   log_every=1)
        model, case["arch"] = jax_retinanet.RetinaNet(**DET), DET
        anchors = jnp.asarray(jax_retinanet.generate_anchors(size))

        def loss(params, model_state, x, y):
            outputs, new_state = model.apply({"params": params, **model_state}, x, train=True,
                                             mutable=list(model_state))
            out = jax_retinanet.detection_loss_with_masks(
                *outputs, anchors, y["boxes"], y["classes"], y["masks"], DET["num_classes"])
            return out[0], (out[1], new_state)

        kw["stateful_loss_fn"] = loss

        def convert(v):
            return interop.retinanet_params_from_jax(v["params"], v["batch_stats"])
    jt = JaxTrainer(model, mesh, JaxTrainerConfig(**cfg),
                    **{k: v for k, v in kw.items() if v is not None})
    batches = [(b.x, b.y) for b in ds.batches(MODEL_STEPS)]
    state = jt.init(jax.random.key(0), jnp.asarray(batches[0][0]))

    def as_state_dict(state):
        v = jax.device_get({"params": state.params, **state.model_state})
        return {k: t.numpy() for k, t in convert(v).items()}

    case.update(trainer=cfg, init=as_state_dict(state), batches=batches)
    metrics = []
    for x, y in batches:
        state, m = jt.train_step(state, _put(jt, x), _put(jt, y))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"rank_case": case, "metrics": metrics, "final": as_state_dict(state)}


@pytest.fixture(scope="module")
def model_ranks(tmp_path_factory):
    refs = {name: _jax_model_reference(name) for name in ("resnet", "bert", "retinanet")}
    path = tmp_path_factory.mktemp("model-ranks") / "cases.pkl"
    path.write_bytes(pickle.dumps({k: r["rank_case"] for k, r in refs.items()}))
    _spawn(2, [str(REPO / "tests" / "torch_dist_ranks.py"), str(path)])
    ranks = [pickle.loads(Path(f"{path}.rank{i}").read_bytes()) for i in range(2)]
    return {name: (refs[name], [r[name] for r in ranks]) for name in refs}


def _check_model_case(ref, ranks):
    for r in ranks:
        assert r["ddp"]
        assert len(r["metrics"]) == MODEL_STEPS
        for got, want in zip(r["metrics"], ref["metrics"]):
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
        assert set(r["state"]) == set(ref["final"])
        for k, want in ref["final"].items():
            np.testing.assert_allclose(r["state"][k], want, rtol=0, atol=1e-5, err_msg=k)


def test_batchnorm_statistics_are_the_global_batchs_over_dp_ranks(model_ranks):
    """ResNet at dp=2: the normalisation and the running statistics of every
    BatchNorm are the global batch's, equal on both ranks (not rank 0's)."""
    ref, ranks = model_ranks["resnet"]
    _check_model_case(ref, ranks)
    stats = [k for k in ref["final"] if k.endswith((".mean", ".var"))]
    assert stats and all(np.array_equal(ranks[0]["state"][k], ranks[1]["state"][k])
                         for k in stats)


def test_mlm_loss_divides_by_the_global_masked_count_over_dp_ranks(model_ranks):
    """BERT at dp=2 with another masked count on each rank: the loss, the
    masked accuracy and the gradient are the global batch's quotients."""
    ref, ranks = model_ranks["bert"]
    counts = [[int((y[:2] >= 0).sum()), int((y[2:] >= 0).sum())]
              for _, y in ref["rank_case"]["batches"]]
    assert any(a != b for a, b in counts), counts
    _check_model_case(ref, ranks)


def test_retinanet_with_masks_over_dp_ranks_matches_jax(model_ranks):
    """Tiny RetinaNet with masks at dp=2: the backbone's BatchNorm and the
    positive-anchor and mask-slot counts over both ranks, as JAX's."""
    ref, ranks = model_ranks["retinanet"]
    _check_model_case(ref, ranks)
    assert all(m["num_pos"] > 1 and m["mask_slots"] > 1 for m in ref["metrics"])
