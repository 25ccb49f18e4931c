"""Pipeline stages in the port (``parallel/pipeline.py``, ``pp_stages`` in
``models/llama.py``) against the JAX package's (``tests/test_pipeline.py``).

JAX runs its pipelined programs on the conftest's virtual CPU devices over
the same ``MeshSpec``; the port runs GPipe on spawned gloo ranks
(``tests/torch_dist_ranks.py``) on the same numpy inputs and weights, each
rank loading its stage from JAX's stage-stacked tree through ``interop``.

- Stacking is a pure reshape (numpy and torch, against JAX's
  ``stack_stages``), and the refusals are JAX's: a layer count or a batch
  that does not split, a stage count that is not the mesh's ``pp``, ring
  attention with stages.
- A tanh stack at pp=2 (two ranks): the output and every stage's weight
  gradient against JAX's ``pipeline_apply`` (``atol 1e-4``, JAX's own
  against its sequential stack); the aux, summed over the stages and
  averaged over the microbatches, with the bubble ticks left out.
- The tiny Llama (f32) at pp=2 on two ranks, and at pp=2 x dp=2 and
  pp=2 x tp=2 on four: logits and every gradient of the first batch within
  ``atol 1e-4`` of JAX's pipelined forward and loss, the eval step's loss
  to ``rtol 1e-5``; three AdamW steps, the losses to
  ``rtol 1e-5`` and the final parameters as ``test_torch_distributed.py``
  holds them; the tied embedding's two copies (stage 0's and the last
  stage's) bitwise equal after the steps.  With MoE at pp=2 the aux at
  JAX's scale (``rtol 1e-4`` of JAX's pipelined aux).  pp=2 x fsdp=2 learns
  (JAX's ``test_llama_pp_trainer_learns``) and follows JAX's losses to
  ``rtol 1e-4``.
- A pp=2 DCP checkpoint restores into the same layout and continues
  bitwise; its global view holds every layer once, JAX's stage-stacked
  tree after ``stack_stages``.
- ``llama_train --pp 2`` as two ranks trains as one process does on the
  same stream (bf16: ``rtol 2e-2``).
- Without a pp axis the stage-stacked model runs its layers in sequence:
  bitwise the unstaged model, and JAX's fallback to ``atol 1e-5``.
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
import pytest

torch = pytest.importorskip("torch")

from deeplearning_cfn_tpu.models import llama as jax_llama  # noqa: E402
from deeplearning_cfn_tpu.parallel import pipeline as jax_pipeline  # noqa: E402
from deeplearning_cfn_tpu.parallel.mesh import MeshSpec, build_mesh  # noqa: E402
from deeplearning_cfn_tpu.train import data as jax_data  # noqa: E402
from deeplearning_cfn_tpu.train.trainer import TrainerConfig as JaxTrainerConfig  # noqa: E402
from deeplearning_cfn_tpu.utils.compat import set_mesh  # noqa: E402
from deeplearning_cfn_tpu_torch import interop  # noqa: E402
from deeplearning_cfn_tpu_torch.models import llama  # noqa: E402
from deeplearning_cfn_tpu_torch.parallel import pipeline, sharding  # noqa: E402

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SEQ, STEPS, JOIN_TIMEOUT = 16, 3, 420
TRAIN = dict(optimizer="adamw", learning_rate=1e-3, weight_decay=0.1, grad_clip_norm=1.0,
             log_every=1)
PP = dict(vocab_size=64, pp_stages=2, pp_microbatches=2)
CASES = {  # name: (ranks, mesh, config overrides, trainer overrides, global batch)
    "pp2": (2, dict(pp=2), PP, dict(strategy="dp"), 4),
    "pp2_moe": (2, dict(pp=2), dict(PP, n_experts=4, moe_capacity_factor=4.0, pp_microbatches=4),
                dict(strategy="dp"), 8),
    "pp2_dp2": (4, dict(dp=2, pp=2), PP, dict(strategy="dp"), 8),
    "pp2_fsdp2": (4, dict(fsdp=2, pp=2), dict(PP, vocab_size=32), dict(strategy="fsdp"), 8),
    "pp2_tp2": (4, dict(pp=2, tp=2), PP, dict(strategy="fsdp"), 4),
}
TOY = {"toy": False, "toy_aux": True}  # name: the stages carry an aux
CKPT = ("pp_save", "pp_restore", "pp_straight")
EXAMPLE_ARGV = ["--size", "tiny", "--device", "cpu", "--seq_len", "32", "--global_batch_size",
                "4", "--steps", "3", "--log_every", "1"]


# --- spawning ----------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(n: int, path: Path) -> list[dict]:
    """``torch_dist_ranks.py`` on ``path`` as ``n`` processes of one gloo
    group; each rank's results."""
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


# --- JAX references --------------------------------------------------------------


def _toy(L=8, D=16, seed=0):
    rng = np.random.default_rng(seed)
    W = (rng.standard_normal((L, D, D)) * 0.1).astype(np.float32)
    x = rng.standard_normal((8, D)).astype(np.float32)
    return W, x


def _jax_toy(name: str) -> dict:
    aux = TOY[name]
    mesh = build_mesh(MeshSpec(pp=2), jax.devices()[:2])
    W, x = _toy()
    Ws = jax_pipeline.stack_stages(jnp.asarray(W), 2)

    def stage_fn(lw, act):
        def body(a, w):
            return jnp.tanh(a @ w), None

        out, _ = jax.lax.scan(body, act, lw)
        return out, (jnp.sum(out) if aux else jnp.zeros((), jnp.float32))

    def pipe(Ws, x):
        return jax_pipeline.pipeline_apply(stage_fn, Ws, x, mesh, n_microbatches=4)

    with set_mesh(mesh):
        out, jaux = jax.jit(pipe)(Ws, jnp.asarray(x))
        grad = jax.jit(jax.grad(lambda Ws: pipe(Ws, jnp.asarray(x))[0].sum()))(Ws)
    return {"rank_case": {"toy_pipeline": True, "mesh": {"pp": 2}, "W": np.asarray(Ws), "x": x,
                          "M": 4, "aux": aux},
            "out": np.asarray(out), "aux": float(jaux), "grad": np.asarray(grad)}


def _jcfg(cfg_kw: dict):
    return dataclasses.replace(jax_llama.LlamaConfig.tiny(seq_len=SEQ, dtype=jnp.float32), **cfg_kw)


def _tcfg(cfg_kw: dict):
    return dataclasses.replace(llama.LlamaConfig.tiny(seq_len=SEQ, dtype=torch.float32), **cfg_kw)


def _jax_llama(name: str) -> dict:
    """JAX's pipelined Llama over the case's mesh: logits and gradients of
    the first batch, three trainer steps, the final weights."""
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
        logits = jax.jit(lambda p: jax_llama.forward(jcfg, p, x0, mesh))(state.params)
        loss0, grads = jax.jit(jax.value_and_grad(
            lambda p: jax_llama.causal_lm_loss(jcfg, p, x0, y0, mesh)[0]))(state.params)
    losses, aux = [], []
    for x, y in batches:
        state, metrics = jtrainer.train_step(
            state, *(jax.device_put(jnp.asarray(a), jtrainer.batch_sharding) for a in (x, y)))
        losses.append(float(metrics["loss"]))
        if "moe_aux_loss" in metrics:
            aux.append(float(metrics["moe_aux_loss"]))
    rank_case = {"mesh": mesh_kw, "cfg": {"max_seq_len": SEQ, **cfg_kw},
                 "trainer": {**TRAIN, **train_kw}, "init": init, "batches": batches,
                 "logits": True, "grads": True}
    return {"rank_case": rank_case, "losses": losses, "aux": aux, "init": init,
            "logits": np.asarray(logits), "grads": jax.device_get(grads), "loss0": float(loss0),
            "final": jax.device_get(state.params)}


def _ckpt_case(name: str, root: Path) -> dict:
    cfg_kw = PP
    ds = jax_data.SyntheticTokenDataset(seq_len=SEQ, vocab_size=64, batch_size=4)
    init = jax.device_get(jax_llama.init_params(_jcfg(cfg_kw), jax.random.key(0)))
    case = {"mesh": {"pp": 2}, "cfg": {"max_seq_len": SEQ, **cfg_kw},
            "trainer": {**TRAIN, "strategy": "dp"}, "init": init,
            "batches": [(np.asarray(b.x), np.asarray(b.y)) for b in ds.batches(5)],
            "steps": STEPS, "dir": str(root / "pp")}
    if name == "pp_straight":
        return case
    return {**case, "mode": name.removeprefix("pp_")}


# --- fixtures -------------------------------------------------------------------


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("pp-two")
    refs = {name: _jax_toy(name) for name in TOY}
    refs.update({name: _jax_llama(name) for name in ("pp2", "pp2_moe")})
    cases = {name: r["rank_case"] for name, r in refs.items()}
    cases.update({name: _ckpt_case(name, root) for name in CKPT})
    cases["example"] = {"argv": EXAMPLE_ARGV + ["--pp", "2"]}
    path = root / "cases.pkl"
    path.write_bytes(pickle.dumps(cases))
    ranks = _spawn(2, path)
    return {name: (refs.get(name), [r[name] for r in ranks]) for name in cases}, root


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    refs = {name: _jax_llama(name) for name in ("pp2_dp2", "pp2_fsdp2", "pp2_tp2")}
    path = tmp_path_factory.mktemp("pp-four") / "cases.pkl"
    path.write_bytes(pickle.dumps({name: r["rank_case"] for name, r in refs.items()}))
    ranks = _spawn(4, path)
    return {name: (refs[name], [r[name] for r in ranks]) for name in refs}


# --- without ranks ----------------------------------------------------------------


def test_stage_stacking_is_a_pure_reshape():
    W, _ = _toy()
    want = np.asarray(jax_pipeline.stack_stages(jnp.asarray(W), 4))
    np.testing.assert_array_equal(pipeline.stack_stages(W, 4), want)
    np.testing.assert_array_equal(pipeline.stack_stages(torch.from_numpy(W), 4).numpy(), want)
    np.testing.assert_array_equal(pipeline.unstack_stages(want), W)
    tree = {"a": W, "b": {"c": W[:, 0]}}
    np.testing.assert_array_equal(pipeline.stack_stages(tree, 2)["b"]["c"], W[:, 0].reshape(2, 4, 16))
    assert list(pipeline.stage_layers(8, 4, 2)) == [4, 5]
    assert pipeline.stage_specs({"wq": ("fsdp", "tp")}) == {"wq": ("pp", "fsdp", "tp")}
    assert sharding.DEFAULT_RULES["stage"] == "pp"


def test_interop_unstacks_jax_stage_stacked_weights():
    """JAX's stage-stacked tree converts to the unstaged tree's state dict,
    whole, and cut to each pp rank's stage (the two stages' names partition
    the blocks)."""
    jcfg = _jcfg(dict(PP, n_layers=4))
    tcfg = _tcfg(dict(PP, n_layers=4))
    staged = jax.device_get(jax_llama.init_params(jcfg, jax.random.key(0)))
    flat = jax.device_get(jax_llama.init_params(dataclasses.replace(jcfg, pp_stages=1),
                                                jax.random.key(0)))
    np.testing.assert_array_equal(staged["layers"]["wq"].reshape(flat["layers"]["wq"].shape),
                                  flat["layers"]["wq"])
    whole = interop.llama_params_from_jax(tcfg, staged)
    ref = interop.llama_params_from_jax(dataclasses.replace(tcfg, pp_stages=1), flat)
    assert whole.keys() == ref.keys() and all(torch.equal(whole[k], ref[k]) for k in ref)
    parts = [interop.llama_params_from_jax(tcfg, staged, pp_rank=r, pp_size=2) for r in range(2)]
    blocks = [{k for k in p if k.startswith("layers.")} for p in parts]
    assert blocks[0] | blocks[1] == {k for k in ref if k.startswith("layers.")}
    assert not blocks[0] & blocks[1] and "layers.0.wq" in blocks[0] and "layers.3.wq" in blocks[1]
    assert all(torch.equal(parts[1][k], ref[k]) for k in parts[1])


def test_microbatch_and_stacking_validation():
    W, x = _toy()
    with pytest.raises(pipeline.PipelineError):
        pipeline.microbatch(torch.from_numpy(x), 3)  # 8 % 3 != 0
    with pytest.raises(pipeline.PipelineError):
        pipeline.stack_stages(W, 3)  # 8 layers % 3 != 0
    assert tuple(pipeline.microbatch(torch.from_numpy(x), 4).shape) == (4, 2, 16)


class _StubMesh:
    """The parts of a ``DeviceMesh`` the stage-count check reads."""

    mesh_dim_names = ("dp", "fsdp", "pp", "sp", "tp", "ep")

    def __init__(self, pp: int):
        self.pp = pp

    def size(self, dim: int) -> int:
        return self.pp if self.mesh_dim_names[dim] == "pp" else 1


def test_stage_count_must_match_mesh_pp():
    """4 stages on a pp=2 mesh, and any pipeline on a pp=1 mesh, are refused
    before anything runs (JAX: 'stages'; 'need > 1')."""
    W, x = _toy()
    with pytest.raises(pipeline.PipelineError, match="stages"):
        pipeline.pipeline_apply(torch.nn.Identity(), torch.from_numpy(x), _StubMesh(2), 4,
                                n_stages=4)
    with pytest.raises(pipeline.PipelineError, match="need > 1"):
        pipeline.pipeline_apply(torch.nn.Identity(), torch.from_numpy(x), _StubMesh(1), 4,
                                n_stages=1)


def test_llama_pp_config_validation():
    with pytest.raises(ValueError):
        llama.LlamaConfig.tiny(pp_stages=3)  # 2 layers % 3
    with pytest.raises(ValueError, match="ring attention"):
        dataclasses.replace(llama.LlamaConfig.tiny(), pp_stages=2, use_ring_attention=True)
    with pytest.raises(ValueError):
        llama.LlamaConfig.tiny_moe(n_experts=1)  # default top_k=2 > 1
    for kw in (dict(pp_stages=3), dict(pp_stages=2, use_ring_attention=True)):
        with pytest.raises(ValueError):
            dataclasses.replace(jax_llama.LlamaConfig.tiny(), **kw)


def test_llama_pp_without_pp_mesh_falls_back():
    """Stage-stacked weights without a pp axis run the layers in sequence:
    bitwise the unstaged model, and JAX's fallback to 1e-5."""
    cfg_kw = dict(vocab_size=32, pp_stages=2)
    jcfg, tcfg = _jcfg(cfg_kw), _tcfg(cfg_kw)
    params = jax.device_get(jax_llama.init_params(jcfg, jax.random.key(0)))
    tokens = np.random.default_rng(0).integers(0, 32, size=(2, SEQ)).astype(np.int32)
    want = np.asarray(jax_llama.forward(jcfg, params, jnp.asarray(tokens)))
    staged = llama.Llama(tcfg)
    staged.load_state_dict(interop.llama_params_from_jax(tcfg, params))
    flat = llama.Llama(dataclasses.replace(tcfg, pp_stages=1))
    flat.load_state_dict(staged.state_dict())
    t = torch.from_numpy(tokens)
    with torch.no_grad():
        got = llama.forward(staged, t)
        torch.testing.assert_close(got, llama.forward(flat, t), rtol=0, atol=0)
    assert not staged.pipelined and got.shape == (2, SEQ, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


# --- two ranks ----------------------------------------------------------------------


@pytest.mark.parametrize("name", list(TOY))
def test_pipeline_matches_jax_forward_and_grad(two_ranks, name):
    """The tanh stack at pp=2, M=4: the output on both ranks, the aux
    (bubble ticks left out, averaged over M) and each stage's gradient."""
    ref, ranks = two_ranks[0][name]
    by_stage = sorted(ranks, key=lambda r: r["pp_rank"])
    for r in by_stage:
        np.testing.assert_allclose(r["out"], ref["out"], atol=1e-5)
        np.testing.assert_allclose(r["aux"], ref["aux"], rtol=1e-4)
        if not TOY[name]:
            np.testing.assert_allclose(r["grad"], ref["grad"][r["pp_rank"]], atol=1e-4)
    if TOY[name]:
        assert ref["aux"] != 0.0


def _merged(ranks, key):
    """A per-rank dict of tensors by name, merged over the pp ranks (a
    block from the rank that holds it)."""
    out = {}
    for r in ranks:
        out.update(r[key])
    return out


def _check_llama(name, ref, ranks):
    tcfg = _tcfg(CASES[name][2])
    for r in ranks:
        assert r["losses"] == ranks[0]["losses"], "ranks disagree on the global loss"
        n, i = r["logits"].shape[0], r["data_index"]  # this data shard's rows
        np.testing.assert_allclose(r["logits"], ref["logits"][i * n:(i + 1) * n], atol=1e-4)
        # The eval step (GPipe forward only, the loss on the last stage).
        np.testing.assert_allclose(r["eval_loss"], ref["loss0"], rtol=1e-5)
    grads = interop.llama_params_from_jax(tcfg, ref["grads"])
    got = _merged(ranks, "grads")
    assert got.keys() == grads.keys()
    for pname, want in grads.items():
        np.testing.assert_allclose(got[pname], want.numpy(), atol=1e-4, err_msg=pname)
    np.testing.assert_allclose(ranks[0]["losses"], ref["losses"], rtol=1e-5)
    final = interop.llama_params_from_jax(tcfg, ref["final"])
    params = _merged(ranks, "params")
    lr = TRAIN["learning_rate"]
    for pname, want in final.items():
        diff = np.abs(params[pname] - want.numpy())
        assert diff.max() <= lr * STEPS, (pname, diff.max())
        assert np.mean(diff > 2e-6) <= 1e-3, (pname, diff.max())
    # The tied embedding and the other replicated parameters: every pp rank's
    # copy bitwise the others'.
    for r in ranks:
        for pname in ("embed", "final_norm"):
            np.testing.assert_array_equal(r["params"][pname], ranks[0]["params"][pname])
    return tcfg


def test_llama_pp2_matches_jax_pipelined_forward_grads_and_steps(two_ranks):
    ref, ranks = two_ranks[0]["pp2"]
    _check_llama("pp2", ref, ranks)
    assert sorted(r["pp_rank"] for r in ranks) == [0, 1]
    # Each rank holds its stage's block only.
    assert [sorted(k for k in r["params"] if k.startswith("layers.0.")) != []
            for r in sorted(ranks, key=lambda r: r["pp_rank"])] == [True, False]


def test_llama_pp_moe_aux_scale_matches_jax(two_ranks):
    """The MoE balancing aux under GPipe (4 microbatches) at JAX's scale: its
    per-step value against JAX's pipelined trainer's, not M times it."""
    ref, ranks = two_ranks[0]["pp2_moe"]
    for r in ranks:
        np.testing.assert_allclose(r["aux"], ref["aux"], rtol=1e-4)
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=1e-5)


def test_pp_checkpoint_restores_the_stage_layout_and_continues_bitwise(two_ranks):
    (cases, root) = two_ranks
    saved, restored, straight = (cases[n][1] for n in CKPT)
    for s, r, full in zip(saved, restored, straight):
        assert s["losses"] + r["losses"] == full["losses"]
        for pname, want in full["params"].items():
            np.testing.assert_array_equal(r["params"][pname], want, err_msg=pname)
    # The global view: every layer once, under its global index, at JAX's
    # per-layer shape; stacking them is JAX's stage-stacked tree.
    from torch.distributed.checkpoint import FileSystemReader

    step_dir = root / "pp" / f"step-{STEPS:08d}"
    meta = FileSystemReader(str(step_dir)).read_metadata().state_dict_metadata
    tcfg = _tcfg(PP)
    jinit = jax.device_get(jax_llama.init_params(_jcfg(PP), jax.random.key(0)))
    for leaf, stacked in jinit["layers"].items():
        shapes = [tuple(meta[f"model.layers.{i}.{leaf}"].size) for i in range(tcfg.n_layers)]
        assert [(tcfg.pp_stages, tcfg.n_layers // tcfg.pp_stages, *shapes[0])] == \
            [tuple(np.asarray(stacked).shape)], leaf
    assert not any(k.startswith("model.layers.2.") for k in meta)


def test_llama_train_pp_flag_over_two_ranks(two_ranks):
    """``llama_train --pp 2`` as two ranks trains as one process does from
    the same seed and stream (the tiny preset is bf16: rtol 2e-2)."""
    from deeplearning_cfn_tpu_torch.examples import llama_train

    _, ranks = two_ranks[0]["example"]
    want = [h["loss"] for h in llama_train.main(EXAMPLE_ARGV)["history"]]
    for r in ranks:
        assert r["losses"] == ranks[0]["losses"] and r["mesh"]["pp"] == 2
    np.testing.assert_allclose(ranks[0]["losses"], want, rtol=2e-2)


# --- four ranks ------------------------------------------------------------------------


def test_llama_pp2_dp2_matches_jax(four_ranks):
    ref, ranks = four_ranks["pp2_dp2"]
    _check_llama("pp2_dp2", ref, ranks)


def test_llama_pp2_tp2_matches_jax(four_ranks):
    """Stages of tp-split blocks: the vocab-parallel lookup on stage 0, the
    vocab-parallel loss on the last stage."""
    ref, ranks = four_ranks["pp2_tp2"]
    _check_llama("pp2_tp2", ref, ranks)
    assert sorted({(r["pp_rank"], r["tp_rank"]) for r in ranks}) == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_llama_pp_trainer_learns(four_ranks):
    """pp=2 x fsdp=2: FSDP2 shards each stage's blocks over its data ranks;
    the losses fall and follow JAX's."""
    ref, ranks = four_ranks["pp2_fsdp2"]
    losses = ranks[0]["losses"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    for r in ranks:
        assert r["losses"] == losses
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-4)
    assert any(r["sharded"] for r in ranks)
