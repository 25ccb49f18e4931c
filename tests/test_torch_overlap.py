"""The port's bucketed gradient sync (``parallel/overlap.py`` and
``TrainerConfig.comms_overlap``) against the JAX package's
(``tests/test_overlap.py``).

- The planner: ``plan_buckets`` gives JAX's plan on the same trees (the
  same members in the same order, the same bytes, kinds and shard dims),
  and its refusals; the error-feedback residuals are JAX's shapes.
- The gates raise JAX's messages.
- ``quantize_flat``/``dequantize_flat`` are JAX's bit for bit.
- On two gloo ranks against JAX's ``shard_map`` over ``MeshSpec(dp=2)`` on
  the same bucket and residual rows: ``_sync_fused_int8``'s phase-1 int8
  chunks equal, its outputs and new residuals within 1 ulp;
  ``_sync_sharded`` within 1 ulp of ``psum_scatter``.
- The trainer on the tiny Llama (f32) at dp=2: the bucketed sync (a 32 KiB
  target, several fused buckets) is bitwise the hookless DDP step, three
  steps' losses and final parameters, with and without accumulation, and
  within the dp tolerance of JAX's dp step (losses ``rtol 1e-5``; the
  parameters as ``test_torch_distributed.py`` holds them); the buckets the
  hooks issued are the plan's, every fused bucket once a backward, their
  parameters the plan's paths in order.  At fsdp=2 the losses follow the
  hookless FSDP2 step's to ``rtol 1e-5``.  int8 with error feedback follows
  the f32 curve over five steps within JAX's ``rtol 5e-3, atol 1e-3``, one
  residual row a fused bucket a rank, about a quarter of the f32 bytes on
  the wire.  A compressed run saved after three steps and restored (its
  residuals with it) continues bitwise.  A model with buffers is refused.
"""

import dataclasses
import os
import pickle
import socket
import subprocess
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

torch = pytest.importorskip("torch")

from deeplearning_cfn_tpu.models import llama as jax_llama  # noqa: E402
from deeplearning_cfn_tpu.ops import quant as jax_quant  # noqa: E402
from deeplearning_cfn_tpu.parallel import overlap as jax_overlap  # noqa: E402
from deeplearning_cfn_tpu.parallel.mesh import MeshSpec, build_mesh  # noqa: E402
from deeplearning_cfn_tpu.train import data as jax_data  # noqa: E402
from deeplearning_cfn_tpu.train.trainer import TrainerConfig as JaxTrainerConfig  # noqa: E402
from deeplearning_cfn_tpu_torch import interop  # noqa: E402
from deeplearning_cfn_tpu_torch.models import llama  # noqa: E402
from deeplearning_cfn_tpu_torch.ops import quant  # noqa: E402
from deeplearning_cfn_tpu_torch.parallel import overlap  # noqa: E402

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SEQ, STEPS, JOIN_TIMEOUT = 16, 3, 420
TRAIN = dict(optimizer="adamw", learning_rate=1e-3, weight_decay=0.1, grad_clip_norm=1.0,
             log_every=1, overlap_bucket_bytes=32 * 1024)
CFG = dict(vocab_size=64)
RUNS = {  # name: (mesh, trainer overrides, steps)
    "dp": (dict(dp=2), dict(strategy="dp"), STEPS),
    "dp_overlap": (dict(dp=2), dict(strategy="dp", comms_overlap=True), STEPS),
    "dp_accum": (dict(dp=2), dict(strategy="dp", grad_accum_steps=2), STEPS),
    "dp_overlap_accum": (dict(dp=2), dict(strategy="dp", grad_accum_steps=2, comms_overlap=True),
                         STEPS),
    "fsdp": (dict(fsdp=2), dict(strategy="fsdp"), STEPS),
    "fsdp_overlap": (dict(fsdp=2), dict(strategy="fsdp", comms_overlap=True), STEPS),
    "dp5": (dict(dp=2), dict(strategy="dp"), 5),
    "dp5_int8": (dict(dp=2), dict(strategy="dp", comms_overlap=True, overlap_compress=True), 5),
}
INT8 = dict(strategy="dp", comms_overlap=True, overlap_compress=True)
CKPT = ("ef_save", "ef_restore", "ef_straight")


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


def _abstract(shape, dtype=jnp.float32):
    return jax.ShapeDtypeStruct(shape, dtype)


def _as_tuples(specs):
    if isinstance(specs, dict):
        return {k: _as_tuples(v) for k, v in specs.items()}
    return tuple(specs)


def _llama_tree():
    """The tiny Llama's JAX tree (shapes) with its fsdp dims as specs."""
    cfg = jax_llama.LlamaConfig.tiny(vocab_size=64, seq_len=SEQ, dtype=jnp.float32)
    params = jax.eval_shape(lambda: jax_llama.init_params(cfg, jax.random.key(0)))
    specs = jax.tree_util.tree_map(
        lambda s: P(*[a if a == "fsdp" else None for a in s]), jax_llama.param_specs(cfg),
        is_leaf=lambda s: isinstance(s, P))
    return params, specs


TREES = {
    "sorted": ({"z": _abstract((4,)), "a": _abstract((4,)), "m": _abstract((4,))},
               {"z": P(), "a": P(), "m": P()}, 1 << 20),
    "bytes": ({"w1": _abstract((64, 256)), "b1": _abstract((256,)), "w2": _abstract((256, 4))},
              {"w1": P(), "b1": P(), "w2": P()}, 32 * 1024),
    "sharded": ({"big": _abstract((1024, 64)), "bias": _abstract((64,))},
                {"big": P("fsdp", None), "bias": P()}, 1 << 20),
    "mixed_dtypes": ({"a": _abstract((300, 40), jnp.bfloat16), "b": {"c": _abstract((7,))}},
                     {"a": P(), "b": {"c": P()}}, 1000),
    "llama": (*_llama_tree(), 32 * 1024),
}


@pytest.mark.parametrize("name", list(TREES))
def test_plan_buckets_matches_jax(name):
    params, specs, target = TREES[name]
    want = jax_overlap.plan_buckets(params, specs, target)
    got = overlap.plan_buckets(params, _as_tuples(specs), target)
    assert got.to_dict() == want.to_dict()
    assert [b.indices for b in got.buckets] == [b.indices for b in want.buckets]
    assert [b.shard_axes for b in got.buckets] == [b.shard_axes for b in want.buckets]
    assert overlap.plan_buckets(dict(reversed(list(params.items()))), _as_tuples(specs),
                                target) == got


def test_plan_refusals_match_jax():
    cases = [({"w": _abstract((64, 64))}, {"w": P("fsdp", "tp")}, 1 << 20),
             ({"a": _abstract((4,)), "b": _abstract((4,))}, {"a": P()}, 1 << 20),
             ({"a": _abstract((4,))}, {"a": P()}, 0)]
    for params, specs, target in cases:
        with pytest.raises(ValueError) as want:
            jax_overlap.plan_buckets(params, specs, target)
        with pytest.raises(ValueError) as got:
            overlap.plan_buckets(params, _as_tuples(specs), target)
        head = str(want.value).split(";")[0].split("{")[0]
        assert str(got.value).startswith(head), (str(got.value), str(want.value))


def test_error_feedback_residuals_are_padded_per_fused_bucket():
    params = {"w": _abstract((100,)), "big": _abstract((1024, 64))}
    specs = {"w": P(), "big": P("fsdp", None)}
    want = jax_overlap.init_error_feedback(jax_overlap.plan_buckets(params, specs, 1 << 20), 8, {})
    state = overlap.init_error_feedback(overlap.plan_buckets(params, _as_tuples(specs), 1 << 20),
                                        nd=8, inner={"momentum": 0})
    assert state.inner == {"momentum": 0}
    assert [tuple(r.shape) for r in state.residual] == [r.shape for r in want.residual] == [(8, 104)]
    assert not state.residual[0].any()


def _jax_gate_error(shape: dict, batch_spec, plan=None, accum=1) -> str:
    n = int(np.prod(list(shape.values())))
    from jax.sharding import Mesh

    mesh = Mesh(np.array(jax.devices()[:n]).reshape(tuple(shape.values())), tuple(shape))
    plan = plan or jax_overlap.plan_buckets({"w": _abstract((8, 8))}, {"w": P()}, 1 << 20)
    with pytest.raises(ValueError) as e:
        jax_overlap.build_overlap_grad_fn(lambda *a: None, mesh, {"w": P()}, batch_spec, plan,
                                          accum=accum)
    return str(e.value)


def _port_gate_error(shape: dict, batch_spec: tuple, plan=None, accum=1) -> str:
    sizes = {a: shape.get(a, 1) for a in ("dp", "fsdp", "pp", "sp", "tp", "ep")}
    plan = plan or overlap.plan_buckets({"w": _abstract((8, 8))}, {"w": ()}, 1 << 20)
    with pytest.raises(ValueError) as e:
        axes = overlap._resolve_sync_axes(batch_spec, sizes)
        nd = int(np.prod([sizes[a] for a in axes]))
        overlap.check_sync(plan, axes, nd, accum)
    return str(e.value)


GATES = {  # name: (mesh shape, JAX batch spec, port batch spec, what the message says)
    "not_dim0": ({"dp": 8}, P(None), (None,), "dim 0"),
    "beyond_dim0": ({"dp": 4, "fsdp": 2}, P("dp", "fsdp"), ("dp", "fsdp"), "dim 0 only"),
    "non_data_axis": ({"dp": 4, "tp": 2}, P("dp"), ("dp",), "non-data mesh axis"),
    "single_device": ({"dp": 1}, P("dp"), ("dp",), "more than one device"),
}


@pytest.mark.parametrize("name", list(GATES))
def test_gates_raise_jax_messages(name):
    shape, jspec, tspec, what = GATES[name]
    want, got = _jax_gate_error(shape, jspec), _port_gate_error(shape, tspec)
    assert what in want and what in got
    # The same message but for the spec's repr (PartitionSpec against a tuple).
    assert got.replace(repr(tspec), "SPEC") == want.replace(repr(jspec), "SPEC")


def test_gates_refuse_bad_accum_foreign_shard_axes_and_stateful_models():
    assert "accum" in _port_gate_error({"dp": 8}, ("dp",), accum=0)
    plan = overlap.plan_buckets({"w": _abstract((1024, 64))}, {"w": ("ep", None)}, 1 << 20)
    jplan = jax_overlap.plan_buckets({"w": _abstract((1024, 64))}, {"w": P("fsdp", None)}, 1 << 20)
    assert "outside the sync axes" in _jax_gate_error({"dp": 8}, P("dp"), jplan)
    assert "outside the sync axes" in _port_gate_error({"dp": 8}, ("dp",), plan)
    with pytest.raises(ValueError, match="model_state|stateless"):
        overlap.check_stateless(["bn.mean", "bn.var"])
    overlap.check_stateless([])


def test_quantize_flat_is_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    for v in (rng.standard_normal(1000).astype(np.float32) * 3,
              np.zeros(17, np.float32),
              np.array([1e-30, -2.5, 127.0, 0.5, -0.5, 1.5], np.float32)):
        q, scale = quant.quantize_flat(torch.from_numpy(v))
        jq, jscale = jax_quant.quantize_flat(jnp.asarray(v))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
        np.testing.assert_array_equal(quant.dequantize_flat(q, scale).numpy(),
                                      np.asarray(jax_quant.dequantize_flat(jq, jscale)))


# --- two ranks -------------------------------------------------------------------


def _jax_int8() -> dict:
    nd, numel = 2, 1001
    rng = np.random.default_rng(1)
    flats = rng.standard_normal((nd, numel)).astype(np.float32)
    length = numel + (-numel) % nd
    residual = (rng.standard_normal((nd, length)) * 1e-3).astype(np.float32)
    mesh = build_mesh(MeshSpec(dp=nd), jax.devices()[:nd])
    fn = partial(jax_overlap._sync_fused_int8, sync_axes=("dp",), nd=nd)
    from deeplearning_cfn_tpu.utils.compat import shard_map

    out, new_res = jax.jit(shard_map(lambda f, r: fn(f[0], r), mesh=mesh,
                                     in_specs=(P("dp"), P("dp")), out_specs=(P("dp"), P("dp")),
                                     check_vma=False))(flats, residual)
    pad = np.concatenate([flats, np.zeros((nd, length - numel), np.float32)], 1) + residual
    q = [np.asarray(jax_quant.quantize_flat(jnp.asarray(v))[0]) for v in pad]
    return {"rank_case": {"mesh": {"dp": nd}, "int8": flats, "residual": residual},
            "out": np.asarray(out).reshape(nd, numel), "residual": np.asarray(new_res), "q": q}


def _jax_sharded() -> dict:
    nd = 2
    grads = np.random.default_rng(2).standard_normal((nd, 6, 8)).astype(np.float32)
    mesh = build_mesh(MeshSpec(dp=nd), jax.devices()[:nd])
    from deeplearning_cfn_tpu.utils.compat import shard_map

    out = jax.jit(shard_map(lambda g: jax_overlap._sync_sharded(g[0], ("dp",), "dp", 1)[None],
                            mesh=mesh, in_specs=P("dp"), out_specs=P("dp"),
                            check_vma=False))(grads)
    return {"rank_case": {"mesh": {"dp": nd}, "sharded": grads, "dim": 1}, "out": np.asarray(out)}


def _jax_dp() -> dict:
    """JAX's dp step on the run's weights and batches (the reference the
    hookless and bucketed runs are both held to)."""
    jcfg = dataclasses.replace(jax_llama.LlamaConfig.tiny(seq_len=SEQ, dtype=jnp.float32), **CFG)
    mesh = build_mesh(MeshSpec(dp=2), jax.devices()[:2])
    train = {k: v for k, v in TRAIN.items() if k != "overlap_bucket_bytes"}
    jtrainer = jax_llama.make_trainer(jcfg, mesh, JaxTrainerConfig(strategy="dp", **train))
    ds = jax_data.SyntheticTokenDataset(seq_len=SEQ, vocab_size=jcfg.vocab_size, batch_size=4)
    batches = [(np.asarray(b.x), np.asarray(b.y)) for b in ds.batches(5)]
    state = jtrainer.init(jax.random.key(0), jnp.asarray(batches[0][0]))
    init = jax.device_get(state.params)
    losses = []
    for x, y in batches[:STEPS]:
        state, metrics = jtrainer.train_step(
            state, *(jax.device_put(jnp.asarray(a), jtrainer.batch_sharding) for a in (x, y)))
        losses.append(float(metrics["loss"]))
    return {"init": init, "batches": batches, "losses": losses,
            "final": jax.device_get(state.params)}


def _run_case(ref: dict, mesh: dict, train_kw: dict, steps: int) -> dict:
    return {"mesh": mesh, "cfg": {"max_seq_len": SEQ, **CFG}, "trainer": {**TRAIN, **train_kw},
            "init": ref["init"], "batches": ref["batches"][:steps]}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("overlap")
    ref = _jax_dp()
    refs = {"int8": _jax_int8(), "sharded": _jax_sharded()}
    cases = {name: r["rank_case"] for name, r in refs.items()}
    for name, (mesh, train_kw, steps) in RUNS.items():
        cases[name] = _run_case(ref, mesh, train_kw, steps)
    for name in CKPT:
        case = {**_run_case(ref, {"dp": 2}, INT8, 5), "steps": STEPS, "dir": str(root / "ef")}
        cases[name] = case if name == "ef_straight" else {**case, "mode": name[3:]}
    cases["stateful"] = {"model": "resnet", "mesh": {"dp": 2}, "expect_error": True,
                         "arch": dict(stage_sizes=(1, 1), num_filters=8, num_classes=10),
                         "trainer": dict(strategy="dp", comms_overlap=True, has_train_arg=True)}
    path = root / "cases.pkl"
    path.write_bytes(pickle.dumps(cases))
    out = _spawn(2, path)
    refs["dp"] = ref
    return refs, {name: [r[name] for r in out] for name in cases}


def test_int8_exchange_matches_jax(ranks):
    refs, got = ranks
    ref = refs["int8"]
    case = ref["rank_case"]
    numel, length = case["int8"].shape[1], case["residual"].shape[1]
    for r in got["int8"]:
        i = r["rank"]
        np.testing.assert_array_equal(r["q"], ref["q"][i])
        np.testing.assert_array_max_ulp(r["out"], ref["out"][i], maxulp=1)
        # The residual v - q*scale: XLA fuses it into other roundings than
        # the port's product-then-difference; they differ by at most two
        # roundings at the product's magnitude (within scale/2 of |v|).
        v = np.concatenate([case["int8"][i], np.zeros(length - numel, np.float32)])
        v = v + case["residual"][i]
        bound = 2 * np.spacing(np.abs(v) + np.abs(v).max() / 127)
        assert np.all(np.abs(r["residual"][0] - ref["residual"][i]) <= bound)


def test_sharded_reduce_scatter_matches_jax(ranks):
    refs, got = ranks
    for r in got["sharded"]:
        np.testing.assert_array_max_ulp(r["out"], refs["sharded"]["out"][r["rank"]], maxulp=1)


def _params_equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("accum", [1, 2])
def test_bucketed_dp_sync_is_bitwise_the_hookless_ddp_step(ranks, accum):
    _, got = ranks
    base, bucketed = ("dp", "dp_overlap") if accum == 1 else ("dp_accum", "dp_overlap_accum")
    for hookless, hooked in zip(got[base], got[bucketed]):
        assert hookless["ddp"] and not hooked["ddp"]
        assert hooked["losses"] == hookless["losses"]
        assert hooked["norm"] == hookless["norm"]
        _params_equal(hooked["params"], hookless["params"])


def test_bucketed_dp_sync_matches_jax_dp(ranks):
    refs, got = ranks
    ref = refs["dp"]
    tcfg = dataclasses.replace(llama.LlamaConfig.tiny(dtype=torch.float32), **CFG)
    final = interop.llama_params_from_jax(tcfg, ref["final"])
    for r in got["dp_overlap"]:
        np.testing.assert_allclose(r["losses"], ref["losses"], rtol=1e-5)
        for pname, want in final.items():
            diff = np.abs(r["params"][pname] - want.numpy())
            assert diff.max() <= TRAIN["learning_rate"] * STEPS, (pname, diff.max())
            assert np.mean(diff > 2e-6) <= 1e-3, (pname, diff.max())


def test_the_buckets_that_run_are_the_plans(ranks):
    """Every fused bucket of the plan issued once in the last backward; each
    bucket's parameters the plan's paths in order (a leaf's blocks in layer
    order); several buckets at the 32 KiB target."""
    _, got = ranks
    for r in got["dp_overlap"]:
        fused = [b for b in r["plan"]["buckets"] if b["kind"] == "fused"]
        assert len(fused) > 2 and len(fused) == len(r["plan"]["buckets"])
        assert sorted(r["issued"]) == list(range(len(fused)))
        for bucket, names in zip(fused, r["members"]):
            want = []
            for path in bucket["paths"]:
                key = ".".join(k.strip("'") for k in path.strip("[]").split("]["))
                if key.startswith("layers."):
                    want += [f"layers.{i}.{key[7:]}" for i in range(2)]
                else:
                    want.append(key)
            assert names == want
        assert r["wire_bytes"] == sum(b["nbytes"] for b in fused)


def test_bucketed_fsdp_sync_matches_to_float_tolerance(ranks):
    _, got = ranks
    for base, hooked in zip(got["fsdp"], got["fsdp_overlap"]):
        assert hooked["sharded"] and not hooked["ddp"]
        np.testing.assert_allclose(hooked["losses"], base["losses"], rtol=1e-5)
        kinds = {b["kind"] for b in hooked["plan"]["buckets"]}
        assert kinds == {"fused", "sharded"}


def test_int8_error_feedback_tracks_the_f32_curve(ranks):
    _, got = ranks
    for f32, int8 in zip(got["dp5"], got["dp5_int8"]):
        np.testing.assert_allclose(int8["losses"], f32["losses"], rtol=5e-3, atol=1e-3)
        fused = [b for b in int8["plan"]["buckets"] if b["kind"] == "fused"]
        assert len(int8["residual"]) == len(fused) >= 1
        assert all(r.shape[0] == 1 for r in int8["residual"])
        assert any(np.abs(r).max() > 0 for r in int8["residual"])
        f32_bytes = sum(b["nbytes"] for b in fused)
        assert 0.2 * f32_bytes < int8["wire_bytes"] < 0.45 * f32_bytes
    assert got["dp5_int8"][0]["losses"] == got["dp5_int8"][1]["losses"]


def test_compressed_checkpoint_with_residuals_resumes_bitwise(ranks):
    _, got = ranks
    for saved, restored, straight in zip(*(got[n] for n in CKPT)):
        assert saved["losses"] + restored["losses"] == straight["losses"]
        _params_equal(restored["params"], straight["params"])
        for a, b in zip(restored["residual"], straight["residual"]):
            np.testing.assert_array_equal(a, b)


def test_overlap_rejects_stateful_models(ranks):
    _, got = ranks
    for r in got["stateful"]:
        assert "stateless" in r["error"] and "model_state" in r["error"]
