"""The port's ``models/llama_memory`` against the JAX package's.

``memory_report`` at the points of ``tests/test_llama_memory.py``: every
term JAX has is equal to JAX's (the same bytes over the same GiB), except
the gradient term, which is the port's own program (one parameter-sized
copy whatever the accumulation: ``AccumulateGrad`` sums into ``.grad`` in
place, where JAX's scan carries a second buffer), and the port's
``loss_f32`` term (16 bytes a logit) is its stated formula.  ``fits`` against
the TPU table and against the card's memory (faked here).  ``trace_check``
traces one train step at Llama-3-8B's shapes on the ``meta`` device for the
two layouts JAX's tests lower, allocating nothing of the model.  Llama-3-8B's
parameters are bf16 but for the f32 norms, as in the JAX tree.  One ``cuda``
test holds the flash kernel at the 8B shape to its plain version.
"""

import pytest

torch = pytest.importorskip("torch")

try:
    import jax

    from deeplearning_cfn_tpu.models import llama as jax_llama
    from deeplearning_cfn_tpu.models import llama_memory as jax_memory
except ImportError:  # the card's host: only the cuda test runs
    jax = None

from deeplearning_cfn_tpu_torch.models import llama, llama_memory  # noqa: E402

torch.set_num_threads(1)

needs_jax = pytest.mark.skipif(jax is None, reason="needs JAX, the reference")
GIB = 1024**3

# (config, mesh, global batch, seq, optimizer, grad_accum): the JAX tests' points.
POINTS = {
    "8b-fsdp8-tp2": ("llama3_8b", {"fsdp": 8, "tp": 2}, 16, None, "adamw", 1),
    "8b-fsdp16": ("llama3_8b", {"fsdp": 16, "tp": 1}, 16, None, "adamw", 1),
    "8b-fsdp4": ("llama3_8b", {"fsdp": 4, "tp": 1}, 8, None, "adamw", 1),
    "8b-one-chip-lean": ("llama3_8b", {"fsdp": 1}, 8, 8192, "adafactor", 8),
    "8b-one-card-run": ("llama3_8b", {"fsdp": 1}, 2, 8192, "adafactor", 2),
    "b3-adamw": ("b3", {"fsdp": 1}, 4, 1024, "adamw", 1),
    "b3-adafactor": ("b3", {"fsdp": 1}, 4, 1024, "adafactor", 1),
    "b1-one-shot": ("b1", {"dp": 1, "fsdp": 1}, 128, None, "adafactor", 1),
    "b1-accum4": ("b1", {"dp": 1, "fsdp": 1}, 128, None, "adafactor", 4),
    "b3-accum4": ("b3", {"dp": 1, "fsdp": 1}, 32, None, "adafactor", 4),
}


def _cfgs(name):
    if name == "llama3_8b":
        return jax_llama.LlamaConfig.llama3_8b(), llama.LlamaConfig.llama3_8b()
    return (getattr(jax_llama.LlamaConfig, name)(seq_len=1024),
            getattr(llama.LlamaConfig, name)(seq_len=1024))


@needs_jax
@pytest.mark.parametrize("point", list(POINTS))
def test_memory_report_terms_match_jax(point):
    name, mesh, batch, seq, opt, accum = POINTS[point]
    jcfg, tcfg = _cfgs(name)
    want = jax_memory.memory_report(jcfg, mesh, batch, seq_len=seq, optimizer=opt,
                                    grad_accum=accum)
    got = llama_memory.memory_report(tcfg, mesh, batch, seq_len=seq, optimizer=opt,
                                     grad_accum=accum)
    for term in ("params_gib", "optimizer_gib", "activations_gib", "logits_gib"):
        assert getattr(got, term) == getattr(want, term), term
    assert (got.seq_len, got.batch_global, got.mesh_axes) == (want.seq_len, batch, mesh)
    # The port's own program: one gradient copy, accumulated in place.
    assert got.gradients_gib == got.params_gib
    assert want.gradients_gib == got.params_gib * (2 if accum > 1 else 1)
    b = batch // accum // (mesh.get("dp", 1) * mesh.get("fsdp", 1))
    # Vocab-parallel under tp: each rank's share of the vocabulary.
    assert got.loss_f32_gib == 16 * b * got.seq_len * (tcfg.vocab_size // mesh.get("tp", 1)) / GIB
    total = (got.params_gib + got.optimizer_gib + got.gradients_gib + got.activations_gib
             + got.logits_gib + got.loss_f32_gib)
    assert got.total_gib == pytest.approx(total, rel=1e-12)


@needs_jax
def test_param_leaves_are_the_jax_tree():
    """The stacked leaves of the meta model are JAX's ``init_params`` leaves,
    shapes and itemsizes, and their specs shard the same bytes."""
    for name in ("llama3_8b", "b1"):
        jcfg, tcfg = _cfgs(name)
        shapes = jax.eval_shape(lambda k, c=jcfg: jax_llama.init_params(c, k), jax.random.key(0))
        want = sorted((tuple(x.shape), x.dtype.itemsize)
                      for x in jax.tree_util.tree_leaves(shapes))
        got = sorted((shape, size) for shape, size, _ in llama_memory.param_leaves(tcfg))
        assert got == want


def test_shard_factor_handles_tuple_axes():
    axes = {"dp": 2, "fsdp": 4, "tp": 2}
    assert llama_memory._shard_factor((("dp", "fsdp"), None), axes) == 8
    assert llama_memory._shard_factor((None, "tp"), axes) == 2
    assert llama_memory._shard_factor((), axes) == 1


def test_llama3_8b_weights_are_bf16_and_norms_f32():
    """8.03 B parameters: 14.96 GiB in bf16 (the norms, 65 × 4096, in f32),
    twice that if they were f32; the report's params term is that size."""
    with torch.device("meta"):
        model = llama.Llama(llama.LlamaConfig.llama3_8b())
    by_dtype = {}
    for name, p in model.named_parameters():
        by_dtype.setdefault(p.dtype, []).append((name, p.numel()))
    assert set(by_dtype) == {torch.bfloat16, torch.float32}
    assert all(n.endswith("norm") for n, _ in by_dtype[torch.float32])
    n_f32 = sum(n for _, n in by_dtype[torch.float32])
    n_bf16 = sum(n for _, n in by_dtype[torch.bfloat16])
    assert n_f32 == 65 * 4096
    assert n_bf16 + n_f32 == llama.param_count(llama.LlamaConfig.llama3_8b()) == 8_030_261_248
    nbytes = 2 * n_bf16 + 4 * n_f32
    assert abs(nbytes / GIB - 14.96) < 0.01
    rep = llama_memory.memory_report(llama.LlamaConfig.llama3_8b(), {"fsdp": 1}, 2, 8192,
                                     optimizer="adafactor", grad_accum=2)
    assert rep.params_gib == nbytes / GIB


def test_fits_against_the_tpu_table_and_the_card(monkeypatch):
    cfg = llama.LlamaConfig.llama3_8b()
    for mesh in ({"fsdp": 16, "tp": 1}, {"fsdp": 8, "tp": 2}):
        assert llama_memory.memory_report(cfg, mesh, 16).fits("v5p")
    assert not llama_memory.memory_report(cfg, {"fsdp": 4, "tp": 1}, 8).fits("v5litepod")
    # No chip named: the card's memory (an 80 GB card, faked).
    props = type("Props", (), {"total_memory": 80 * 10**9})()
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda i: props)
    lean = llama_memory.memory_report(cfg, {"fsdp": 1}, 2, 8192, optimizer="adafactor",
                                      grad_accum=2)
    assert lean.fits() and 40 < lean.total_gib < 0.9 * 80e9 / GIB
    assert not llama_memory.memory_report(cfg, {"fsdp": 1}, 2, 8192, optimizer="adamw").fits()
    with pytest.raises(ValueError, match="not divisible"):
        llama_memory.memory_report(cfg, {"fsdp": 1}, 10, grad_accum=3)
    with pytest.raises(ValueError, match="must be >= 1"):
        llama_memory.memory_report(cfg, {"fsdp": 1}, 10, grad_accum=0)


@pytest.mark.parametrize("layout", range(len(llama_memory.TRACED_LAYOUTS)))
def test_trace_check_runs_the_8b_step_on_meta(layout):
    """The single-chip memory-lean program (adafactor, accum 8, seq 8192) and
    the v5p-32 layout (fsdp 8 × tp 2, batch 16): one full train step traced,
    and the largest tensor made off ``meta`` is a mesh rank table."""
    kw = llama_memory.TRACED_LAYOUTS[layout]
    out = llama_memory.trace_check(llama.LlamaConfig.llama3_8b(), **kw)
    assert out["traced"] and out["step"] == 1 and out["loss_shape"] == ()
    assert out["host_largest"] <= 64 and out["host_bytes"] < 8192
    tp = kw["mesh_axes"].get("tp", 1)
    total = llama.param_count(llama.LlamaConfig.llama3_8b())
    assert abs(out["local_params"] - total / tp) < 0.01 * total  # the norms stay whole


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_flash_kernel_at_the_8b_shape_matches_its_plain_version(cuda_device):
    """B 1, S 8192, 32 q heads over 8 kv heads, D 128, causal, bf16: the
    wgmma kernel's lse within 1e-3 of its plain version's, out within 2e-2
    (the kernel's other wgmma rows' limits), and each row of out (its 128
    values) within four bf16 ulps of that row's largest |value| as well.
    Over n keys of random scores |out| is about sqrt(e/n), 0.018 at n = 8192,
    where 2e-2 is no limit at all; the row's own ulps follow it.  The two
    sides round p and out to bf16 at different blockings: under one ulp for
    p, one more for out."""
    from deeplearning_cfn_tpu_torch.ops import _kernels
    from deeplearning_cfn_tpu_torch.ops.flash_attention import flash_attention_reference

    g = torch.Generator(cuda_device).manual_seed(0)
    q = torch.randn((1, 8192, 32, 128), generator=g, device=cuda_device).bfloat16()
    k, v = (torch.randn((1, 8192, 8, 128), generator=g, device=cuda_device).bfloat16()
            for _ in range(2))
    key = "flash_attention_fwd/wgmma_tma"
    before = _kernels.launch_counts.get(key, 0)
    out, lse = _kernels.flash_attn_fwd(q, k, v, causal=True, sm_scale=128**-0.5)
    torch.cuda.synchronize()
    assert _kernels.launch_counts[key] == before + 1
    ref_out, ref_lse = flash_attention_reference(q, k, v, causal=True, sm_scale=128**-0.5)
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=0, atol=2e-2)
    ref = ref_out.float()
    err = (out.float() - ref).abs().amax(-1)
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().amax(-1).clamp_min(2.0**-126))) - 7)
    assert (err / ulp).max().item() <= 4
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-3)
