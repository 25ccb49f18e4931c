"""The port's Llama against the JAX package's, on the CPU, on the same weights.

``LlamaConfig.tiny(dtype=float32)`` weights come from JAX's ``init_params``
and reach the port through ``interop.llama_params_from_jax``.  Logits and the
loss are compared on the "xla" path (materialised scores on both sides) and
with "flash" forced on both sides (the Pallas kernel in interpret mode in
JAX, the plain flash reference in the port).  Tolerance: two layers of f32
matmuls summed in another order, 1e-4 relative on logits of O(1) (the
embedding-tied head sums 64 products); 1e-5 on the scalar loss.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deeplearning_cfn_tpu.models import llama as jax_llama  # noqa: E402
from deeplearning_cfn_tpu_torch import interop  # noqa: E402
from deeplearning_cfn_tpu_torch.models import llama  # noqa: E402

torch.set_num_threads(1)

SEQ, VOCAB = 32, 256


def _configs(**kw):
    jcfg = jax_llama.LlamaConfig.tiny(vocab_size=VOCAB, seq_len=SEQ, dtype=jnp.float32, **kw)
    tcfg = llama.LlamaConfig.tiny(vocab_size=VOCAB, seq_len=SEQ, dtype=torch.float32, **kw)
    return jcfg, tcfg


def _models(**kw):
    jcfg, tcfg = _configs(**kw)
    jparams = jax_llama.init_params(jcfg, jax.random.key(0))
    model = llama.Llama(tcfg)
    model.load_state_dict(interop.llama_params_from_jax(tcfg, jax.device_get(jparams)))
    return jcfg, jparams, model


def _tokens(seed=0, batch=2):
    tok = np.random.default_rng(seed).integers(1, VOCAB, size=(batch, SEQ), dtype=np.int32)
    return tok, np.roll(tok, -1, axis=1)


@pytest.mark.parametrize("fused_qkv", [False, True])
@pytest.mark.parametrize("kind", ["xla", "flash"])
def test_logits_and_loss_match_jax(monkeypatch, kind, fused_qkv):
    jcfg, jparams, model = _models(fused_qkv=fused_qkv)
    tok, tgt = _tokens()
    # JAX dispatches to flash only on a TPU; force its choice as the port's.
    monkeypatch.setattr(jax_llama, "attention_kind", lambda *a, **kw: kind)
    j_logits = jax_llama.forward(jcfg, jparams, jnp.asarray(tok))
    j_loss, _ = jax_llama.causal_lm_loss(jcfg, jparams, jnp.asarray(tok), jnp.asarray(tgt))
    with torch.no_grad(), llama.force_attention_kind(kind):
        t_logits = llama.forward(model, torch.from_numpy(tok))
        t_loss, metrics = llama.causal_lm_loss(model, torch.from_numpy(tok), torch.from_numpy(tgt))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=1e-5)
    np.testing.assert_allclose(metrics["perplexity"].item(), np.exp(float(j_loss)), rtol=1e-4)


@pytest.mark.parametrize("kind", ["xla", "flash"])
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_gradients_equal_gradients_without_remat(kind, policy):
    """The recompute runs the same ops on the same inputs, so the gradients
    agree to the last bit; the tolerance only absorbs a library that picks a
    matmul kernel by memory layout."""
    _, tcfg = _configs()
    tok, tgt = (torch.from_numpy(a) for a in _tokens(seed=1))

    def grads(cfg):
        model = llama.init_model(cfg, seed=3, device="cpu")
        with llama.force_attention_kind(kind):
            loss, _ = llama.causal_lm_loss(model, tok, tgt)
            loss.backward()
        return {n: p.grad for n, p in model.named_parameters()}

    plain = grads(tcfg)
    remat = grads(dataclasses.replace(tcfg, remat=True, remat_policy=policy))
    assert plain.keys() == remat.keys()
    for name in plain:
        torch.testing.assert_close(remat[name], plain[name], rtol=1e-6, atol=1e-7, msg=name)


def test_dots_policy_saves_matmuls_and_full_recomputes_them():
    from torch.utils._python_dispatch import TorchDispatchMode

    class CountMatmuls(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += func is torch.ops.aten.mm.default
            return func(*args, **(kwargs or {}))

    _, tcfg = _configs()
    tok, tgt = (torch.from_numpy(a) for a in _tokens())
    counts = {}
    for name, cfg in {
        "none": tcfg,
        "full": dataclasses.replace(tcfg, remat=True, remat_policy="full"),
        "dots": dataclasses.replace(tcfg, remat=True, remat_policy="dots"),
    }.items():
        loss, _ = llama.causal_lm_loss(llama.init_model(cfg, device="cpu"), tok, tgt)
        counter = CountMatmuls()
        with counter:
            loss.backward()
        counts[name] = counter.n
    # 6 projections per layer are recomputed under "full", none under "dots".
    assert counts["dots"] == counts["none"]
    assert counts["full"] == counts["none"] + 6 * tcfg.n_layers


def test_state_dict_names_and_orientation():
    jcfg, jparams, model = _models()
    sd = model.state_dict()
    assert sd["layers.1.wq"].shape == (64, 64)  # [in, out], x @ W
    np.testing.assert_array_equal(sd["layers.1.w_down"].numpy(), np.asarray(jparams["layers"]["w_down"][1]))
    assert "output" not in sd  # tied embeddings


def test_interop_accepts_bf16_leaves():
    jcfg = jax_llama.LlamaConfig.tiny(vocab_size=VOCAB, seq_len=SEQ)  # bf16 weights
    jparams = jax.device_get(jax_llama.init_params(jcfg, jax.random.key(0)))
    sd = interop.llama_params_from_jax(llama.LlamaConfig.tiny(vocab_size=VOCAB), jparams)
    assert sd["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        sd["layers.0.wq"].float().numpy(), np.asarray(jparams["layers"]["wq"][0], np.float32)
    )


@pytest.mark.parametrize("preset", ["tiny", "m435", "b1"])
def test_param_count_and_flops_match_jax(preset):
    jcfg = getattr(jax_llama.LlamaConfig, preset)()
    tcfg = getattr(llama.LlamaConfig, preset)()
    assert llama.param_count(tcfg) == jax_llama.param_count(jcfg)
    assert llama.train_flops_per_token(tcfg, 2048) == jax_llama.train_flops_per_token(jcfg, 2048)


def test_attention_kind_dispatch():
    cfg = llama.LlamaConfig.m435(seq_len=2048)
    cuda = torch.device("cuda")  # a device object; no card needed to build it
    assert llama.attention_kind(cfg, 2048, cuda) == "flash"
    assert llama.attention_kind(cfg, 1024, cuda) == "xla"  # below the crossover
    assert llama.attention_kind(cfg, 2048, "cpu") == "xla"  # as JAX does off-TPU
    no_flash = dataclasses.replace(cfg, use_flash_attention=False)
    assert llama.attention_kind(no_flash, 4096, cuda) == "xla"
    with llama.force_attention_kind("flash"):
        assert llama.attention_kind(cfg, 16, "cpu") == "flash"
    assert llama.attention_kind(cfg, 16, "cpu") == "xla"
    with pytest.raises(ValueError):
        with llama.force_attention_kind("ring"):
            pass


@pytest.mark.parametrize(
    "kw", [{"pp_stages": 2}, {"use_ring_attention": True}]
)
def test_out_of_slice_configs_raise(kw):
    """Both are ported: pipeline stages (``parallel/pipeline.py``) split the
    layers only over a mesh with pp > 1, and ring attention
    (``parallel/ring_attention.py``) takes effect only over a mesh with
    sp > 1; without one, as in JAX, the model is the dense one."""
    _, tcfg = _configs()
    if "use_ring_attention" in kw:
        ring = llama.Llama(dataclasses.replace(tcfg, **kw), torch.Generator().manual_seed(0))
        dense = llama.Llama(tcfg, torch.Generator().manual_seed(0))
        assert llama.attention_kind(ring.cfg, SEQ, "cpu", sp=2) == "ring"
        assert llama.attention_kind(ring.cfg, SEQ, "cpu") == "xla"
        tokens = torch.arange(2 * SEQ).reshape(2, SEQ) % VOCAB
        torch.testing.assert_close(ring(tokens), dense(tokens), rtol=0, atol=0)
        return
    staged = llama.Llama(dataclasses.replace(tcfg, **kw), torch.Generator().manual_seed(0))
    dense = llama.Llama(tcfg, torch.Generator().manual_seed(0))
    assert not staged.pipelined and staged.n_microbatches == 2
    tokens = torch.arange(2 * SEQ).reshape(2, SEQ) % VOCAB
    torch.testing.assert_close(staged(tokens), dense(tokens), rtol=0, atol=0)
