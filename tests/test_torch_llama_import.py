"""The port's ``models/llama_import`` against the JAX package's.

On a seeded numpy HF-layout state dict of the tiny config (f32, tied and
untied) the port's import equals, tensor by tensor, JAX's import carried
through ``interop.llama_params_from_jax``, and it empties the dict as it
goes.  ``expected_hf_shapes`` at Llama-3-8B equals JAX's and HF's published
geometry.  The guards raise as JAX's do.  Under ``transformers`` (installed
here, absent on the card's host) a random tiny ``LlamaForCausalLM``'s logits
equal the port's from the imported weights, to the 2e-4 of the JAX test.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from deeplearning_cfn_tpu.models import llama as jax_llama  # noqa: E402
from deeplearning_cfn_tpu.models import llama_import as jax_import  # noqa: E402
from deeplearning_cfn_tpu_torch import interop  # noqa: E402
from deeplearning_cfn_tpu_torch.models import llama, llama_import  # noqa: E402

torch.set_num_threads(1)


def _hf_dict(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(shape).astype(np.float32)
            for k, shape in llama_import.expected_hf_shapes(cfg).items()}


@pytest.mark.parametrize("tied", [False, True])
def test_import_equals_jax_import_through_interop(tied):
    tcfg = dataclasses.replace(llama.LlamaConfig.tiny(vocab_size=96, seq_len=16,
                                                      dtype=torch.float32),
                               tied_embeddings=tied)
    jcfg = dataclasses.replace(jax_llama.LlamaConfig.tiny(vocab_size=96, seq_len=16,
                                                          dtype=jnp.float32),
                               tied_embeddings=tied)
    sd = _hf_dict(tcfg)
    want = interop.llama_params_from_jax(tcfg, jax_import.from_hf_state_dict(jcfg, dict(sd)))
    source = dict(sd)
    got = llama_import.from_hf_state_dict(tcfg, source)
    assert source == {}  # every tensor taken as it was converted
    assert got.keys() == want.keys() == llama.Llama(tcfg).state_dict().keys()
    for name, w in want.items():
        assert got[name].dtype == w.dtype and got[name].is_contiguous(), name
        torch.testing.assert_close(got[name], w, rtol=0, atol=0, msg=name)
    # The port's [in, out] is HF's [out, in] transposed.
    torch.testing.assert_close(got["layers.1.wk"], torch.from_numpy(
        sd["model.layers.1.self_attn.k_proj.weight"]).T, rtol=0, atol=0)


def test_bare_keys_bf16_torch_sources_and_the_dtype():
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(vocab_size=96, seq_len=16),
                              tied_embeddings=False)
    sd = {k.removeprefix("model."): torch.from_numpy(v).bfloat16()
          for k, v in _hf_dict(cfg).items()}
    ref = {k: v.clone() for k, v in sd.items()}
    got = llama_import.from_hf_state_dict(cfg, sd)
    assert got["layers.0.wq"].dtype == torch.bfloat16 and got["final_norm"].dtype == torch.float32
    assert torch.equal(got["layers.0.w_down"], ref["layers.0.mlp.down_proj.weight"].T)
    assert torch.equal(got["output"], ref["lm_head.weight"].T)
    model = llama.Llama(cfg)
    model.load_state_dict(got)


def test_expected_hf_shapes_at_8b_equal_jax_and_hf():
    tcfg, jcfg = llama.LlamaConfig.llama3_8b(), jax_llama.LlamaConfig.llama3_8b()
    shapes = llama_import.expected_hf_shapes(tcfg)
    assert shapes == jax_import.expected_hf_shapes(jcfg)
    assert shapes["model.embed_tokens.weight"] == (128256, 4096)
    assert shapes["model.layers.0.self_attn.k_proj.weight"] == (1024, 4096)
    assert shapes["model.layers.31.mlp.gate_proj.weight"] == (14336, 4096)
    assert len([k for k in shapes if ".layers." in k]) == 32 * 9


def _hf_config(**kw):
    base = dict(vocab_size=96, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
                rope_theta=10000.0, rms_norm_eps=1e-5, tie_word_embeddings=False)
    return types.SimpleNamespace(**{**base, **kw})


@pytest.mark.parametrize("kw,match", [
    ({"rope_scaling": {"type": "llama3"}}, "rope_scaling"),
    ({"head_dim": 32}, "head_dim"),
    ({"attention_bias": True}, "bias"),
    ({"mlp_bias": True}, "bias"),
    ({"hidden_act": "gelu"}, "hidden_act"),
])
def test_config_guards_raise_as_jax_does(kw, match):
    with pytest.raises(jax_import.ImportError_, match=match):
        jax_import.config_from_hf(_hf_config(**kw))
    with pytest.raises(llama_import.ImportError_, match=match):
        llama_import.config_from_hf(_hf_config(**kw))


def test_config_mapping_equals_jax():
    t = llama_import.config_from_hf(_hf_config(), dtype=torch.float32)
    j = jax_import.config_from_hf(_hf_config(), dtype=jnp.float32)
    fields = [f.name for f in dataclasses.fields(j) if f.name != "dtype"]
    assert {f: getattr(t, f) for f in fields if hasattr(t, f)} == {
        f: getattr(j, f) for f in fields if hasattr(t, f)}


def test_missing_weights_and_out_of_slice_raise():
    cfg = dataclasses.replace(llama.LlamaConfig.tiny(vocab_size=96, seq_len=16),
                              tied_embeddings=False)
    sd = _hf_dict(cfg)
    del sd["model.layers.1.mlp.up_proj.weight"]
    with pytest.raises(llama_import.ImportError_, match="up_proj"):
        llama_import.from_hf_state_dict(cfg, dict(sd))
    sd = _hf_dict(cfg)
    del sd["lm_head.weight"]
    with pytest.raises(llama_import.ImportError_, match="lm_head"):
        llama_import.from_hf_state_dict(cfg, sd)
    # A stage-stacked config imports the same per-layer dict (its blocks keep
    # their global index): the importer no longer refuses it.
    staged = llama_import.from_hf_state_dict(dataclasses.replace(cfg, pp_stages=2), _hf_dict(cfg))
    flat = llama_import.from_hf_state_dict(cfg, _hf_dict(cfg))
    assert staged.keys() == flat.keys() and all(torch.equal(staged[k], flat[k]) for k in flat)


@pytest.mark.parametrize("tied", [False, True])
def test_logits_parity_with_hf(tied):
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.LlamaConfig(
        vocab_size=96, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=64,
        rope_theta=10000.0, rms_norm_eps=1e-5, tie_word_embeddings=tied)
    torch.manual_seed(0)
    hf = transformers.LlamaForCausalLM(hf_cfg).eval()
    cfg, sd = llama_import.from_hf(hf, dtype=torch.float32)
    model = llama.Llama(cfg)
    model.load_state_dict(sd)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, 96, size=(2, 10)))
    with torch.no_grad():
        ref = hf(tokens).logits
        got = llama.forward(model, tokens)
    torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-4)
