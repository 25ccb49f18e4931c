"""The port's decode path (``models/llama_decode``) against the JAX package's,
on the CPU, on the same weights.

``LlamaConfig.tiny(dtype=float32)`` weights come from JAX's ``init_params``
and reach the port through ``interop.llama_params_from_jax``; tokens come
from numpy seeds.  Cached logits are held to JAX's within 1e-4 (two layers
of f32 matmuls summed in another order, on logits of O(1)), and greedy
tokens must be equal.  Then the JAX package's own decode tests, run on the
port's side.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax
    import jax.numpy as jnp

    from deeplearning_cfn_tpu.models import llama as jax_llama
    from deeplearning_cfn_tpu.models import llama_decode as jax_decode
except ImportError:  # a host without JAX: only the port's own tests run
    jax = None

from deeplearning_cfn_tpu_torch import interop  # noqa: E402
from deeplearning_cfn_tpu_torch.models import llama, llama_decode  # noqa: E402

torch.set_num_threads(1)

VOCAB, SEQ = 64, 32
LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)

needs_jax = pytest.mark.skipif(jax is None, reason="needs JAX, the reference")


def _cfg(**kw):
    cfg = llama.LlamaConfig.tiny(vocab_size=VOCAB, seq_len=SEQ, dtype=torch.float32)
    return dataclasses.replace(cfg, **kw)


def _models(tied=True):
    """(JAX config, JAX params, the port's model on the same weights)."""
    jcfg = dataclasses.replace(
        jax_llama.LlamaConfig.tiny(vocab_size=VOCAB, seq_len=SEQ, dtype=jnp.float32),
        tied_embeddings=tied,
    )
    jparams = jax_llama.init_params(jcfg, jax.random.key(0))
    tcfg = _cfg(tied_embeddings=tied)
    model = llama.Llama(tcfg)
    model.load_state_dict(interop.llama_params_from_jax(tcfg, jax.device_get(jparams)))
    return jcfg, jparams, model


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, VOCAB, size=shape).astype(np.int32)


def _port_model(seed=0, **kw):
    return llama.init_model(_cfg(**kw), seed=seed, device="cpu")


# --- against the JAX package -----------------------------------------------


@needs_jax
@pytest.mark.parametrize("tied", [True, False])
def test_prefill_logits_and_cache_match_jax(tied):
    jcfg, jparams, model = _models(tied)
    tok = _tokens(0, (2, 12))
    j_logits, j_cache = jax_decode._forward_cached(
        jcfg, jparams, jnp.asarray(tok), jax_decode.init_cache(jcfg, 2, 16),
        jnp.asarray(0, jnp.int32),
    )
    cache = llama_decode.init_cache(model.cfg, 2, 16, "cpu")
    t_logits, cache = llama_decode._forward_cached(model, torch.from_numpy(tok), cache, 0)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **LOGITS_TOL)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(j_cache.k), **LOGITS_TOL)
    np.testing.assert_allclose(cache.v.numpy(), np.asarray(j_cache.v), **LOGITS_TOL)


@needs_jax
@pytest.mark.parametrize("tied", [True, False])
def test_token_by_token_logits_match_jax(tied):
    jcfg, jparams, model = _models(tied)
    tok = _tokens(1, (2, 8))
    j_cache = jax_decode.init_cache(jcfg, 2, 8)
    cache = llama_decode.init_cache(model.cfg, 2, 8, "cpu")
    for pos in range(8):
        j_logits, j_cache = jax_decode._forward_cached(
            jcfg, jparams, jnp.asarray(tok[:, pos : pos + 1]), j_cache, jnp.asarray(pos, jnp.int32)
        )
        t_logits, cache = llama_decode._forward_cached(
            model, torch.from_numpy(tok[:, pos : pos + 1]), cache, pos
        )
        np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **LOGITS_TOL,
                                   err_msg=f"position {pos}")


@needs_jax
@pytest.mark.parametrize("tied", [True, False])
def test_greedy_tokens_match_jax_generate(tied):
    jcfg, jparams, model = _models(tied)
    prompt = _tokens(2, (2, 6))
    ref = jax_decode.generate(jcfg, jparams, jnp.asarray(prompt), jax.random.key(0),
                              max_new_tokens=10)
    got = llama_decode.generate(model, torch.from_numpy(prompt), max_new_tokens=10)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# --- the JAX package's decode tests, on the port's side -----------------------


def test_prefill_matches_training_forward():
    model = _port_model()
    tokens = torch.from_numpy(_tokens(0, (2, 12)))
    ref = llama.forward(model, tokens)
    cache = llama_decode.init_cache(model.cfg, 2, 16, "cpu")
    got, _ = llama_decode._forward_cached(model, tokens, cache, 0)
    np.testing.assert_allclose(ref.detach().numpy(), got.numpy(), atol=1e-4)


def test_incremental_decode_matches_full_forward():
    """Token-by-token cached logits equal the full-sequence logits at each
    position (teacher forcing)."""
    model = _port_model()
    tokens = torch.from_numpy(_tokens(1, (2, 8)))
    full = llama.forward(model, tokens).detach()
    cache = llama_decode.init_cache(model.cfg, 2, 8, "cpu")
    for pos in range(8):
        logits, cache = llama_decode._forward_cached(model, tokens[:, pos : pos + 1], cache, pos)
        np.testing.assert_allclose(full[:, pos].numpy(), logits[:, 0].numpy(), atol=2e-4,
                                   err_msg=f"position {pos}")


def test_greedy_generation_is_deterministic_and_in_vocab():
    model = _port_model()
    prompt = torch.from_numpy(_tokens(2, (2, 4)))
    out1 = llama_decode.generate(model, prompt, torch.Generator().manual_seed(0), 6)
    out2 = llama_decode.generate(model, prompt, torch.Generator().manual_seed(1), 6)
    assert out1.shape == (2, 6)
    assert torch.equal(out1, out2)  # greedy: no draw
    assert ((out1 >= 0) & (out1 < VOCAB)).all()


def test_greedy_matches_argmax_of_full_forward():
    """Each greedy token is the argmax of the training forward over the same
    growing prefix."""
    model = _port_model()
    seq = torch.from_numpy(_tokens(3, (1, 4)))
    out = llama_decode.generate(model, seq, max_new_tokens=5)
    for t in range(5):
        nxt = int(torch.argmax(llama.forward(model, seq)[0, -1]))
        assert out[0, t] == nxt, f"step {t}: {out[0, t]} != {nxt}"
        seq = torch.cat([seq, torch.tensor([[nxt]], dtype=seq.dtype)], dim=1)


def test_sampled_generation_varies_with_seed_and_repeats_with_it():
    model = _port_model()
    prompt = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32)

    def sample(seed):
        gen = torch.Generator().manual_seed(seed)
        return llama_decode.generate(model, prompt, gen, max_new_tokens=16, temperature=1.0)

    assert not torch.equal(sample(0), sample(7))
    assert torch.equal(sample(3), sample(3))


def test_generate_refuses_a_prompt_past_max_seq_len():
    with pytest.raises(ValueError, match="max_seq_len"):
        llama_decode.generate(_port_model(), torch.zeros((1, SEQ), dtype=torch.int32), None, 1)


@pytest.mark.parametrize(
    "kw,error,match",
    [({"pp_stages": 2}, None, None),
     ({"fused_qkv": True}, ValueError, "unfused")],
)
def test_decode_refuses_configs_it_cannot_read(kw, error, match):
    """A stage-stacked config decodes as the flat stack, as JAX's does (a
    model built without a pp mesh holds every block); the decode path reads
    unfused projections, as the JAX package's does."""
    if error is None:
        llama_decode.check_decodable(_cfg(**kw))
        return
    with pytest.raises(error, match=match):
        llama_decode.check_decodable(_cfg(**kw))
    if kw == {"fused_qkv": True}:
        with pytest.raises(ValueError, match="unfused"):
            llama_decode.generate(_port_model(fused_qkv=True),
                                  torch.zeros((1, 2), dtype=torch.int32), None, 2)


def test_sample_token_takes_the_first_of_equal_maxima():
    logits = torch.tensor([[0.0, 3.0, 3.0, 1.0], [5.0, 5.0, 5.0, 5.0]])
    assert llama_decode.sample_token(logits, None, 0.0).tolist() == [1, 0]
    assert llama_decode.sample_token(logits, None, 0.0).dtype == torch.int32


def test_sample_token_draws_from_the_generator():
    logits = torch.zeros(3, 64)
    a = llama_decode.sample_token(logits, torch.Generator().manual_seed(0), 1.0)
    b = llama_decode.sample_token(logits, torch.Generator().manual_seed(0), 1.0)
    assert a.shape == (3,) and a.dtype == torch.int32 and torch.equal(a, b)
    # A sharp distribution at a low temperature lands on its mode.
    sharp = torch.tensor([0.0, 0.0, 10.0, 0.0])
    assert int(llama_decode.sample_token(sharp, torch.Generator().manual_seed(1), 0.1)) == 2
