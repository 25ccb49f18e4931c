"""The port's attention building blocks against the JAX package's, on the CPU.

Inputs are drawn with numpy from a seed and handed to both frameworks in
f32.  Tolerances: the two sides run the same f32 arithmetic with different
summation orders and different libm cos/sin/rsqrt, so they agree to a few
f32 ulps of the values' scale (1e-5 relative, 1e-6 absolute on O(1) data).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from deeplearning_cfn_tpu.ops import attention as jax_attn  # noqa: E402
from deeplearning_cfn_tpu_torch.ops import attention as port  # noqa: E402

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol, atol=atol)


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_rms_norm_matches_jax(eps):
    x, w = _np(0, 2, 8, 32) * 3.0, _np(1, 32)
    _close(port.rms_norm(torch.from_numpy(x), torch.from_numpy(w), eps),
           jax_attn.rms_norm(jnp.asarray(x), jnp.asarray(w), eps))


@pytest.mark.parametrize("batched_positions", [False, True])
@pytest.mark.parametrize("theta", [500000.0, 10000.0])
def test_rotary_embedding_matches_jax(batched_positions, theta):
    x = _np(2, 2, 16, 4, 32)
    pos = np.arange(16, dtype=np.int32)
    if batched_positions:
        pos = np.stack([pos, pos + 100])
    # Angles reach ~115 rad: cos/sin of a large f32 angle differ by an ulp of
    # the angle between libms, hence the absolute 1e-5.
    _close(port.rotary_embedding(torch.from_numpy(x), torch.from_numpy(pos), theta),
           jax_attn.rotary_embedding(jnp.asarray(x), jnp.asarray(pos), theta),
           atol=1e-5)


def test_repeat_kv_matches_jax():
    k = _np(3, 2, 8, 2, 4)
    _close(port._repeat_kv(torch.from_numpy(k), 6), jax_attn._repeat_kv(jnp.asarray(k), 6))


@pytest.mark.parametrize("mask_kind", [None, "bool", "additive"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2)])
def test_dot_product_attention_matches_jax(mask_kind, causal, hq, hkv):
    B, S, D = 2, 12, 16
    q, k, v = _np(4, B, S, hq, D), _np(5, B, S, hkv, D), _np(6, B, S, hkv, D)
    mask = None
    if mask_kind == "bool":
        mask = np.random.default_rng(7).random((B, 1, S, S)) > 0.3
        mask[..., 0] = True  # keep one key per row under the causal mask too
    elif mask_kind == "additive":
        mask = _np(7, B, 1, S, S)
    tm = None if mask is None else torch.from_numpy(mask)
    jm = None if mask is None else jnp.asarray(mask)
    out = port.dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), causal=causal, mask=tm
    )
    ref = jax_attn.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, mask=jm
    )
    _close(out, ref, atol=1e-5)


def test_repeat_kv_rejects_a_bad_ratio():
    with pytest.raises(ValueError):
        port._repeat_kv(torch.zeros(1, 2, 3, 4), 4)
