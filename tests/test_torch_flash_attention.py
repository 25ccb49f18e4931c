"""The port's flash attention against the JAX package's Pallas flash kernel.

On the CPU the JAX side runs the Pallas kernel in interpret mode (bit-true to
the kernel body) and the port runs ``flash_attention_reference`` and the
torch blockwise backward.  Both run the same f32 online-softmax arithmetic
with the same kv blocking, so they agree to f32 rounding of sums over at
most a few hundred terms: 1e-5 relative, 2e-6 absolute on O(1) values.

The CUDA kernel itself (bf16: wgmma and TMA; f32: a scalar path) is checked
against the reference by the ``cuda`` tests below on a card (``python -m pytest -m cuda tests/test_torch_flash_attention.py``;
the card's host has no JAX, so there the JAX comparisons skip), and by
``chip_smoke.py``.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax
    import jax.numpy as jnp

    from deeplearning_cfn_tpu.ops import pallas_attention as jax_flash
except ImportError:  # the card's host: only the tests without the JAX reference run
    jax = None

from deeplearning_cfn_tpu_torch.ops import _kernels  # noqa: E402
from deeplearning_cfn_tpu_torch.ops import flash_attention as port  # noqa: E402

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 2e-6


def _qkv(b, s, hq, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(
        rng.standard_normal(shape).astype(np.float32)
        for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d))
    )


needs_jax = pytest.mark.skipif(jax is None, reason="needs JAX, the reference")


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


# (B, S, Hq, Hkv, D, causal, block_q, block_k)
FORWARD_CASES = {
    "causal": (2, 64, 4, 4, 16, True, 16, 16),
    "full": (2, 64, 4, 4, 16, False, 16, 16),
    "gqa-4-2": (2, 64, 4, 2, 16, True, 16, 16),
    # block_q > block_k: in kv block 1 the first 16 rows of q block 0 have
    # every key masked, the fully-masked-row path of the online softmax.
    "fully-masked-rows-in-block": (2, 64, 4, 2, 16, True, 32, 16),
    "ragged-causal": (1, 50, 4, 2, 16, True, 16, 16),
    "ragged-full": (1, 50, 4, 2, 16, False, 16, 16),
}


@needs_jax
@pytest.mark.parametrize("case", list(FORWARD_CASES))
def test_reference_matches_pallas_interpret(case):
    B, S, Hq, Hkv, D, causal, bq, bk = FORWARD_CASES[case]
    q, k, v = _qkv(B, S, Hq, Hkv, D)
    scale = D**-0.5
    assert port._clamp_block(bk, S) == bk  # the reference blocks kv as JAX does
    out, lse = port.flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, sm_scale=scale, block_k=bk,
    )
    j_out, j_lse = jax_flash._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        causal, scale, bq, bk, interpret=True,
    )
    assert out.shape == (B, S, Hq, D) and lse.shape == (B, Hq, S)
    assert lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), rtol=RTOL, atol=ATOL)


def test_reference_rows_with_no_key_give_zero_and_neg_inf():
    # With no keys at all every row keeps l == 0: out 0 and lse NEG_INF,
    # the kernel's guard (the Pallas grid cannot express an empty kv axis).
    q = torch.randn(1, 4, 2, 16)
    k = v = torch.zeros(1, 0, 2, 16)
    out, lse = port.flash_attention_reference(q, k, v, causal=False)
    assert torch.equal(out, torch.zeros_like(out))
    assert torch.all(lse == port.NEG_INF)


def test_reference_bf16_keeps_dtype():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(1, 40, 4, 2, 16))
    out, lse = port.flash_attention_reference(q, k, v)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32


# (B, S, Hq, Hkv, D, causal): default blocks on both sides (one kv block each).
GRAD_CASES = {
    "causal-gqa-4-2": (2, 48, 4, 2, 16, True),
    "causal-mha": (1, 48, 4, 4, 16, True),
    "full-ragged": (1, 40, 4, 4, 16, False),
}


@needs_jax
@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_gradients_match_jax_grad_of_interpret_flash(case):
    B, S, Hq, Hkv, D, causal = GRAD_CASES[case]
    q, k, v = _qkv(B, S, Hq, Hkv, D, seed=1)
    w = np.random.default_rng(2).standard_normal((B, S, Hq, D)).astype(np.float32)

    def jax_loss(q, k, v):
        out = jax_flash.flash_attention(q, k, v, causal=causal, interpret=True)
        return jnp.sum(out * jnp.asarray(w))

    j_grads = jax.grad(jax_loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = port.flash_attention(tq, tk, tv, causal=causal)
    (out * torch.from_numpy(w)).sum().backward()
    for t, j in zip((tq, tk, tv), j_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=RTOL, atol=1e-5)


def test_gradients_with_bf16_inputs_keep_dtypes():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_() for a in _qkv(1, 32, 4, 2, 16))
    port.flash_attention(q, k, v).float().sum().backward()
    assert all(t.grad.dtype == torch.bfloat16 and t.grad.shape == t.shape for t in (q, k, v))


def test_bad_gqa_ratio_raises():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 16, 4, 3, 16))
    with pytest.raises(ValueError):
        port.flash_attention(q, k, v)


def test_reference_autograd_equals_the_blockwise_backward():
    """The reference is differentiable by autograd (the card's gradient check
    holds FlashAttention to it); its gradients equal the FA2 backward's."""
    base = [torch.from_numpy(a) for a in _qkv(2, 64, 4, 2, 16, seed=3)]
    w = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 64, 4, 16)).astype(np.float32))
    fa = [x.clone().requires_grad_() for x in base]
    ref = [x.clone().requires_grad_() for x in base]
    (port.FlashAttention.apply(*fa, True, 0.25) * w).sum().backward()
    (port.flash_attention_reference(*ref, causal=True, sm_scale=0.25)[0] * w).sum().backward()
    for a, b in zip(fa, ref):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=RTOL, atol=1e-5)


@needs_jax
def test_clamp_block_matches_jax():
    for block in (16, 64, 128, 512, 1024):
        for seq in (1, 15, 50, 128, 600, 1000, 2048, 4100):
            assert port._clamp_block(block, seq) == jax_flash._clamp_block(block, seq)


def test_cuda_tensors_go_to_the_kernel_never_the_reference(monkeypatch):
    """The dispatcher hands a CUDA tensor to the kernel wrapper and never to
    the reference (stubbed to fail), with no fallback."""
    calls = []

    def fake_kernel(q, k, v, *, causal, sm_scale):
        calls.append((causal, sm_scale))
        return "out", "lse"

    def refuse(*a, **kw):
        raise AssertionError("a CUDA tensor reached the reference")

    monkeypatch.setattr(_kernels, "flash_attn_fwd", fake_kernel)
    monkeypatch.setattr(port, "flash_attention_reference", refuse)
    fake = types.SimpleNamespace(device=torch.device("cuda"))
    assert port._forward(fake, fake, fake, True, 0.25) == ("out", "lse")
    assert calls == [(True, 0.25)]


def test_cuda_kernel_failure_is_not_caught(monkeypatch):
    def broken(*a, **kw):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(_kernels, "flash_attn_fwd", broken)
    monkeypatch.setattr(port, "flash_attention_reference", lambda *a, **kw: ("ref", "ref"))
    fake = types.SimpleNamespace(device=torch.device("cuda"))
    with pytest.raises(RuntimeError, match="launch failed"):
        port._forward(fake, fake, fake, True, 0.25)


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 16, 2, 2, 64))
    before = _kernels.launch_counts["flash_attention_fwd"]
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.flash_attn_fwd(q, k, v, causal=True, sm_scale=0.125)
    assert _kernels.launch_counts["flash_attention_fwd"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [("bfloat16", 2e-2), ("float32", 1e-5)])
@pytest.mark.parametrize("shape", [(2, 256, 4, 2, 128, True), (1, 200, 4, 4, 64, False)])
def test_cuda_kernel_matches_reference(cuda_device, dtype, atol, shape):
    """bf16: out is rounded to bf16 on both sides after sums in another order
    (p is rounded to bf16 for p@v), so one or two bf16 ulps of O(1) values."""
    B, S, Hq, Hkv, D, causal = shape
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(cuda_device, dt) for a in _qkv(B, S, Hq, Hkv, D))
    before = _kernels.launch_counts["flash_attention_fwd"]
    out, lse = _kernels.flash_attn_fwd(q, k, v, causal=causal, sm_scale=D**-0.5)
    torch.cuda.synchronize()
    assert _kernels.launch_counts["flash_attention_fwd"] == before + 1
    ref_out, ref_lse = port.flash_attention_reference(q, k, v, causal=causal)
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=0, atol=atol)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-4)


# (B, Sq, Sk, Hq, Hkv, D, causal, packed): the wgmma/TMA kernel's edges.
# packed: q, k and v are views of one [B, S, 3, H, D] tensor (the tensor
# maps' strides); ragged S exercises TMA's zero fill and the Sk-edge mask,
# causal the diagonal mask and the reversed tile order.
WGMMA_CASES = {
    "causal-ragged": (2, 1000, 1000, 8, 8, 128, True, False),
    "strided-qkv": (2, 512, 512, 8, 8, 128, True, True),
    "sq-ne-sk-full": (2, 300, 700, 4, 4, 128, False, False),
    "sq-gt-sk-causal": (1, 700, 300, 4, 4, 64, True, False),
    "gqa-4-1": (1, 1024, 1024, 8, 2, 128, True, False),
    "d64-causal": (2, 640, 640, 4, 4, 64, True, False),
    "d64-full-ragged": (2, 1000, 1000, 8, 8, 64, False, False),
    "d128-full": (1, 384, 384, 4, 4, 128, False, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(WGMMA_CASES))
def test_wgmma_kernel_matches_reference_on_card(cuda_device, case):
    """bf16 out within two bf16 ulps of O(1) values (p is rounded to bf16 at
    another blocking of the running max); lse within 1e-3 (f32 sums in
    another order, exp2 with the scale folded in)."""
    B, Sq, Sk, Hq, Hkv, D, causal, packed = WGMMA_CASES[case]
    rng = np.random.default_rng(7)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
            cuda_device, torch.bfloat16)

    if packed:
        qkv = randn(B, Sq, 3, Hq, D)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        q, k, v = randn(B, Sq, Hq, D), randn(B, Sk, Hkv, D), randn(B, Sk, Hkv, D)
    before = dict(_kernels.launch_counts)
    out, lse = _kernels.flash_attn_fwd(q, k, v, causal=causal, sm_scale=D**-0.5)
    torch.cuda.synchronize()
    after, key = _kernels.launch_counts, "flash_attention_fwd/wgmma_tma"
    assert after["flash_attention_fwd"] == before["flash_attention_fwd"] + 1
    assert after[key] == before.get(key, 0) + 1
    ref_out, ref_lse = port.flash_attention_reference(q, k, v, causal=causal, sm_scale=D**-0.5)
    assert torch.isfinite(out.float()).all()
    torch.testing.assert_close(out.float(), ref_out.float(), rtol=0, atol=2e-2)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-3)
