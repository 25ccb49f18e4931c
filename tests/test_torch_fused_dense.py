"""The port's fused dense against the JAX package's Pallas fused dense.

On the CPU the JAX side runs the Pallas kernels in interpret mode and the
port runs its plain versions, on the same numpy inputs.  Tolerances:

- f32: both accumulate the same products in f32 in another order (K <= 256
  terms of O(1/sqrt(K)) each), so 1e-5 relative and absolute.
- bf16 outputs: both take the f32 sum and round it to bf16 once, and the sums
  differ in their last f32 bits, so an output whose sum lies next to a
  rounding boundary may land one bf16 ulp apart: 2**-7 relative.
- gradients: the same f32 products in another order; dx and dw are rounded
  to bf16 on the bf16 cases, so the same one-ulp rule applies there.
- quantization: the same f32 divisions and round-half-to-even, so equal.
- the int8-weight kernel's tensor-core arithmetic (an f32 x as three bf16
  parts, each times bf16(wq), the scale after the sum), emulated in plain
  torch: the same f32 function as the plain version up to f32 rounding, so
  the f32 tolerance.
- the f32 fused dense's tensor-core arithmetic (x and w each as three bf16
  parts, six products of parts, K split into runs summed in rank order),
  emulated likewise: the f32 tolerance.  On operands spread over 80 binades
  its error is held to the worst-case bound of an f32 product, K + 2 units
  of 2**-24 of sum |x| |w|.

The CUDA kernels are held to the plain versions by the ``cuda`` tests at the
end, on a card (``python -m pytest -m cuda tests/test_torch_fused_dense.py``;
the card's host has no JAX, so the JAX comparisons skip there); each case
also checks the variant its launch was counted under.  f32 sums of K 2048
terms (the ResNet-50 head) are held at ``chip_smoke.py``'s f32 tolerance,
1e-4: two f32 sums of that many O(1) terms in another order differ by up to
~1e-5 already.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:
    import jax
    import jax.numpy as jnp

    from deeplearning_cfn_tpu.models import fused_layers as jax_fused_layers
    from deeplearning_cfn_tpu.ops import pallas_fused as jax_fused
    from deeplearning_cfn_tpu.ops import quant as jax_quant
except ImportError:  # the card's host: only the tests without the JAX reference run
    jax = None

from deeplearning_cfn_tpu_torch.models.fused_layers import FusedDense  # noqa: E402
from deeplearning_cfn_tpu_torch.ops import _kernels, quant  # noqa: E402
from deeplearning_cfn_tpu_torch.ops import fused_dense as port  # noqa: E402

torch.set_num_threads(1)

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2**-7, atol=1e-5)
ACTIVATIONS = [None, "relu", "gelu"]
# (M, K, N): one aligned shape and the ragged one (no dim a multiple of a tile).
SHAPES = {"aligned": (32, 128, 256), "ragged": (37, 200, 300)}

needs_jax = pytest.mark.skipif(jax is None, reason="needs JAX, the reference")


def _operands(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    b = (0.1 * rng.standard_normal(n)).astype(np.float32)
    return x, w, b


def _torch(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _jax(a, dtype):
    return jnp.asarray(a, jnp.float32).astype(dtype)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _dtypes(name):
    return (torch.float32, jnp.float32, F32_TOL) if name == "f32" else (
        torch.bfloat16, jnp.bfloat16, BF16_TOL)


@needs_jax
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_forward_matches_pallas_interpret(activation, shape, dtype):
    tdt, jdt, tol = _dtypes(dtype)
    x, w, b = _operands(*SHAPES[shape])
    got = port.fused_dense(_torch(x, tdt), _torch(w, tdt), _torch(b, tdt), activation=activation)
    ref = jax_fused.fused_dense(_jax(x, jdt), _jax(w, jdt), _jax(b, jdt), activation=activation,
                                interpret=True)
    assert got.dtype == tdt and got.shape == ref.shape
    np.testing.assert_allclose(_f32(got), _f32(ref), **tol)


@needs_jax
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_gradients_match_jax_custom_vjp(activation, dtype):
    tdt, jdt, tol = _dtypes(dtype)
    x, w, b = _operands(*SHAPES["ragged"], seed=1)
    r = np.random.default_rng(2).standard_normal((x.shape[0], w.shape[1])).astype(np.float32)

    def jloss(x, w, b):
        out = jax_fused.fused_dense(x, w, b, activation=activation, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * r)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(_jax(x, jdt), _jax(w, jdt), _jax(b, jdt))
    tx, tw, tb = (_torch(a, tdt).requires_grad_() for a in (x, w, b))
    out = port.fused_dense(tx, tw, tb, activation=activation)
    (out.to(torch.float32) * torch.from_numpy(r)).sum().backward()
    for name, t, j in (("dx", tx, jgrads[0]), ("dw", tw, jgrads[1]), ("db", tb, jgrads[2])):
        assert t.grad.dtype == tdt, name
        np.testing.assert_allclose(_f32(t.grad), _f32(j), err_msg=name, **tol)


@needs_jax
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_quantized_matches_pallas_interpret(activation, dtype):
    tdt, jdt, tol = _dtypes(dtype)
    x, w, b = _operands(*SHAPES["ragged"], seed=3)
    wq, scale = (np.array(a) for a in jax_quant.quantize_weight(jnp.asarray(w)))
    ref = jax_fused.fused_dense_quantized(
        _jax(x, jdt), jnp.asarray(wq), jnp.asarray(scale), _jax(b, jdt),
        activation=activation, interpret=True,
    )
    got = port.fused_dense_quantized(
        _torch(x, tdt), torch.from_numpy(wq), torch.from_numpy(scale), _torch(b, tdt),
        activation=activation,
    )
    assert got.dtype == tdt
    np.testing.assert_allclose(_f32(got), _f32(ref), **tol)


def _truncate_bf16(a):
    """The top 16 bits of each f32: its bf16 truncation, as an f32."""
    return (a.view(torch.int32) & -65536).view(torch.float32)


def _split3(a):
    """An f32 tensor as the kernels' three bf16 parts, h + m + l = a exactly:
    h = its top 8 significant bits, m = the next 8 of a - h, l = a - h - m."""
    h = _truncate_bf16(a)
    m = _truncate_bf16(a - h)
    return [h, m, a - h - m]


def _parts_product(xs, ws, pairs, splits=1, chunk=32, promote=False):
    """sum of ``xs[i] @ ws[j]`` over ``(i, j)`` in ``pairs`` with f32
    accumulation, as the kernels sum: K cut into ``chunk``-deep chunks and
    the chunks into ``splits`` contiguous runs, as a cluster of the f32
    kernel cuts them, each run's sum added in rank order.  A run's products
    are summed in ``pairs`` order; with ``promote`` (the f32 dense), chunk
    by chunk, each chunk's sum added into the run's."""
    num_k = -(-xs[0].shape[1] // chunk)
    total = None
    for r in range(splits):
        k0, k1 = num_k * r // splits, num_k * (r + 1) // splits
        bounds = [(kt, kt + 1) for kt in range(k0, k1)] if promote else [(k0, k1)]
        run = None
        for lo, hi in bounds:
            lo, hi = lo * chunk, hi * chunk
            part = sum(torch.matmul(xs[i][:, lo:hi], ws[j][lo:hi]) for i, j in pairs)
            run = part if run is None else run + part
        total = run if total is None else total + run
    return total


def _split_product(x, wq, scale, b, activation, parts):
    """The int8-weight kernel's tensor-core arithmetic in plain torch, in f32:
    x as ``parts`` bf16 parts (a bf16 x as itself; an f32 x as h, m, l), each
    multiplied by bf16(wq) with f32 accumulation (the products are exact),
    the scale applied after the sum, then the bias and activation."""
    wb = wq.to(torch.bfloat16).to(torch.float32)
    x = x.to(torch.float32)
    pieces = [x] if parts == 1 else _split3(x)
    pairs = [(i, 0) for i in reversed(range(parts))]  # l, m, then h, as the kernel
    acc = _parts_product(pieces, [wb], pairs)
    return port.ACTIVATIONS[activation](acc * scale + b.to(torch.float32)), pieces


# The f32 kernel's products of parts, (x part, w part) by index into
# (h, m, l), in its order, smallest first: l.h, h.l, m.m, m.h, h.m, h.h.  The
# three left out (m.l, l.m, l.l) are below 2**-23 |x| |w| together.
F32_PAIRS = ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0))


def _f32_split_dense(x, w, b, activation, splits):
    """The f32 fused dense's tensor-core arithmetic in plain torch: x and w
    each in three bf16 parts, the six products of parts in the kernel's
    order, each K chunk's sum added into the running sum, split-K partials
    in rank order, then the bias and activation."""
    acc = _parts_product(_split3(x), _split3(w), F32_PAIRS, splits, promote=True)
    return port.ACTIVATIONS[activation](acc + b)


@needs_jax
@pytest.mark.parametrize("x_dtype,parts", [("f32", 3), ("bf16", 1)])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_quantized_tensor_core_arithmetic_matches_pallas_interpret(activation, shape, x_dtype,
                                                                    parts):
    """The card's design computes the TPU kernel's f32 function: bf16 parts of
    x times bf16(wq), the scale after the sum.  Held in f32 to the plain
    version and, in x's dtype, to the Pallas kernel in interpret mode."""
    tdt, jdt, tol = _dtypes(x_dtype)
    x, w, b = _operands(*SHAPES[shape], seed=7)
    wq, scale = (np.array(a) for a in jax_quant.quantize_weight(jnp.asarray(w)))
    tx, twq, tscale, tb = _torch(x, tdt), torch.from_numpy(wq), torch.from_numpy(scale), _torch(b, tdt)
    got, pieces = _split_product(tx, twq, tscale, tb, activation, parts)
    for piece in pieces:  # every part is exact in bf16, and together they are x
        assert torch.equal(piece.to(torch.bfloat16).to(torch.float32), piece)
    if parts == 3:
        assert torch.equal(pieces[0] + pieces[1] + pieces[2], tx)
    plain = port._quant_reference(tx, twq, tscale, tb, activation, torch.float32)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **F32_TOL)
    ref = jax_fused.fused_dense_quantized(
        _jax(x, jdt), jnp.asarray(wq), jnp.asarray(scale), _jax(b, jdt),
        activation=activation, interpret=True,
    )
    np.testing.assert_allclose(_f32(got.to(tdt)), _f32(ref), **tol)


@needs_jax
@pytest.mark.parametrize("splits", [1, 2, 4])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_f32_tensor_core_arithmetic_matches_pallas_interpret(activation, shape, splits):
    """The card's f32 design computes the TPU kernel's f32 function: six
    products of bf16 parts of x and w, without a split of K and split across
    a cluster of 2 or 4 CTAs.  Held to the plain version and to the Pallas
    kernel in interpret mode, in f32."""
    x, w, b = _operands(*SHAPES[shape], seed=10)
    tx, tw, tb = (_torch(a, torch.float32) for a in (x, w, b))
    got = _f32_split_dense(tx, tw, tb, activation, splits)
    plain = port.fused_dense_reference(tx, tw, tb, activation)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **F32_TOL)
    ref = jax_fused.fused_dense(_jax(x, jnp.float32), _jax(w, jnp.float32), _jax(b, jnp.float32),
                                activation=activation, interpret=True)
    np.testing.assert_allclose(got.numpy(), _f32(ref), **F32_TOL)


def _spread(shape, seed, lo, hi):
    """Standard normal values times 2**e, e uniform in [lo, hi], every
    seventh value zero."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape) * np.exp2(rng.integers(lo, hi + 1, size=shape))
    a.flat[::7] = 0.0
    return a.astype(np.float32)


# Binades of x and w (2**lo .. 2**hi): products stay normal f32, far from
# overflow and from the subnormals, where bf16 and f32 differ.
SPREADS = {"unit": (0, 0), "tiny": (-40, -30), "large": (30, 40), "mixed": (-40, 40)}


@pytest.mark.parametrize("spread", list(SPREADS))
def test_f32_split_is_exact_and_the_products_f32_accurate(spread):
    """Every part of the split is exact in bf16 and the parts sum to the
    operand, in any binade; the six products then carry no more error than
    an f32 product's worst case, K + 2 units of 2**-24 of sum |x| |w| (K
    roundings of the sum, and the three products left out)."""
    lo, hi = SPREADS[spread]
    m, k, n = SHAPES["ragged"]
    x, w = _spread((m, k), 11, lo, hi), _spread((k, n), 12, lo, hi)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    for a in (tx, tw):
        parts = _split3(a)
        for part in parts:
            assert torch.equal(part.to(torch.bfloat16).to(torch.float32), part)
        assert torch.equal(parts[0] + parts[1] + parts[2], a)
    got = _parts_product(_split3(tx), _split3(tw), F32_PAIRS, splits=2,
                         promote=True).double().numpy()
    exact = x.astype(np.float64) @ w.astype(np.float64)
    bound = (k + 2) * 2.0**-24 * (np.abs(x).astype(np.float64) @ np.abs(w).astype(np.float64))
    assert np.all(np.abs(got - exact) <= bound)
    plain = (tx @ tw).double().numpy()  # the plain version's f32 product, for scale
    assert np.all(np.abs(plain - exact) <= bound)


@needs_jax
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("activation", [None, "gelu"])
def test_fused_dense_module_matches_jax_module(activation, dtype):
    tdt, jdt, tol = _dtypes(dtype)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32)
    jmod = jax_fused_layers.FusedDense(40, activation=activation, dtype=jdt)
    params = jmod.init(jax.random.key(0), jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(lambda a: a + 0.1, params)  # a non-zero bias
    mod = FusedDense(48, 40, activation=activation, dtype=tdt)
    mod.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in params.items()})
    ref = jmod.apply({"params": params}, jnp.asarray(x))
    got = mod(torch.from_numpy(x))
    assert got.shape == (2, 5, 40) and got.dtype == tdt
    np.testing.assert_allclose(_f32(got), _f32(ref), **tol)


def test_fused_dense_module_init_distributions():
    mod = FusedDense(512, 256, generator=torch.Generator().manual_seed(0))
    k = mod.kernel.detach()
    # lecun normal: truncated at two standard deviations, variance 1/fan_in.
    np.testing.assert_allclose(k.std().item(), 512**-0.5, rtol=0.02)
    assert k.abs().max().item() <= 2 * 512**-0.5 / 0.87962566103423978
    assert torch.count_nonzero(mod.bias) == 0


@needs_jax
@pytest.mark.parametrize("shape", [(64,), (48, 40), (3, 3, 8, 16)])
def test_quantize_weight_matches_jax(shape):
    w = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    w[..., 0] = 0.0  # a zero-range channel takes scale 1
    jwq, jscale = jax_quant.quantize_weight(jnp.asarray(w))
    wq, scale = quant.quantize_weight(torch.from_numpy(w))
    assert wq.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    np.testing.assert_array_equal(
        quant.dequantize_weight(wq, scale).numpy(),
        np.asarray(jax_quant.dequantize_weight(jwq, jscale)),
    )
    q, s = quant.quantize_flat(torch.from_numpy(w.reshape(-1)))
    jq, js = jax_quant.quantize_flat(jnp.asarray(w.reshape(-1)))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.item() == float(js)
    np.testing.assert_array_equal(quant.dequantize_flat(q, s).numpy(),
                                  np.asarray(jax_quant.dequantize_flat(jq, js)))


@needs_jax
def test_quantize_tree_matches_jax():
    rng = np.random.default_rng(6)
    tree = {
        "dense": {"kernel": rng.standard_normal((16, 8)).astype(np.float32),
                  "bias": rng.standard_normal(8).astype(np.float32)},
        "norm": {"scale": rng.standard_normal(8).astype(np.float32)},
        "conv": {"kernel": rng.standard_normal((3, 3, 4, 8)).astype(np.float32)},
        "vec": {"kernel": rng.standard_normal(8).astype(np.float32)},  # rank 1: stays float
    }
    jq, jp = jax_quant.quantize_tree(jax.tree_util.tree_map(jnp.asarray, tree))
    jback = jax_quant.dequantize_tree(jq, jp)
    state = {f"{a}.{b}": torch.from_numpy(v) for a, d in tree.items() for b, v in d.items()}
    q, p = quant.quantize_tree(state)
    assert [k for k, v in q.items() if v is not None] == ["dense.kernel", "conv.kernel"]
    for name in ("dense", "conv"):
        np.testing.assert_array_equal(q[f"{name}.kernel"]["wq"].numpy(),
                                      np.asarray(jq[name]["kernel"]["wq"]))
        np.testing.assert_array_equal(q[f"{name}.kernel"]["scale"].numpy(),
                                      np.asarray(jq[name]["kernel"]["scale"]))
    assert p["dense.kernel"] is None and p["norm.scale"] is state["norm.scale"]
    back = quant.dequantize_tree(q, p)
    for key, v in back.items():
        a, b = key.split(".")
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), np.asarray(jback[a][b]))


@needs_jax
def test_fused_dense_bytes_matches_jax():
    assert port.fused_dense_bytes(4096, 768, 3072, 2) == jax_fused.fused_dense_bytes(4096, 768, 3072, 2)


def test_argument_errors():
    x, w, b = (torch.zeros(s) for s in ((4, 8), (8, 3), (3,)))
    with pytest.raises(ValueError, match="unknown activation"):
        port.fused_dense(x, w, b, activation="tanh")
    with pytest.raises(ValueError, match="x\\[M,K\\]"):
        port.fused_dense(x[None], w, b)
    with pytest.raises(ValueError, match="x\\[M,K\\]"):
        port.fused_dense(x, w, b[None])
    with pytest.raises(ValueError, match="int8"):
        port.fused_dense_quantized(x, w, torch.ones(3), b)
    with pytest.raises(ValueError, match="unknown activation"):
        port.fused_dense_quantized(x, w.to(torch.int8), torch.ones(3), b, activation="silu")
    # The CUDA wrappers refuse what the kernels do not take, before any build.
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.fused_dense(x, w, b, activation=None)
    with pytest.raises(TypeError, match="one dtype"):
        _kernels.fused_dense(x, w.to(torch.bfloat16), b, activation=None)
    with pytest.raises(TypeError, match="int8 wq"):
        _kernels.fused_dense_quantized(x, w, torch.ones(3), b, activation=None)


def test_force_reference_is_scoped():
    assert not port._FORCE_REFERENCE.get()
    with port.force_reference():
        assert port._FORCE_REFERENCE.get()
    assert not port._FORCE_REFERENCE.get()


# --- on the card -------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in true f32
    return torch.device("cuda")


F32_SPLITK = "wgmma_tma_bf16x6_splitk_128x192"
F32_COOP = "wgmma_tma_bf16x6_128x192"

# (M, K, N, dtype, variant the launcher picks on an H100): the bf16 wgmma/TMA
# kernel (16-byte rows), the same with a ragged K chunk and ragged M, the
# mma.sync kernel (N not a multiple of 8); the f32 tensor-core kernel split
# across a cluster where 128 x 192 tiles leave half the SMs idle (ragged M,
# N and K; aligned; the ResNet-50 head), without a split where they do not,
# and the CUDA-core kernel where N is not a multiple of 4.
CUDA_CASES = {
    "bf16-aligned": (256, 256, 384, torch.bfloat16, "wgmma_tma_128x192"),
    "bf16-ragged-k": (37, 200, 304, torch.bfloat16, "wgmma_tma_128x192"),
    "bf16-ragged": (37, 200, 300, torch.bfloat16, "mma_sync"),
    "f32-ragged": (37, 200, 300, torch.float32, F32_SPLITK),
    "f32-aligned": (256, 256, 384, torch.float32, F32_SPLITK),
    "f32-ragged-mk": (37, 200, 304, torch.float32, F32_SPLITK),
    "f32-head": (128, 2048, 1000, torch.float32, F32_SPLITK),
    "f32-many-tiles": (2048, 256, 2048, torch.float32, F32_COOP),
    "f32-n301": (37, 200, 301, torch.float32, "simt"),
}


def _cuda_operands(m, k, n, dtype, device, seed=0):
    return tuple(_torch(a, dtype).to(device) for a in _operands(m, k, n, seed))


def _dense_tol(dtype):
    return BF16_TOL if dtype == torch.bfloat16 else F32_TOL


def _check_dense_launch(x, w, b, activation, variant):
    """One launch through the public entry point, counted under ``variant``,
    against the plain version; returns the kernel's output."""
    before = dict(_kernels.launch_counts)
    got = port.fused_dense(x, w, b, activation=activation)
    torch.cuda.synchronize()
    key = f"fused_dense/{variant}"
    assert _kernels.launch_counts["fused_dense"] == before["fused_dense"] + 1
    assert _kernels.launch_counts.get(key, 0) == before.get(key, 0) + 1, dict(_kernels.launch_counts)
    ref = port.fused_dense_reference(x, w, b, activation)
    assert got.dtype == x.dtype and torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), ref.float(), **_dense_tol(x.dtype))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("case", list(CUDA_CASES))
def test_kernel_matches_plain_version_on_card(cuda_device, case, activation):
    m, k, n, dtype, variant = CUDA_CASES[case]
    x, w, b = _cuda_operands(m, k, n, dtype, cuda_device)
    _check_dense_launch(x, w, b, activation, variant)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(128, 2048, 1000), (1024, 768, 1024)])
def test_f32_error_is_an_f32_sums_on_card(cuda_device, shape):
    """Against a float64 reference, the f32 kernel's largest error is within
    twice f32 ``addmm``'s (TF32 off) at the ResNet-50 head (split-K) and at
    K 768 without a split: the kernel sums as an f32 product does."""
    m, k, n = shape
    x, w, b = _cuda_operands(m, k, n, torch.float32, cuda_device, seed=13)
    exact = x.double() @ w.double() + b.double()
    kernel_err = (port.fused_dense(x, w, b).double() - exact).abs().max().item()
    addmm_err = (torch.addmm(b, x, w).double() - exact).abs().max().item()
    assert kernel_err <= 2 * addmm_err, (kernel_err, addmm_err)


@pytest.mark.cuda
def test_f32_split_k_is_deterministic_on_card(cuda_device):
    """The cluster sums its partial tiles in rank order: two calls give the
    same bits."""
    x, w, b = _cuda_operands(128, 2048, 1000, torch.float32, cuda_device, seed=10)
    first = _check_dense_launch(x, w, b, None, F32_SPLITK)
    for _ in range(3):
        assert torch.equal(_kernels.fused_dense(x, w, b, activation=None), first)


# f32 views with row strides 200 (x) and 300 (w), 16-byte rows: N 248 reads
# through TMA (split-K), N 250 is not a multiple of 4 (CUDA cores).
F32_VIEWS = {"tma": (248, F32_SPLITK), "simt": (250, "simt")}


@pytest.mark.cuda
@pytest.mark.parametrize("view", list(F32_VIEWS))
def test_f32_kernel_reads_row_strides_on_card(cuda_device, view):
    n, variant = F32_VIEWS[view]
    x, w, b = _cuda_operands(64, 200, 300, torch.float32, cuda_device, seed=11)
    xs, ws = x[:, :120], w[:120, :n]
    assert xs.stride(0) == 200 and ws.stride(0) == 300
    _check_dense_launch(xs, ws, b[:n], "gelu", variant)


@pytest.mark.cuda
def test_kernel_reads_row_strides_on_card(cuda_device):
    x, w, b = _cuda_operands(64, 200, 300, torch.bfloat16, cuda_device)
    xs, ws = x[:, :120], w[:120, :250]  # row strides 200 and 300: w rows off 16 bytes
    got = _kernels.fused_dense(xs, ws, b[:250], activation="gelu")
    ref = port.fused_dense_reference(xs, ws, b[:250], "gelu")
    torch.testing.assert_close(got.float(), ref.float(), **BF16_TOL)


def _quant_variant(dtype, mode):
    """The int8-weight launcher's variant name: ``simt``, or the wgmma kernel
    with one bf16 part of x (bf16 x) or three (f32 x) in ``mode``."""
    if mode == "simt":
        return "simt"
    return f"wgmma_tma_bf16x{1 if dtype == torch.bfloat16 else 3}_{mode}"


def _check_quant_launch(x, wq, scale, b, activation, variant):
    """One launch through the public entry point, counted under ``variant``,
    against the plain version; returns the kernel's output."""
    before = dict(_kernels.launch_counts)
    got = port.fused_dense_quantized(x, wq, scale, b, activation=activation)
    torch.cuda.synchronize()
    key = f"fused_dense_quantized/{variant}"
    assert _kernels.launch_counts["fused_dense_quantized"] == before["fused_dense_quantized"] + 1
    assert _kernels.launch_counts[key] == before.get(key, 0) + 1
    ref = port._quant_reference(x, wq, scale, b, activation, x.dtype)
    tol = BF16_TOL if x.dtype == torch.bfloat16 else F32_TOL
    assert got.dtype == x.dtype
    torch.testing.assert_close(got.float(), ref.float(), **tol)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantized_kernel_matches_plain_version_on_card(cuda_device, dtype):
    x, w, b = _cuda_operands(37, 200, 300, dtype, cuda_device)
    wq, scale = quant.quantize_weight(w.float())
    _check_quant_launch(x, wq, scale, b, "relu", "simt")  # N 300: wq rows off 16 bytes


# (M, K, N, mode): the wgmma route on 16-byte rows (cooperative 128 x 192
# tiles), with more tiles than an H100 has SMs, with a ragged K chunk, with
# ragged M (TMA's zero fill in every part) and at BERT-base's mlp_in (K 768,
# twelve K chunks summed at the f32 tolerance); the CUDA-core kernel where N
# is not a multiple of 16.
QUANT_CUDA_CASES = {
    "aligned": (256, 256, 384, "128x192"),
    "many-tiles": (4096, 128, 2048, "128x192"),
    "ragged-k": (64, 200, 304, "128x192"),
    "ragged-m": (1000, 256, 256, "128x192"),
    "mlp_in": (4096, 768, 3072, "128x192"),
    "simt": (37, 200, 300, "simt"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(QUANT_CUDA_CASES))
def test_quantized_kernel_variants_match_plain_version_on_card(cuda_device, case, dtype,
                                                                activation):
    m, k, n, mode = QUANT_CUDA_CASES[case]
    x, w, b = _cuda_operands(m, k, n, dtype, cuda_device, seed=8)
    wq, scale = quant.quantize_weight(w.float())
    _check_quant_launch(x, wq, scale, b, activation, _quant_variant(dtype, mode))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4096, 768, 3072), (1000, 200, 304)])
def test_quantized_f32_error_is_an_f32_sums_on_card(cuda_device, shape):
    """Against a float64 reference, the int8-weight kernel's largest error
    with an f32 x is within twice f32 ``addmm``'s on the dequantised weight
    (TF32 off), at BERT-base's mlp_in (K 768) and at K 200 with a ragged K
    chunk: each K chunk's products are summed apart and added into the
    running sum on the CUDA cores, as an f32 product sums."""
    m, k, n = shape
    x, w, b = _cuda_operands(m, k, n, torch.float32, cuda_device, seed=14)
    wq, scale = quant.quantize_weight(w)
    exact = x.double() @ (wq.double() * scale.double()) + b.double()
    got = _check_quant_launch(x, wq, scale, b, None, _quant_variant(torch.float32, "128x192"))
    kernel_err = (got.double() - exact).abs().max().item()
    addmm_err = (torch.addmm(b, x, quant.dequantize_weight(wq, scale)).double() - exact)
    addmm_err = addmm_err.abs().max().item()
    assert kernel_err <= 2 * addmm_err, (kernel_err, addmm_err)


# Views with row strides: x rows 256 elements apart, wq rows 320 apart (16
# bytes: the wgmma route) or 300 apart (the CUDA-core kernel).
QUANT_VIEWS = {"tma": (320, "128x192"), "simt": (300, "simt")}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("view", list(QUANT_VIEWS))
def test_quantized_kernel_reads_row_strides_on_card(cuda_device, view, dtype):
    ldw, mode = QUANT_VIEWS[view]
    x, w, b = _cuda_operands(64, 256, ldw, dtype, cuda_device, seed=9)
    wq, scale = quant.quantize_weight(w.float())
    xs, wqs = x[:, :200], wq[:200, :288]
    assert xs.stride(0) == 256 and wqs.stride(0) == ldw
    _check_quant_launch(xs, wqs, scale[:288], b[:288], "gelu",
                        _quant_variant(dtype, mode))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gradients_through_kernel_match_plain_autograd_on_card(cuda_device, dtype):
    """The backward reads only x, w, b and g, so the kernel forward and the
    plain one give the same gradients."""
    base = _cuda_operands(64, 96, 80, dtype, cuda_device)
    r = torch.randn(64, 80, device=cuda_device)
    kx, kw, kb = (t.clone().requires_grad_() for t in base)
    px, pw, pb = (t.clone().requires_grad_() for t in base)
    (port.FusedDenseFunction.apply(kx, kw, kb, "gelu").float() * r).sum().backward()
    (port.fused_dense_reference(px, pw, pb, "gelu").float() * r).sum().backward()
    tol = BF16_TOL if dtype == torch.bfloat16 else F32_TOL
    for a, p in ((kx, px), (kw, pw), (kb, pb)):
        torch.testing.assert_close(a.grad.float(), p.grad.float(), **tol)


# (M, K, N, activation, variant): the wgmma/TMA kernel at BERT-base's MLP
# shapes and at ragged M, K and N with 16-byte-aligned rows (TMA's zero fill
# and the epilogue's guards), with the mode the launcher picks on an H100
# (132 SMs): ping-pong where there are two 128 x 128 tiles or more an SM.
WGMMA_DENSE_CASES = {
    "mlp_in": (4096, 768, 3072, "gelu", "wgmma_tma_pingpong_128x128"),
    "mlp_out": (4096, 3072, 768, None, "wgmma_tma_128x192"),
    "aligned-ragged": (1000, 200, 304, "relu", "wgmma_tma_128x192"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(WGMMA_DENSE_CASES))
def test_wgmma_kernel_matches_plain_version_on_card(cuda_device, case):
    m, k, n, activation, variant = WGMMA_DENSE_CASES[case]
    x, w, b = _cuda_operands(m, k, n, torch.bfloat16, cuda_device, seed=5)
    before = dict(_kernels.launch_counts)
    got = _kernels.fused_dense(x, w, b, activation=activation)
    torch.cuda.synchronize()
    key = f"fused_dense/{variant}"
    assert _kernels.launch_counts["fused_dense"] == before["fused_dense"] + 1
    assert _kernels.launch_counts[key] == before.get(key, 0) + 1
    ref = port.fused_dense_reference(x, w, b, activation)
    torch.testing.assert_close(got.float(), ref.float(), **BF16_TOL)
