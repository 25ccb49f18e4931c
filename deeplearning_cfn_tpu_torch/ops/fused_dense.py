"""Fused dense — counterpart of ``deeplearning_cfn_tpu/ops/pallas_fused.py``.

``act(x @ w + b)`` for ``x [M, K]``, ``w [K, N]``, ``b [N]`` → ``[M, N]`` in
x's dtype, with the product accumulated in f32 and the bias and activation
applied in f32 (act ∈ {None, "relu", "gelu"}; gelu is the tanh form, JAX's
default, not torch's erf default).  Callers with leading axes flatten to 2-D
around the call (``models/fused_layers.FusedDense`` does).

- Forward: on a CUDA tensor the hand-written kernel ``ops/csrc/fused_dense.cu``
  (built and launched by ``ops/_kernels.py``), which replaces the Pallas
  kernel ``_fused_kernel``: bf16 and f32 on the tensor cores (an f32 x and w
  each split exactly into three bf16 parts, six products of parts).  On a
  CPU tensor :func:`fused_dense_reference`, the plain PyTorch version.  There is no fallback between the two: a CUDA
  tensor launches the kernel or raises.  :func:`force_reference` runs the
  plain version on the card, to hold the kernel against it.
- Backward: the JAX package's ``_core_bwd`` as torch ops (plain XLA there):
  recompute the pre-activation with f32 accumulation, the activation's
  derivative in f32, and f32 products for ``dx`` and ``dw``, each cast to its
  input's dtype.  :class:`FusedDenseFunction` ties the two together in place
  of ``_fused_core`` and its ``custom_vjp``.
- :func:`fused_dense_quantized`: the int8-weight variant (``_quant_kernel``),
  forward only: ``act(f32(x) @ (f32(wq) * scale[N]) + b)``, an f32 product.
  On the card it runs on the bf16 tensor cores without giving up f32: int8
  values are exact in bf16, the per-column scale moves after the sum, and an
  f32 x is split into three bf16 parts whose products sum to the f32 one.

- :func:`fused_dense_profitable`: the dispatch guard, JAX's rule on the
  port's own count.  JAX compares XLA's ``cost_analysis`` bytes of the plain
  path with the kernel's analytic traffic; the port counts the bytes every
  aten op of :func:`fused_dense_reference` reads and writes
  (:func:`plain_dense_bytes`, on ``meta`` tensors: nothing runs).  Eager
  PyTorch writes each intermediate XLA would fuse away, so the port's plain
  count is the larger.  No caller dispatches on it, as in JAX.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import math
from typing import Callable, Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


@functools.lru_cache(maxsize=None)
def _in_dtype(c: float, dtype: torch.dtype) -> float:
    """``c`` rounded to ``dtype``, as JAX rounds a constant to its operand's dtype."""
    return torch.tensor(c, dtype=torch.float32).to(dtype).item()


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default (tanh) form, x · ½(1 + tanh(√(2/π)(x + 0.044715x³))),
    op by op in x's dtype with the constants rounded to it, as JAX computes
    it (torch's own gelu rounds a bf16 result once, JAX at every op)."""
    c1 = _in_dtype(math.sqrt(2.0 / math.pi), x.dtype)
    c2 = _in_dtype(0.044715, x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c1 * (x + c2 * (x * x * x)))))


ACTIVATIONS: dict[str | None, Callable[[torch.Tensor], torch.Tensor]] = {
    None: lambda z: z,
    "relu": torch.relu,
    "gelu": gelu_tanh,
}

_FORCE_REFERENCE: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "fused_dense_force_reference", default=False
)


@contextlib.contextmanager
def force_reference() -> Iterator[None]:
    """Inside the block, :func:`fused_dense` runs the plain version on any
    device: for holding the kernel path against the plain one on the card."""
    token = _FORCE_REFERENCE.set(True)
    try:
        yield
    finally:
        _FORCE_REFERENCE.reset(token)


def _check_activation(activation) -> None:
    if activation not in ACTIVATIONS:
        raise ValueError(
            f"unknown activation {activation!r}; one of {sorted(map(str, ACTIVATIONS))}"
        )


def fused_dense_reference(x, w, b, activation: str | None = None) -> torch.Tensor:
    """The plain version: the product of the f32 upcasts (bf16 products are
    exact in f32, so this is the f32-accumulated product of the stored
    values), f32 bias and activation, cast to x's dtype."""
    acc = torch.matmul(x.to(torch.float32), w.to(torch.float32)) + b.to(torch.float32)
    return ACTIVATIONS[activation](acc).to(x.dtype)


def _quant_reference(x, wq, scale, b, activation, out_dtype) -> torch.Tensor:
    """Plain version of the int8-weight kernel."""
    w = wq.to(torch.float32) * scale.reshape(1, -1).to(torch.float32)
    acc = torch.matmul(x.to(torch.float32), w) + b.to(torch.float32)
    return ACTIVATIONS[activation](acc).to(out_dtype)


def _forward(x, w, b, activation):
    """Device dispatch: the CUDA kernel for CUDA tensors (unless the plain
    version is forced), the plain version for CPU tensors, nothing else."""
    if x.device.type == "cuda" and not _FORCE_REFERENCE.get():
        from deeplearning_cfn_tpu_torch.ops import _kernels

        return _kernels.fused_dense(x, w, b, activation=activation)
    if x.device.type in ("cpu", "cuda"):
        return fused_dense_reference(x, w, b, activation)
    raise ValueError(f"fused_dense runs on cuda or cpu tensors, got {x.device}")


def _activation_grad(z: torch.Tensor, g: torch.Tensor, activation) -> torch.Tensor:
    """d act(z) / dz · g, in f32 (relu's derivative at 0 is 0, as JAX's)."""
    if activation is None:
        return g
    if activation == "relu":
        return torch.where(z > 0, g, torch.zeros_like(g))
    return torch.ops.aten.gelu_backward(g, z, approximate="tanh")


def _core_bwd(x, w, b, g, activation, needs):
    """The JAX package's ``_core_bwd``: ``(dx, dw, db)``, each ``None`` where
    ``needs`` says it is not needed."""
    f32 = torch.float32
    w32 = w.to(f32)
    z = torch.matmul(x.to(f32), w32) + b.to(f32)
    dz = _activation_grad(z, g.to(f32), activation)
    dx = torch.matmul(dz, w32.T).to(x.dtype) if needs[0] else None
    dw = torch.matmul(x.to(f32).T, dz).to(w.dtype) if needs[1] else None
    db = dz.sum(0).to(b.dtype) if needs[2] else None
    return dx, dw, db


class FusedDenseFunction(torch.autograd.Function):
    """Kernel (or plain) forward, ``_core_bwd`` backward as torch ops."""

    @staticmethod
    def forward(ctx, x, w, b, activation):
        out = _forward(x, w, b, activation)
        ctx.save_for_backward(x, w, b)
        ctx.activation = activation
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, b = ctx.saved_tensors
        dx, dw, db = _core_bwd(x, w, b, g, ctx.activation, ctx.needs_input_grad[:3])
        return dx, dw, db, None


def fused_dense(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, activation: str | None = None
) -> torch.Tensor:
    """``activation(x @ w + b)``, ``[M, K] x [K, N]``; differentiable."""
    _check_activation(activation)
    if x.ndim != 2 or w.ndim != 2 or b.ndim != 1:
        raise ValueError(
            f"fused_dense wants x[M,K], w[K,N], b[N]; got "
            f"{tuple(x.shape)}/{tuple(w.shape)}/{tuple(b.shape)}"
        )
    return FusedDenseFunction.apply(x, w, b, activation)


def fused_dense_quantized(
    x: torch.Tensor,
    wq: torch.Tensor,
    scale: torch.Tensor,
    b: torch.Tensor,
    activation: str | None = None,
) -> torch.Tensor:
    """Fused dense with int8 weights, ``wq [K, N]`` and a per-output-channel
    ``scale [N]`` f32, dequantized next to the product; forward only.  The
    result is in x's dtype.

    On a CUDA tensor the kernel computes ``scale * (x @ bf16(wq))`` on the
    bf16 tensor cores (an f32 x as the sum of three bf16 parts ``h + m + l``),
    equal to the plain version's ``x @ (wq * scale)`` up to f32 rounding;
    on a CPU tensor the plain version (:func:`_quant_reference`)."""
    _check_activation(activation)
    if wq.dtype != torch.int8:
        raise ValueError(f"wq must be int8, got {wq.dtype}")
    if x.device.type == "cuda" and not _FORCE_REFERENCE.get():
        from deeplearning_cfn_tpu_torch.ops import _kernels

        return _kernels.fused_dense_quantized(x, wq, scale, b, activation=activation)
    if x.device.type in ("cpu", "cuda"):
        return _quant_reference(x, wq, scale, b, activation, x.dtype)
    raise ValueError(f"fused_dense_quantized runs on cuda or cpu tensors, got {x.device}")


def fused_dense_bytes(m: int, k: int, n: int, itemsize: int) -> int:
    """Device-memory traffic of the fused kernel: x, w and b read once, the
    output written once."""
    return itemsize * (m * k + k * n + n + m * n)


# JAX's margin: the kernel must save at least this share of the plain bytes.
PROFIT_MARGIN = 0.10


class _OpBytes(TorchDispatchMode):
    """Sums the bytes each aten op reads (its tensor inputs, each once) and
    writes (its outputs); views move nothing, and 0-d tensors (the Python
    scalars of an elementwise op) are left out."""

    def __init__(self):
        super().__init__()
        self.nbytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.nbytes += sum(t.numel() * t.element_size()
                               for t in tree_leaves((args, kwargs, out))
                               if isinstance(t, torch.Tensor) and t.dim())
        return out


def plain_dense_bytes(m: int, k: int, n: int, dtype=torch.bfloat16,
                      activation: str | None = "gelu") -> int:
    """Device-memory bytes of the plain path, eager PyTorch's unfused ops of
    :func:`fused_dense_reference` at ``x [m, k]``, ``w [k, n]``, ``b [n]``
    in ``dtype``: each op's inputs read once and its output written once,
    the f32 upcasts, the product, the bias and every op of the activation
    included.  Counted on ``meta`` tensors: nothing executes."""
    _check_activation(activation)
    args = [torch.empty(shape, dtype=dtype, device="meta") for shape in ((m, k), (k, n), (n,))]
    with _OpBytes() as counter:
        fused_dense_reference(*args, activation=activation)
    return counter.nbytes


def fused_dense_profitable(m: int, k: int, n: int, dtype=torch.bfloat16,
                           activation: str | None = "gelu") -> bool:
    """JAX's dispatch check (``pallas_fused.py``), with the port's count of
    the plain path's traffic (:func:`plain_dense_bytes`) where JAX reads
    XLA's ``bytes accessed``: True only when the fused kernel's analytic
    traffic (:func:`fused_dense_bytes`) saves at least
    :data:`PROFIT_MARGIN` of it.  Nothing executes."""
    plain = plain_dense_bytes(m, k, n, dtype, activation)
    if not plain:
        return False
    fused = fused_dense_bytes(m, k, n, torch.empty((), dtype=dtype).element_size())
    return fused < plain * (1.0 - PROFIT_MARGIN)
