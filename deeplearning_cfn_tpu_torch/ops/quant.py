"""Symmetric int8 weight quantization — the port's copy of
``deeplearning_cfn_tpu/ops/quant.py``.

Per-output-channel symmetric quantization: ``w ≈ wq * scale`` with ``wq``
int8 and ``scale = max|w| / 127`` over every axis but the last; zero-range
channels get scale 1.  Rounding is half to even, as ``jnp.round``.  The tree
functions walk a ``state_dict`` (dotted names) where the JAX package walks a
parameter pytree, and quantize the same leaves: rank >= 2 tensors whose leaf
name is ``kernel``.  Where the port stores a kernel in another shape than the
JAX leaf (BERT's ``qkv``: Flax ``[dim, 3, H, hd]``, stored ``[dim, 3*dim]``),
the caller passes the leaf's shape, and the kernel is quantized in it, so its
scales are the JAX package's (per ``hd`` there, not per stored column).
"""

from __future__ import annotations

import torch


def _symmetric(w32: torch.Tensor, amax: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    wq = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return wq, scale


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``w [..., N] float`` -> ``(wq int8 same shape, scale [N] f32)``."""
    w32 = w.to(torch.float32)
    amax = w32.abs()
    if w.ndim > 1:
        amax = amax.amax(dim=tuple(range(w.ndim - 1)))
    return _symmetric(w32, amax)


def dequantize_weight(wq: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return (wq.to(torch.float32) * scale.to(torch.float32)).to(dtype)


def quantize_flat(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``v [N] float`` -> ``(q int8 [N], scale scalar f32)``: one scale over
    the whole vector."""
    v32 = v.to(torch.float32)
    return _symmetric(v32, v32.abs().amax())


def dequantize_flat(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale.to(torch.float32)).to(dtype)


def _is_quantizable(name: str, t: torch.Tensor) -> bool:
    """Kernels only: rank >= 2 tensors whose leaf name is 'kernel'.  Biases,
    norm scales and offsets stay float."""
    return name.rsplit(".", 1)[-1] == "kernel" and t.ndim >= 2


def quantize_tree(
    state: dict[str, torch.Tensor], leaf_shapes: dict[str, tuple[int, ...]] | None = None
) -> tuple[dict, dict]:
    """Split a state dict into int8 kernels and everything else, both keyed
    like ``state``: ``quantized[name]`` is ``{"wq", "scale", "dtype",
    "shape"}`` at a kernel and None elsewhere; ``passthrough[name]`` is the
    float tensor where it was not quantized and None at a kernel.

    ``leaf_shapes`` maps a kernel's name to the shape of its JAX leaf where
    that differs from the stored one (``models.bert.jax_kernel_shapes``): the
    kernel is viewed in that shape before it is quantized, so ``wq`` and
    ``scale`` are the JAX package's; ``shape`` is the stored shape that
    :func:`dequantize_tree` restores."""
    leaf_shapes = leaf_shapes or {}
    quantized, passthrough = {}, {}
    for name, t in state.items():
        if _is_quantizable(name, t):
            wq, scale = quantize_weight(t.reshape(leaf_shapes.get(name, t.shape)))
            quantized[name] = {"wq": wq, "scale": scale, "dtype": t.dtype, "shape": tuple(t.shape)}
            passthrough[name] = None
        else:
            quantized[name], passthrough[name] = None, t
    return quantized, passthrough


def dequantize_tree(quantized: dict, passthrough: dict) -> dict[str, torch.Tensor]:
    """Inverse of :func:`quantize_tree`: a float state dict in the stored shapes."""
    return {
        name: passthrough[name] if q is None
        else dequantize_weight(q["wq"], q["scale"], q["dtype"]).reshape(q["shape"])
        for name, q in quantized.items()
    }
