"""The matrix products the references run, at a stated precision.

``"f32"``: ``torch.matmul``/``conv2d`` in float32 (the caller turns TF32
off).  ``"fp8"``: the control, the step below the bf16 the configurations
state: every operand of every product, forward and backward, rounded to
fp8 with a per-tensor scale (e4m3 for weights and activations, e5m2 for
gradients, as fp8 training recipes do), the product then taken in f32."""

from __future__ import annotations

import torch
import torch.nn.functional as F

_FORMATS = {"e4m3": (torch.float8_e4m3fn, 448.0), "e5m2": (torch.float8_e5m2, 57344.0)}


def quantize(x: torch.Tensor, fmt: str = "e4m3") -> torch.Tensor:
    """``x`` rounded to fp8 under one scale that maps its largest magnitude
    to the format's largest finite value; returned in ``x``'s dtype."""
    dtype, top = _FORMATS[fmt]
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = top / amax
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = quantize(a), quantize(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = quantize(g, "e5m2")
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


class _Fp8Conv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride, padding):
        qx, qw = quantize(x), quantize(w)
        ctx.save_for_backward(qx, qw)
        ctx.conf = (stride, padding)
        return F.conv2d(qx, qw, stride=stride, padding=padding)

    @staticmethod
    def backward(ctx, g):
        qx, qw = ctx.saved_tensors
        stride, padding = ctx.conf
        qg = quantize(g, "e5m2")
        gx = torch.nn.grad.conv2d_input(qx.shape, qw, qg, stride=stride, padding=padding)
        gw = torch.nn.grad.conv2d_weight(qx, qw.shape, qg, stride=stride, padding=padding)
        return gx, gw, None, None


class Products:
    """``mm(a, b)`` and ``conv(x, w, stride, padding)`` at ``precision``."""

    def __init__(self, precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision must be f32 or fp8, got {precision!r}")
        self.precision = precision

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            return _Fp8Matmul.apply(a, b)
        return a @ b

    def conv(self, x: torch.Tensor, w: torch.Tensor, stride: int, padding) -> torch.Tensor:
        if self.precision == "fp8":
            return _Fp8Conv.apply(x, w, stride, padding)
        return F.conv2d(x, w, stride=stride, padding=padding)


class no_tf32:
    """Float32 products in float32 inside the block (cuBLAS and cuDNN)."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                      torch.get_float32_matmul_precision())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32, prec) = self.saved
        torch.set_float32_matmul_precision(prec)
