"""ResNet v1.5 (50/101/152) — counterpart of ``deeplearning_cfn_tpu/models/resnet.py``.

The model takes NHWC images, as the JAX one does.  Inside, the NHWC batch is
viewed as NCHW (``permute(0, 3, 1, 2)`` of a contiguous NHWC tensor is a
``channels_last`` tensor, no copy), so the convolutions run channels-last in
cuDNN (the JAX package computes them in XLA, outside any Pallas kernel).
What changes the numbers, and how the port keeps Flax's:

- ``SAME`` padding is Flax's: ``total = max((ceil(n/s) - 1)·s + k - n, 0)``,
  ``lo = total // 2``.  The stride-2 3×3 ``conv2`` and the 3×3/2 max-pool pad
  (0, 1) on an even input, not (1, 1); the pool pads with −inf.  Asymmetric
  pads are applied with ``F.pad``, then the op runs with ``padding=0``.
- :class:`BatchNorm` is Flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``:
  batch statistics in f32, running statistics updated as ``0.9·r +
  0.1·batch`` with the biased variance, in train steps only; f32 parameters
  and statistics, output in the compute dtype.  ``bn3``'s scale starts at
  zero.  The batch statistics come from PyTorch's batch-norm kernel in one
  pass over the activation, not from Flax's ``E[x²] − E[x]²``: the two
  agree to f32 rounding unless a channel's mean is large against its
  standard deviation, where the one pass is the more exact.  Over several
  data ranks (a trainer over a mesh) the statistics are the global batch's,
  as under JAX's GSPMD: one differentiable all-reduce of the f32 sums.
- The head: ``mean`` over H, W in f32, rounded once to the compute dtype
  (``jnp.mean`` of bf16), then cast to f32.  With ``use_pallas_head`` it is
  ``FusedDense(2048, 1000, dtype=float32)``: on the card the f32 fused-dense
  kernel (``ops/csrc/fused_dense.cu``).  Without, a plain f32
  ``x @ kernel + bias`` (cuBLAS).  Both have the same parameters, so one
  state dict loads into either.
- Conv weights are ``[out, in, kh, kw]`` (PyTorch's layout; interop
  transposes Flax's ``[kh, kw, in, out]``), drawn with Flax's
  ``lecun_normal`` (fan-in ``kh·kw·in``) from the caller's generator.

``norm="group"`` is ``GroupNorm32`` (``gcd(32, C)`` groups, ε 1e-5);
``norm="folded"`` is inference-only (a train-mode call raises), its convs
carry a bias and :func:`fold_batchnorm` converts a ``norm="batch"`` state
dict.  ``return_features`` gives the {C2..C5} maps back in NHWC.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from deeplearning_cfn_tpu_torch.models.fused_layers import (
    _TRUNCATED_STD,
    FusedDense,
    zeros,
)
from deeplearning_cfn_tpu_torch.parallel.data_ranks import data_rank_count, global_sum

EPS = 1e-5
MOMENTUM = 0.9


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """Flax/XLA ``SAME`` padding of one spatial axis: (low, high)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv_weight(out_ch: int, in_ch: int, k: int, generator) -> nn.Parameter:
    """Flax ``lecun_normal`` for a ``k×k`` conv kernel (fan-in ``k·k·in``),
    stored ``[out, in, k, k]``."""
    std = math.sqrt(1.0 / (k * k * in_ch)) / _TRUNCATED_STD
    w = torch.empty((out_ch, in_ch, k, k), dtype=torch.float32)
    nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)
    return nn.Parameter(w)


class Conv(nn.Module):
    """``nn.Conv`` with Flax's padding rule: ``padding`` is ``"SAME"`` or an
    explicit ``(lo, hi)`` on both spatial axes.  Input, kernel and the bias
    (``norm="folded"`` only; stored f32) are cast to ``dtype``, as Flax does."""

    def __init__(self, in_ch, out_ch, k, stride=1, padding="SAME", bias=False, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.k, self.stride, self.padding, self.dtype = k, stride, padding, dtype
        self.weight = _conv_weight(out_ch, in_ch, k, generator)
        self.bias = zeros(out_ch) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = [same_pads(n, self.k, self.stride) if self.padding == "SAME" else self.padding
                for n in x.shape[2:]]
        x = x.to(self.dtype)
        # PyTorch's CPU bf16 convolution gives a non-finite weight gradient,
        # at random, for a one-pixel input at stride 2 with the padding inside
        # the convolution (RetinaNet's p7 at 64 px); the same padding applied
        # first is exact.
        cpu_fault = (x.device.type == "cpu" and self.dtype == torch.bfloat16 and self.stride > 1
                     and min(x.shape[2:]) == 1)
        if all(lo == hi for lo, hi in pads) and not cpu_fault:
            pad = (pads[0][0], pads[1][0])
        else:
            x = F.pad(x, (*pads[1], *pads[0]))
            pad = (0, 0)
        y = F.conv2d(x, self.weight.to(self.dtype), stride=self.stride, padding=pad)
        if self.bias is not None:
            y = y + self.bias.to(self.dtype).reshape(1, -1, 1, 1)
        return y


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=dtype)`` over the
    channel axis (1) of an NCHW tensor.

    Train mode: PyTorch's batch-norm kernel in train form, which computes the
    batch's mean and inverse standard deviation in f32 from the
    compute-dtype input in one pass (the gradient flows through them); the
    running statistics (buffers ``mean``, ``var``) are updated in place from
    those two, the biased variance as ``invstd⁻² − ε`` clipped at 0.  Inside
    a trainer step over several data ranks (``parallel/data_ranks.py``) the
    statistics are the global batch's instead (:meth:`_global_batch`).  Eval
    mode: the running statistics.  The normalisation is
    ``(x − mean)·rsqrt(var + ε)·weight + bias`` in f32, out in ``dtype``."""

    def __init__(self, channels: int, dtype=torch.float32, zero_scale: bool = False):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(channels) if zero_scale else torch.ones(channels))
        self.bias = zeros(channels)
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x = x.to(self.dtype)
        if not train:
            return F.batch_norm(x, self.mean, self.var, self.weight, self.bias, False, 0.0, EPS)
        if data_rank_count() > 1:
            return self._global_batch(x)
        out, mean, invstd = torch.ops.aten.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, EPS)
        with torch.no_grad():
            var = torch.clamp_min(invstd.reciprocal().square() - EPS, 0.0)
            self._update_running(mean, var)
        return out

    def _update_running(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        self.mean.mul_(MOMENTUM).add_(mean, alpha=1.0 - MOMENTUM)
        self.var.mul_(MOMENTUM).add_(var, alpha=1.0 - MOMENTUM)

    def _global_batch(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode over several data ranks: the statistics of the global
        batch, as JAX's GSPMD step computes them.  The f32 sum, sum of
        squares and count go through one differentiable all-reduce; then
        Flax's ``E[x²] − E[x]²`` (clipped at 0) and its order of
        operations.  Every rank updates the same running statistics."""
        c = x.shape[1]
        dims = [d for d in range(x.ndim) if d != 1]
        x32 = x.to(torch.float32)
        count = torch.full((1,), x.numel() // c, dtype=torch.float32, device=x.device)
        sums = global_sum(torch.cat([x32.sum(dims), x32.square().sum(dims), count]))
        mean = sums[:c] / sums[-1]
        var = torch.clamp_min(sums[c:2 * c] / sums[-1] - mean.square(), 0.0)
        with torch.no_grad():
            self._update_running(mean, var)
        shape = (1, c) + (1,) * (x.ndim - 2)
        mul = torch.rsqrt(var + EPS) * self.weight
        y = (x32 - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)
        return y.to(self.dtype)


class GroupNorm32(nn.Module):
    """Flax ``nn.GroupNorm(num_groups=gcd(32, C), epsilon=1e-5)``: statistics
    per sample and group over H, W and the group's channels in f32
    (``E[x²] − E[x]²``, clipped at 0); f32 scale and bias; out in ``dtype``."""

    def __init__(self, channels: int, dtype=torch.float32, zero_scale: bool = False):
        super().__init__()
        self.dtype = dtype
        self.groups = math.gcd(32, channels)
        self.weight = nn.Parameter(torch.zeros(channels) if zero_scale else torch.ones(channels))
        self.bias = zeros(channels)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        b, c, h, w = x.shape
        x32 = x.to(torch.float32)
        grouped = x32.reshape(b, self.groups, c // self.groups, h, w)
        mean = grouped.mean(dim=(2, 3, 4))
        var = torch.clamp_min(grouped.square().mean(dim=(2, 3, 4)) - mean.square(), 0.0)
        # Per channel, as Flax repeats them, then Flax's order of operations.
        mean, var = (t.repeat_interleave(c // self.groups, dim=1)[:, :, None, None]
                     for t in (mean, var))
        mul = torch.rsqrt(var + EPS) * self.weight.reshape(1, -1, 1, 1)
        y = (x32 - mean) * mul + self.bias.reshape(1, -1, 1, 1)
        return y.to(self.dtype)


class _FoldedNorm(nn.Module):
    """Identity where a BatchNorm was folded into the conv before it."""

    def __init__(self, channels: int, dtype=torch.float32, zero_scale: bool = False):
        super().__init__()

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        return x


_NORMS = {"batch": BatchNorm, "group": GroupNorm32, "folded": _FoldedNorm}


class BottleneckBlock(nn.Module):
    def __init__(self, in_ch: int, filters: int, strides: int, norm: str, dtype, generator):
        super().__init__()
        norm_cls, bias = _NORMS[norm], norm == "folded"

        def conv(i, o, k, s=1):
            return Conv(i, o, k, s, bias=bias, dtype=dtype, generator=generator)

        self.conv1 = conv(in_ch, filters, 1)
        self.bn1 = norm_cls(filters, dtype)
        self.conv2 = conv(filters, filters, 3, strides)
        self.bn2 = norm_cls(filters, dtype)
        self.conv3 = conv(filters, 4 * filters, 1)
        self.bn3 = norm_cls(4 * filters, dtype, zero_scale=True)  # each block starts as identity
        if in_ch != 4 * filters or strides != 1:
            self.conv_proj = conv(in_ch, 4 * filters, 1, strides)
            self.bn_proj = norm_cls(4 * filters, dtype)
        else:
            self.conv_proj = self.bn_proj = None

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x), train))
        y = torch.relu(self.bn2(self.conv2(y), train))
        y = self.bn3(self.conv3(y), train)
        residual = x if self.conv_proj is None else self.bn_proj(self.conv_proj(x), train)
        return torch.relu(residual + y)


class ResNet(nn.Module):
    """``forward(x [B, H, W, C], train=True)`` -> logits ``[B, num_classes]``
    f32, or the ``{"C2".."C5"}`` NHWC feature maps with ``return_features``."""

    def __init__(
        self,
        stage_sizes: Sequence[int],
        num_classes: int = 1000,
        num_filters: int = 64,
        dtype: torch.dtype = torch.float32,
        return_features: bool = False,
        norm: str = "batch",
        use_pallas_head: bool = False,
        in_channels: int = 3,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if norm not in _NORMS:
            raise ValueError(f"unknown norm {norm!r}; expected batch|group|folded")
        self.dtype, self.norm = dtype, norm
        self.return_features, self.use_pallas_head = return_features, use_pallas_head
        self.conv_init = Conv(in_channels, num_filters, 7, 2, padding=(3, 3),
                              bias=norm == "folded", dtype=dtype, generator=generator)
        self.bn_init = _NORMS[norm](num_filters, dtype)
        self.block_names: list[list[str]] = []
        ch = num_filters
        for i, count in enumerate(stage_sizes):
            names = []
            for j in range(count):
                filters = num_filters * 2**i
                name = f"stage{i + 1}_block{j + 1}"
                self.add_module(name, BottleneckBlock(ch, filters, 2 if i > 0 and j == 0 else 1,
                                                      norm, dtype, generator))
                names.append(name)
                ch = 4 * filters
            self.block_names.append(names)
        self.head = None if return_features else FusedDense(
            ch, num_classes, dtype=torch.float32, generator=generator)

    def forward(self, x: torch.Tensor, train: bool = True):
        if self.norm == "folded" and train:
            raise ValueError('norm="folded" is inference-only; train with norm="batch" '
                             "and fold the result")
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NHWC -> an NCHW view, channels-last
        x = torch.relu(self.bn_init(self.conv_init(x), train))
        (ph, pw) = (same_pads(n, 3, 2) for n in x.shape[2:])
        x = F.max_pool2d(F.pad(x, (*pw, *ph), value=-math.inf), 3, 2)
        features = {}
        for i, names in enumerate(self.block_names):
            for name in names:
                x = getattr(self, name)(x, train)
            features[f"C{i + 2}"] = x.permute(0, 2, 3, 1)
        if self.return_features:
            return features
        # jnp.mean of the compute dtype: summed in f32, rounded once.
        x = torch.mean(x, dim=(2, 3), dtype=torch.float32).to(self.dtype).to(torch.float32)
        if self.use_pallas_head:
            return self.head(x)
        return torch.matmul(x, self.head.kernel) + self.head.bias


def ResNet50(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 6, 3), **kw)


def ResNet101(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 4, 23, 3), **kw)


def ResNet152(**kw) -> ResNet:
    return ResNet(stage_sizes=(3, 8, 36, 3), **kw)


def fold_batchnorm(state_dict: dict[str, torch.Tensor], eps: float = EPS) -> dict[str, torch.Tensor]:
    """Fold eval-mode BatchNorm into the preceding convolutions of a
    ``norm="batch"`` state dict: ``W' = W·s`` and ``b' = β − mean·s`` with
    ``s = γ / sqrt(var + ε)`` per output channel, computed in f32.  The
    result loads into the same architecture built with ``norm="folded"``.
    Convs and norms pair by name within a scope (``convX`` with ``bnX``)."""
    out: dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        scope, _, leaf = key.rpartition(".")
        parent, _, name = scope.rpartition(".")
        if name.startswith("bn"):
            continue  # absorbed
        bn = (parent + "." if parent else "") + "bn" + name[len("conv"):]
        if name.startswith("conv") and f"{bn}.weight" in state_dict and leaf == "weight":
            gamma, beta = state_dict[f"{bn}.weight"].float(), state_dict[f"{bn}.bias"].float()
            mean, var = state_dict[f"{bn}.mean"].float(), state_dict[f"{bn}.var"].float()
            s = gamma / torch.sqrt(var + eps)
            out[key] = (value.float() * s.reshape(-1, 1, 1, 1)).to(value.dtype)
            out[f"{scope}.bias"] = beta - mean * s
        else:
            out[key] = value
    return out


def train_flops(arch: dict, x_shape: Sequence[int]) -> float:
    """FLOPs of one training step (forward and backward) of the ResNet built
    from the keyword arguments ``arch`` on a batch of shape ``x_shape``
    (NHWC),
    as ``torch.utils.flop_counter.FlopCounterMode`` counts them: one example
    on a twin built on the ``meta`` device (no memory, no compute), times
    the batch.  The twin has the plain head, whose three products (forward,
    ``dx``, ``dw``: 3·2·M·K·N) stand for the kernel head's: the kernel's
    forward is a ctypes call that no counter sees."""
    from torch.utils.flop_counter import FlopCounterMode

    norm = arch.get("norm", "batch")
    twin_arch = {**arch, "use_pallas_head": False, "return_features": False,
                 "norm": "batch" if norm == "folded" else norm}
    with torch.device("meta"):
        twin = ResNet(**twin_arch)
        x = torch.empty((1, *x_shape[1:]), dtype=torch.float32)
    with FlopCounterMode(display=False) as counter:
        twin(x, train=True).sum().backward()
    return float(counter.get_total_flops()) * int(x_shape[0])
