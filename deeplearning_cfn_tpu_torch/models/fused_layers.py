"""``FusedDense`` — counterpart of ``deeplearning_cfn_tpu/models/fused_layers.py``.

A drop-in for a dense layer plus an optional fused activation, with the same
parameters as one (``kernel [in, out]`` f32, lecun-normal; ``bias [out]``
f32, zeros), so a model can flip its ``use_pallas_*`` flag on the same
weights.  Also the Flax initializers the port's models share.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from deeplearning_cfn_tpu_torch.ops.fused_dense import fused_dense

# Standard deviation of a unit normal truncated to [-2, 2]: Flax's
# variance_scaling divides by it so the truncated draw keeps the variance.
_TRUNCATED_STD = 0.87962566103423978


def lecun_normal(shape: tuple[int, int], generator: torch.Generator | None) -> nn.Parameter:
    """Flax ``lecun_normal``: truncated normal on [-2σ, 2σ] with
    σ = sqrt(1 / fan_in) / 0.8796, fan_in = shape[0]; drawn in f32 on the CPU."""
    std = math.sqrt(1.0 / shape[0]) / _TRUNCATED_STD
    w = torch.empty(shape, dtype=torch.float32)
    nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)
    return nn.Parameter(w)


def zeros(n: int) -> nn.Parameter:
    return nn.Parameter(torch.zeros(n, dtype=torch.float32))


class FusedDense(nn.Module):
    """``activation(x @ kernel + bias)`` through one fused-dense kernel.

    x, the kernel and the bias are cast to ``dtype`` before the call (so the
    bias is rounded to bf16 before the kernel adds it in f32); leading axes
    are flattened around it."""

    def __init__(
        self,
        in_features: int,
        features: int,
        activation: str | None = None,
        dtype: torch.dtype = torch.float32,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.features = features
        self.activation = activation
        self.dtype = dtype
        self.kernel = lecun_normal((in_features, features), generator)
        self.bias = zeros(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        lead = x.shape[:-1]
        out = fused_dense(
            x.reshape(-1, x.shape[-1]),
            self.kernel.to(self.dtype),
            self.bias.to(self.dtype),
            activation=self.activation,
        )
        return out.reshape(*lead, self.features)
