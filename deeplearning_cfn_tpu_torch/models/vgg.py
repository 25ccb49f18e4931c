"""VGG family, the reference's CIFAR-10 baseline — counterpart of
``deeplearning_cfn_tpu/models/vgg.py``.

NHWC images in, as in the JAX package (viewed as channels-last NCHW
inside).  Each conv is a bias-free 3×3 ``SAME`` convolution in the compute
dtype (``conv{i}``), then ``BatchNorm`` (``bn{i}``, momentum 0.9, ε 1e-5, in
f32, out in f32; over several data ranks the whole batch's statistics, as
under JAX's GSPMD) and ReLU; ``"M"`` is a 2×2 max-pool.  The head is global
average pooling in f32 and an f32 dense ``head`` (``x @ kernel + bias``),
where VGG's 3×4096 FC stack would be.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from deeplearning_cfn_tpu_torch.models.fused_layers import lecun_normal, zeros
from deeplearning_cfn_tpu_torch.models.resnet import BatchNorm, Conv

# Stage widths per VGG variant: int = conv layer channels, "M" = maxpool.
CONFIGS: dict[str, Sequence] = {
    "vgg11": (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "vgg13": (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "vgg16": (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
              512, 512, 512, "M"),
}


class _Head(nn.Module):
    """Flax ``nn.Dense(dtype=float32)``: ``kernel [in, out]`` lecun-normal,
    ``bias`` zeros."""

    def __init__(self, in_features: int, features: int, generator=None):
        super().__init__()
        self.kernel = lecun_normal((in_features, features), generator)
        self.bias = zeros(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, self.kernel) + self.bias


class VGG(nn.Module):
    """``forward(x [B, H, W, C], train=True)`` -> logits ``[B, num_classes]`` f32."""

    def __init__(self, config: Sequence = CONFIGS["vgg11"], num_classes: int = 10,
                 dtype: torch.dtype = torch.float32, in_channels: int = 3,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.config, self.dtype = tuple(config), dtype
        ch, i = in_channels, 0
        for item in self.config:
            if item == "M":
                continue
            i += 1
            self.add_module(f"conv{i}", Conv(ch, int(item), 3, dtype=dtype, generator=generator))
            self.add_module(f"bn{i}", BatchNorm(int(item), torch.float32))
            ch = int(item)
        self.head = _Head(ch, num_classes, generator)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        i = 0
        for item in self.config:
            if item == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                i += 1
                x = torch.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x), train))
        return self.head(x.mean(dim=(2, 3)))


VGG11: Callable[..., VGG] = partial(VGG, config=CONFIGS["vgg11"])
VGG13: Callable[..., VGG] = partial(VGG, config=CONFIGS["vgg13"])
VGG16: Callable[..., VGG] = partial(VGG, config=CONFIGS["vgg16"])
