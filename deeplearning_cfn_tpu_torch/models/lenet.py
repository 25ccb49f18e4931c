"""LeNet-5-class CNN for MNIST — counterpart of ``deeplearning_cfn_tpu/models/lenet.py``.

Inputs ``[B, 28, 28, 1]`` channels-last as in the JAX package; the flatten
keeps that order, so a Flax kernel reads the same."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class LeNet(nn.Module):
    def __init__(self, num_classes: int = 10, generator: torch.Generator | None = None):
        super().__init__()
        self.conv1 = nn.Conv2d(1, 32, 5, padding=2)
        self.conv2 = nn.Conv2d(32, 64, 5, padding=2)
        self.fc1 = nn.Linear(7 * 7 * 64, 512)
        self.fc2 = nn.Linear(512, num_classes)
        if generator is not None:  # the weights from the caller's seed
            with torch.no_grad():
                for p in self.parameters():
                    bound = p.shape[1:].numel() ** -0.5 if p.ndim > 1 else 0.0
                    p.uniform_(-bound, bound, generator=generator) if bound else p.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)
        x = F.max_pool2d(F.relu(self.conv1(x)), 2)
        x = F.max_pool2d(F.relu(self.conv2(x)), 2)
        x = x.permute(0, 2, 3, 1).flatten(1)  # channels-last, as Flax flattens
        return self.fc2(F.relu(self.fc1(x)))
