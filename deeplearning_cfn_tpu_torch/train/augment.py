"""On-device image augmentation — counterpart of
``deeplearning_cfn_tpu/train/augment.py``.

:class:`DeviceAugment` flips and crops ``[B, H, W, C]`` batches inside the
train step (``TrainerConfig.augment``), on the device and in the input dtype
(uint8 stays uint8 across PCIe).  It is split in two:

- :meth:`DeviceAugment.decisions` draws the coins and windows for one step
  on the device, from a ``torch.Generator`` seeded from ``(seed, step)``:
  the same step always gets the same decisions, whatever the prefetch depth
  or a resume.  The JAX package draws its bits with ``jax.random``, and a
  ``torch.Generator`` gives other bits from the same seed, so the two agree
  in distribution, not draw for draw.
- :meth:`DeviceAugment.apply` is the deterministic rest: pad, the windows,
  the flips.  Fed the same decisions, it equals the JAX stage.

Calling the object, ``augment(step, x)``, does both.  ``multi_step_fn``'s
captured graph takes the decisions as inputs, drawn before each replay.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class DeviceAugment:
    """Flip / crop of ``[B, H, W, C]`` images.

    - ``flip``: a horizontal flip per image, on a fair coin.
    - ``crop=(th, tw)``: every output is ``th × tw``.  Inputs larger than the
      target take a window (random with ``random_crop``, else the centre
      one); inputs equal to the target with ``pad > 0`` are zero-padded by
      ``pad`` on each side first (the CIFAR pad-and-crop recipe).
    - ``seed``: the stream's identity; each step's generator is seeded from
      ``(seed, step)``."""

    flip: bool = False
    crop: tuple[int, int] | None = None
    pad: int = 0
    random_crop: bool = True
    seed: int = 0

    @property
    def is_identity(self) -> bool:
        return not self.flip and self.crop is None

    def _padded(self, h: int, w: int) -> tuple[int, int, int]:
        """(pad, h, w) after the pad-and-crop recipe's pad."""
        p = int(self.pad) if self.crop is not None and (h, w) == tuple(self.crop) else 0
        return p, h + 2 * p, w + 2 * p

    def decisions(self, step: int, b: int, h: int, w: int, device="cpu"):
        """``(flips [b] bool | None, ys [b] | None, xs [b] | None)`` for step
        ``step`` on ``b`` images of ``h × w``: the flip coins and the windows'
        top-left corners (int64), drawn on ``device``."""
        flips = ys = xs = None
        seed = int(np.random.SeedSequence([self.seed, int(step)]).generate_state(1, np.uint64)[0])
        gen = torch.Generator(device=device).manual_seed(seed & (2**63 - 1))
        if self.crop is not None:
            th, tw = self.crop
            _, hp, wp = self._padded(h, w)
            if hp < th or wp < tw:
                raise ValueError(f"cannot crop {hp}x{wp} inputs to {th}x{tw}")
            if (hp, wp) != (th, tw):
                if self.random_crop:
                    ys = torch.randint(0, hp - th + 1, (b,), generator=gen, device=device)
                    xs = torch.randint(0, wp - tw + 1, (b,), generator=gen, device=device)
                else:
                    ys = torch.full((b,), (hp - th) // 2, dtype=torch.int64, device=device)
                    xs = torch.full((b,), (wp - tw) // 2, dtype=torch.int64, device=device)
        if self.flip:
            flips = torch.randint(0, 2, (b,), generator=gen, device=device).bool()
        return flips, ys, xs

    def apply(self, x: torch.Tensor, flips, ys, xs) -> torch.Tensor:
        """Pad (when the recipe says so), take each image's ``crop`` window
        at ``(ys, xs)``, then flip the images whose coin is set; any dtype."""
        if self.crop is not None:
            th, tw = self.crop
            p, _, _ = self._padded(x.shape[1], x.shape[2])
            if p:
                x = F.pad(x, (0, 0, p, p, p, p))
            if ys is not None:
                b = x.shape[0]
                rows = ys[:, None] + torch.arange(th, device=x.device)
                cols = xs[:, None] + torch.arange(tw, device=x.device)
                x = x[torch.arange(b, device=x.device)[:, None, None], rows[:, :, None],
                      cols[:, None, :]]
        if flips is not None:
            x = torch.where(flips[:, None, None, None], x.flip(2), x)
        return x

    def __call__(self, step: int, x: torch.Tensor) -> torch.Tensor:
        b, h, w = x.shape[:3]
        return self.apply(x, *self.decisions(step, b, h, w, device=x.device))
