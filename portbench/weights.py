"""Weights drawn from the seed on the device, in a few large calls.

Every drawn leaf is a slice of one flat buffer filled by ``normal_`` from a
generator on the device, in chunks of a fixed size, in the type the weights
are served in; each slice is then scaled to its leaf's standard deviation.
Constant leaves (norm scales, biases) are filled.  The same seed gives the
same weights, so the reference draws them again once the program is gone
instead of holding a copy through the window."""

from __future__ import annotations

import torch

CHUNK = 1 << 28  # elements a draw


def draw(leaves: dict[str, tuple[tuple[int, ...], float | None, float]], seed: int,
         device, dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """``leaves``: name -> (shape, std or None, constant).  A leaf with a std
    is drawn normal(0, std); one with None holds the constant."""
    device = torch.device(device)
    sizes = {n: _numel(s) for n, (s, std, _) in leaves.items() if std is not None}
    total = sum(sizes.values())
    flat = torch.empty(total, dtype=dtype, device=device)
    gen = torch.Generator(device).manual_seed(int(seed))
    for a in range(0, total, CHUNK):
        flat[a:a + CHUNK].normal_(generator=gen)
    out, off = {}, 0
    for name, (shape, std, const) in leaves.items():
        if std is None:
            out[name] = torch.full(shape, const, dtype=dtype, device=device)
        else:
            n = sizes[name]
            out[name] = flat[off:off + n].view(shape).mul_(std)
            off += n
    return out


def load_into(model: torch.nn.Module, weights: dict[str, torch.Tensor],
              buffers: dict[str, float] | None = None) -> None:
    """Copy ``weights`` into ``model``'s parameters by name; the names and
    shapes must be the same sets.  ``buffers``: name suffix -> constant for
    the model's buffers (a model built on ``meta`` and made empty holds
    garbage there)."""
    params = dict(model.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"the program's parameters differ from the benchmark's: only the "
                         f"program has {sorted(set(params) - set(weights))[:5]}, only the "
                         f"benchmark {sorted(set(weights) - set(params))[:5]}")
    with torch.no_grad():
        for name, p in params.items():
            if tuple(p.shape) != tuple(weights[name].shape):
                raise ValueError(f"{name}: the program's shape {tuple(p.shape)} is not the "
                                 f"benchmark's {tuple(weights[name].shape)}")
            p.copy_(weights[name])
        for name, b in model.named_buffers():
            for suffix, value in (buffers or {}).items():
                if name.endswith(suffix):
                    b.fill_(value)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n
