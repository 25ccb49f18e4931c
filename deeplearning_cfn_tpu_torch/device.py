"""Device selection for the port's entry points.

The JAX package lets XLA pick its default backend.  The port is written for
the card: entry points run on CUDA unless the caller asks for the CPU, and
they never carry on quietly on the CPU when CUDA is missing.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means ``cuda``.  Raises when CUDA was asked for (or implied)
    and is not available; ``"cpu"`` is honoured only when asked for, as is
    ``"meta"``, which traces shapes and allocates nothing
    (``models/llama_memory.trace_check``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (or --device cpu) to "
            "run on the CPU"
        )
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; expected cuda, cpu or meta")
    return dev
