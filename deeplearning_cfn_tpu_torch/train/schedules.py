"""Learning-rate schedules — counterpart of ``deeplearning_cfn_tpu/train/schedules.py``.

Each schedule is a plain ``step -> lr`` function with the JAX package's
(optax's) semantics, the step 0-based as optax counts it: the first
optimizer update reads ``schedule(0)``.  The trainer sets the learning rate
of every parameter group from it before each update (no ``LambdaLR``, whose
epoch counter would shift the schedule by one).
"""

from __future__ import annotations

import logging
import math
from typing import Callable, Sequence

Schedule = Callable[[int], float]

KINDS = ("constant", "cosine", "step")


def _linear(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    if transition_steps <= 0:
        return lambda step: init_value

    def schedule(step: int) -> float:
        count = min(max(step, 0), transition_steps)
        return (init_value - end_value) * (1 - count / transition_steps) + end_value

    return schedule


def _piecewise_constant(init_value: float, boundaries_and_scales: dict[int, float]) -> Schedule:
    def schedule(step: int) -> float:
        v = init_value
        for threshold, scale in sorted(boundaries_and_scales.items()):
            if step >= threshold:
                v *= scale
        return v

    return schedule


def _join(schedules: Sequence[Schedule], boundaries: Sequence[int]) -> Schedule:
    def schedule(step: int) -> float:
        out = schedules[0](step)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if step >= boundary:
                out = sched(step - boundary)
        return out

    return schedule


def warmup_cosine(
    base_lr: float,
    total_steps: int,
    warmup_steps: int = 0,
    final_scale: float = 0.0,
) -> Schedule:
    """Linear 0 -> base_lr over ``warmup_steps``, then cosine decay to
    ``final_scale * base_lr`` at ``total_steps``."""
    if total_steps <= 0:
        raise ValueError(f"total_steps must be positive, got {total_steps}")
    warmup_steps = max(0, min(warmup_steps, total_steps - 1))
    init_value = 0.0 if warmup_steps else base_lr
    end_value = final_scale * base_lr
    alpha = 0.0 if base_lr == 0.0 else end_value / base_lr
    decay_steps = total_steps - warmup_steps

    def cosine(step: int) -> float:
        count = min(step, decay_steps)
        decay = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return base_lr * ((1 - alpha) * decay + alpha)

    return _join([_linear(init_value, base_lr, warmup_steps), cosine], [warmup_steps])


def stepped(
    base_lr: float,
    boundaries: Sequence[int],
    decay_factor: float = 0.1,
    warmup_steps: int = 0,
) -> Schedule:
    """base_lr, multiplied by ``decay_factor`` at each (absolute) boundary
    step, with optional linear warmup."""
    if not boundaries:
        raise ValueError("stepped schedule needs at least one boundary")
    if sorted(boundaries) != list(boundaries) or len(set(boundaries)) != len(boundaries):
        raise ValueError(f"boundaries must be strictly increasing, got {boundaries}")
    if warmup_steps <= 0:
        return _piecewise_constant(base_lr, {int(b): decay_factor for b in boundaries})
    if boundaries[0] <= warmup_steps:
        raise ValueError(
            f"first decay boundary {boundaries[0]} must come after "
            f"warmup_steps={warmup_steps} (boundaries are absolute step indices)"
        )
    piecewise = _piecewise_constant(
        base_lr, {int(b) - warmup_steps: decay_factor for b in boundaries}
    )
    return _join([_linear(0.0, base_lr, warmup_steps), piecewise], [warmup_steps])


def default_step_boundaries(total_steps: int) -> list[int]:
    """Drops at 50% / 75% / 90% of the run."""
    return [max(1, int(total_steps * f)) for f in (0.5, 0.75, 0.9)]


def build_schedule(
    kind: str,
    base_lr: float,
    total_steps: int,
    warmup_steps: int | None = None,
    boundaries: Sequence[int] | None = None,
    decay_factor: float = 0.1,
) -> Schedule | None:
    """One constructor for the example trainers (None = constant LR).
    ``warmup_steps`` None = 5% of the run capped at 1000 for cosine, 0 for step."""
    if kind == "constant":
        return None
    if kind not in KINDS:
        raise ValueError(f"unknown schedule {kind!r}; expected one of {KINDS}")
    if warmup_steps is None:
        warmup_steps = min(1000, max(0, total_steps // 20)) if kind == "cosine" else 0
    if kind == "cosine":
        return warmup_cosine(base_lr, total_steps, warmup_steps)
    bounds = list(boundaries) if boundaries else sorted(set(default_step_boundaries(total_steps)))
    max_warmup = min(max(0, bounds[0] - 1), max(0, total_steps - 1))
    if warmup_steps > max_warmup:
        logging.getLogger("dlcfn.schedules").warning(
            "clamping warmup_steps %d -> %d (first decay boundary %d, total_steps %d)",
            warmup_steps, max_warmup, bounds[0], total_steps,
        )
        warmup_steps = max_warmup
    return stepped(base_lr, bounds, decay_factor=decay_factor, warmup_steps=warmup_steps)
