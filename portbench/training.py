"""What every training driver does around the program's ``Trainer.fit``:
one call of ``fit`` whose first steps are set-up and whose later ones are
the window (``window.Window``), the trace of the window in a traced run,
and the window's numbers on the run record."""

from __future__ import annotations

import math
import time

import torch

from portbench.trace import DeviceTrace
from portbench.window import Window


def agree_over_ranks(device, world: int):
    """A decision taken by every rank: the ranks' maximum (one all-reduce
    of one number), or the flag itself on one rank."""
    if world == 1:
        return lambda flag: flag
    import torch.distributed as dist

    def agree(flag: bool) -> bool:
        t = torch.tensor([1.0 if flag else 0.0], device=device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    return agree


class StepHooks:
    """``fit``'s ``logger``: after each call, the hooks (step -> callable)
    whose step the state has reached, in order.  The checks read the state
    between two calls this way, without a readback of their own, so ``fit``
    syncs only at its ``log_every``."""

    def __init__(self, hooks: dict):
        self.hooks = dict(hooks)

    def resume(self, step: int) -> None:
        pass

    def step(self, step: int, loss) -> None:
        for at in sorted(k for k in self.hooks if k <= step):
            self.hooks.pop(at)()


def run_window(run, trainer, state, batches, *, steps_per_call: int, warmup_steps: int,
               hooks: dict, prefetch: int) -> list[float]:
    """Train from the fresh ``state`` through set-up and the window; fill
    ``run``'s window numbers; return every step's loss.  The hooks run in
    set-up, before ``warmup_steps``.  The peak is of the memory the
    allocator reserves in the window (CUDA graphs' pools included, which
    ``max_memory_allocated`` does not see in a replay), from a cache
    emptied one readback before the opening."""
    late = sorted(at for at in hooks if at >= warmup_steps)
    if late:
        raise ValueError(f"hooks at steps {late} would run inside the window")
    step_hooks = StepHooks(hooks)
    tracer = DeviceTrace() if run.trace else None
    stats_at_open = {}

    def on_open():
        ps = trainer.last_pipeline_stats
        stats_at_open.update(wait=ps.consumer_wait_seconds)
        if tracer is not None:
            tracer.start()

    window = Window(state, run.seconds, warmup_steps, run.device,
                    agree_over_ranks(run.device, run.world), on_open=on_open,
                    on_close=tracer.stop if tracer is not None else None)
    state, losses = trainer.fit(state, batches, steps=10 ** 9, logger=step_hooks,
                                steps_per_call=steps_per_call, stop_fn=window, prefetch=prefetch)
    if window.closed is None:
        raise RuntimeError("the window never closed")
    if step_hooks.hooks:
        raise RuntimeError(f"hooks never ran: {sorted(step_hooks.hooks)}")
    run.setup_s = window.opened_wall - run.t0_wall
    run.window_s = window.elapsed
    run.window_steps = window.steps
    run.window_failed = sum(not math.isfinite(x) for x in losses[window.first_step:window.last_step])
    if run.device.type == "cuda":
        run.peak_bytes = torch.cuda.max_memory_reserved(run.device)
        run.notes["peak_allocated_bytes"] = torch.cuda.max_memory_allocated(run.device)
        run.notes["reserved_before_opening_bytes"] = window.reserved_before_opening
    run.input_wait_s = trainer.last_pipeline_stats.consumer_wait_seconds - stats_at_open["wait"]
    if tracer is not None:
        run.profile = tracer.summarise()
    run.notes["window_opened_wall"] = window.opened_wall
    run.notes["closed_at"] = time.time()
    return losses


def optimizer_state(state, param, key: str):
    """The optimizer's ``key`` for ``param``; zeros where the optimizer has
    made none (a step that never ran leaves the state as it started)."""
    got = state.optimizer.state.get(param, {}).get(key)
    return got if got is not None else torch.zeros_like(param)


def record_checks(run, values: list[tuple[str, float]], notes: dict) -> None:
    """Hold each compared number to the traffic's limit of that name; the
    numbers without a limit go to the notes (``not_compared``)."""
    limits = run.traffic["limits"]
    notes["not_compared"] = {name: v for name, v in values if name not in limits}
    run.notes.update(notes)
    run.checks = [(name, v, limits[name]) for name, v in values if name in limits]
