"""Model FLOP utilisation of the window, in percent: the benchmark's own
training FLOPs a step (``portbench/flops.py``; no recompute counted) times
the window's steps, over its seconds, over the bf16 peak of every chip the
cell uses (``portbench/peaks.py``, H100 SXM; the card's ``power.limit`` is
on the line's ``device``)."""

from portbench import peaks


def read(run):
    if not run.window_steps or run.flops_per_step is None or run.notes.get("kind") is None:
        return None  # no card, no share of its peak
    return run.flops_per_step * run.window_steps / run.window_s / (peaks.BF16_FLOPS * run.world) * 100
