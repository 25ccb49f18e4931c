"""Milliseconds a step: the window's length over the steps completed in it
(every step of the window counts, a captured call of k steps as k; over
several ranks, the global step).  Host clock, each end synchronised."""


def read(run):
    if not run.window_steps:
        return None
    return run.window_s / run.window_steps * 1e3
