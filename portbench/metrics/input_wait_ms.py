"""Milliseconds a step waited for its batch in the window: the growth of
the program's own counter (``Trainer.last_pipeline_stats``'s
``consumer_wait_seconds``, the prefetcher's consumer side) across the
window, over the window's steps (rank 0's)."""


def read(run):
    if run.input_wait_s is None or not run.window_steps:
        return None
    return run.input_wait_s / run.window_steps * 1e3
