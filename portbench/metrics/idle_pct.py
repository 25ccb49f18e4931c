"""The device's idle share of the traced window, in percent: one minus the
union of every kernel, copy and set interval over the window's length
(rank 0's card).  From the profiler's trace."""


def read(run):
    prof = run.profile
    if not prof or prof["window_s"] <= 0 or prof["kernels"] == 0:
        return None
    return (1.0 - prof["busy_s"] / prof["window_s"]) * 100
