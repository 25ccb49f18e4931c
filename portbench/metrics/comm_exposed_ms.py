"""Milliseconds a step in which the card ran collectives and nothing else:
the union of the NCCL kernels' intervals less every interval a compute
kernel covers, over the traced window's steps (rank 0's card)."""


def read(run):
    prof = run.profile
    if not prof or not prof["nccl_s"] or not run.window_steps:
        return None
    return prof["nccl_exposed_s"] / run.window_steps * 1e3
