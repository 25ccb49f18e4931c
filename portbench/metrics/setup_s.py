"""Seconds from the command's start to the window's opening: imports,
weights, the first steps (kernel builds, cuDNN's choices, graph capture)
and the checks' readings of the state."""


def read(run):
    return run.setup_s
