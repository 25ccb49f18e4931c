"""The most device memory the program held in the window, in GiB:
``torch.cuda.max_memory_reserved`` after ``reset_peak_memory_stats`` at the
window's opening (the allocator's segments, a CUDA graph's private pool
included: in a replay nothing is allocated, so ``max_memory_allocated``
would see only the batches); over several ranks, the highest rank's."""


def read(run):
    if run.peak_bytes is None:
        return None
    return run.peak_bytes / 2 ** 30
