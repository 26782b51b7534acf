"""``torch.cuda.max_memory_allocated()`` over the window, after
``reset_peak_memory_stats()`` at its start: the device memory the cook
needs, which decides the largest domain a card holds."""

NEEDS = "window"


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
