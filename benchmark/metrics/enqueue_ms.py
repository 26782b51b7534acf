"""Driver (``models/plume.py``): host ms from the call into ``plume_step``
until it returns, the median over the window's frames outside the traced
segments: the harness's own span around the call. Cells that call
``run_plume`` have no such span."""

NEEDS = "frames"


def read(run):
    return run.rec.median_enqueue_ms()
