"""Device (H100): one minus the union of the device operations' intervals
over the traced segment's wall time, in %."""

NEEDS = "trace"


def read(run):
    rec = run.rec
    if not rec.device_ops or not rec.window_s:
        return None
    return (1.0 - rec.busy_s() / rec.window_s) * 100.0
