"""Step (``solver.py``): device ms a traced frame in every device operation
the profiler recorded (kernels, copies, fills)."""

NEEDS = "trace"


def read(run):
    return run.rec.device_ms()
