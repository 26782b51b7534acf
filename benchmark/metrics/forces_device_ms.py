"""Step (``solver.py``): device ms a traced frame in the program's span
``step.forces``: vorticity confinement, divergence (B7a), combustion and
buoyancy. Stream time between the span's two events (``program_spans.py``): the
phase's device time in a device-bound cell (1024³), the host's pace through it
in a host-bound one."""

import program_spans as spans

NEEDS = "trace"


def read(run):
    return spans.ms_a_frame(run, ("step.forces",))
