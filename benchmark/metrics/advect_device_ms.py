"""Advection (``ops/advection.py``: B1, B2 and their glue): device ms a
traced frame in the program's spans ``step.advect_velocity`` and
``step.advect_scalars``. Stream time between each span's two events
(``program_spans.py``): the phases' device time in a device-bound cell (1024³), the
host's pace through them in a host-bound one."""

import program_spans as spans

NEEDS = "trace"


def read(run):
    return spans.ms_a_frame(run, ("step.advect_velocity", "step.advect_scalars"))
