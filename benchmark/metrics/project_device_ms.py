"""Step (``solver.py``): device ms a traced frame in the program's spans
``step.collide`` (with an SDF only), ``step.project`` (u - grad p, B7b, and
its collision tail) and ``step.mask``. Stream time between each span's two
events (``program_spans.py``): the phases' device time in a device-bound cell
(1024³), the host's pace through them in a host-bound one."""

import program_spans as spans

NEEDS = "trace"


def read(run):
    return spans.ms_a_frame(run, ("step.collide", "step.project", "step.mask"))
