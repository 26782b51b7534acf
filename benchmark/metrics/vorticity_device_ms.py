"""Forces (``ops/stencil.py``): device ms a traced frame in the program's
span ``forces.vorticity``, each ``vorticity_confinement`` call that acts
(one a frame of a step at an offset of 1 or more, inside ``step.forces``).
Stream time between the span's two events (``program_spans.py``): the
confinement's device time in a device-bound cell. None where the program
has no such span."""

import program_spans as spans

NEEDS = "trace"
SPANS = ("forces.vorticity",)


def read(run):
    return spans.ms_a_frame(run, SPANS)
