"""Growth (``core/activation.py``): host ms a traced frame in the program's
span ``grow.rebuild``: the new tile set, ``build_topology``'s numpy tables
and their upload, and the test that discards a topology equal to the old
one (``program_spans.py``)."""

import program_spans as spans

NEEDS = "trace"


def read(run):
    return spans.ms_a_frame(run, ("grow.rebuild",), clock="host")
