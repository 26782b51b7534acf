"""Multigrid (``ops/multigrid.py``): device ms a traced frame in the
program's spans ``mg.restrict`` and ``mg.prolong`` at every level, in the
V-cycles and the full-multigrid start. Stream time between each span's two
events (``program_spans.py``): the transfers' device time in a device-bound cell
(1024³), the host's pace through them in a host-bound one."""

import program_spans as spans

NEEDS = "trace"


def read(run):
    return spans.ms_a_frame(run, ("mg.restrict", "mg.prolong"))
