"""From the process's start to the first timed frame (host clock): imports,
the kernels' build or load, the topology, the hierarchy, the seeded start
and the warm-up; less the host copy the output check keeps of the first
frame."""

NEEDS = "window"


def read(run):
    return run.setup_s
