"""Step (``solver.py``): device ms a traced frame in PyTorch's own kernels
(names in the ``at::`` namespace): the plain glue of emit, combustion,
buoyancy, the mask and the multigrid transfers."""

NEEDS = "trace"


def read(run):
    return run.rec.device_ms("at::")
