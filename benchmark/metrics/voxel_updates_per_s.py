"""Active voxels summed over every frame of the window, over the window's
wall seconds (host clock)."""

NEEDS = "window"


def read(run):
    return run.voxels / run.window_s
