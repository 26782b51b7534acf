"""The 95th percentile (linear between order statistics) of the wall time
of every frame of the window, from the end of the frame before to the
synchronize that ends it (host clock)."""

import numpy as np

NEEDS = "window"


def read(run):
    return float(np.percentile(np.asarray(run.frame_s), 95.0)) * 1e3
