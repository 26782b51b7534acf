"""multigrid (ops/multigrid.py -> csrc/residual.cu): B6's share of its
roofline, in %: the least time the card could take for the work a frame
gives B6 (``roofline.residual_ms`` of the cell's shapes) over B6's device ms
a traced frame (kernels named ``hn::residual_kernel``). Fixed cells only: a
grown cell's shapes change."""

import roofline

NEEDS = "trace"
KERNEL = "hn::residual_kernel"


def read(run):
    rec = run.rec
    ms = rec.device_ms(KERNEL)
    bound = roofline.residual_ms(rec.shapes) if rec.shapes else 0.0
    return 100.0 * bound / ms if ms and bound else None
