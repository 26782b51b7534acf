"""advection (ops/advection.py -> csrc/bfecc_tail.cu): B2's share of its
roofline, in %: the least time the card could take for the work a frame
gives B2 (``roofline.bfecc_tail_ms`` of the cell's shapes) over B2's device
ms a traced frame (kernels named ``hn::bfecc_tail_kernel``). Fixed cells
only: a grown cell's shapes change."""

import roofline

NEEDS = "trace"
KERNEL = "hn::bfecc_tail_kernel"


def read(run):
    rec = run.rec
    ms = rec.device_ms(KERNEL)
    bound = roofline.bfecc_tail_ms(rec.shapes) if rec.shapes else 0.0
    return 100.0 * bound / ms if ms and bound else None
