"""pressure (ops/pressure.py -> csrc/rbsor_lagged.cu): B3's share of its
roofline, in %: the least time the card could take for the work a frame
gives B3 (``roofline.rbsor_lagged_ms`` of the cell's shapes) over B3's
device ms a traced frame (kernels named ``hn::rbsor_lagged_kernel``). Fixed
cells only: a grown cell's shapes change."""

import roofline

NEEDS = "trace"
KERNEL = "hn::rbsor_lagged_kernel"


def read(run):
    rec = run.rec
    ms = rec.device_ms(KERNEL)
    bound = roofline.rbsor_lagged_ms(rec.shapes) if rec.shapes else 0.0
    return 100.0 * bound / ms if ms and bound else None
