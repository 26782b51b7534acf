"""Advection (ops/advection.py -> csrc/bfecc_sample.cu, its SDF instances):
B1's share of its roofline in a cell with a collision SDF, in %: the least
time the card could take for the work a frame gives B1 over B1's device ms
a traced frame (kernels named ``hn::bfecc_sample_kernel``). The work is
``roofline.bfecc_sample_ms``'s (the velocity pass and the scalar pass) with,
in each pass, the SDF read once and its two probes (the back trace's end
and the re-trace's), each a trilinear sample of one field. Fixed cells
only: a grown cell's shapes change."""

import roofline

NEEDS = "trace"
KERNEL = "hn::bfecc_sample_kernel"
PROBES = 2  # SDF samples a voxel a pass


def bound_ms(shapes: dict) -> float:
    T, ns, F32, VOX = shapes["T"], shapes["scalars"], roofline.F32, roofline.VOX
    ms = 0.0
    for nb, f_lo in ((3, 0), (3 + ns, 3)):
        nbytes = (nb + 1 + 2 * (nb - f_lo)) * T * VOX * F32 + roofline._nbr_bytes(T)
        ops = (18 + roofline._sample_ops(nb) + roofline._sample_ops(nb - f_lo)
               + PROBES * roofline._sample_ops(1)) * T * VOX
        ms += roofline._bound_ms(nbytes, ops)
    return ms


def read(run):
    rec = run.rec
    ms = rec.device_ms(KERNEL)
    return 100.0 * bound_ms(rec.shapes) / ms if ms and rec.shapes else None
