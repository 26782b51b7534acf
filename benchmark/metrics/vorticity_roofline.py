"""Forces (``ops/stencil.py``): the vorticity confinement's share of its
roofline, in %: the least time the card could take for the confinement's
work in a frame over its device ms a traced frame (the span
``forces.vorticity``, as ``vorticity_device_ms`` reads it). The work is
reckoned from the cell's shapes alone, so that it reads the same whatever
implements the confinement: one call a frame reads the velocity once and
writes it once (6 fields) over every row of the fine capacity T, with
OPS float32 operations a voxel. Fixed cells only: a grown cell's shapes
change.

OPS, counted from the confinement's arithmetic a voxel:

- omega, the curl: 6 differences of the face values, then a component
  (a - b) * factor: 3 more subtractions and 3 multiplications: 12;
- |omega| at each of the six voxels +-s along an axis: its curl (12), the
  sum of squares (3 multiplications, 2 additions) and the square root:
  18, six times: 108;
- grad |omega|: 3 differences and 3 multiplications by the factor: 6;
- its length plus 1e-5: 3 multiplications, 2 additions, the square root
  and the addition: 7; N, three divisions: 3;
- N x omega: 6 multiplications and 3 subtractions: 9;
- u + scale * force * dt: 2 multiplications and an addition a component: 9.
"""

import program_spans as spans
import roofline

NEEDS = "trace"
SPANS = ("forces.vorticity",)
OPS = 12 + 6 * 18 + 6 + 7 + 3 + 9 + 9  # 154


def bound_ms(shapes: dict) -> float:
    T, F32, VOX = shapes["T"], roofline.F32, roofline.VOX
    return roofline._bound_ms((3 + 3) * T * VOX * F32, OPS * T * VOX)


def read(run):
    ms = spans.ms_a_frame(run, SPANS)
    shapes = run.rec.shapes if run.rec is not None else None
    return 100.0 * bound_ms(shapes) / ms if ms and shapes else None
