"""Collision (``ops/collision.py``, ``models/collider.py``): the collision's
share of its roofline, in %: the least time the card could take for the
collision's work in a frame over its device ms a traced frame (the spans
``collide.sdf`` and ``collide.enforce``, as ``collide_device_ms`` reads
them). The work is reckoned from the cell's shapes alone, so that it reads
the same whatever implements the collision: each ``enforce_collision``
call (ENFORCES a frame) reads the SDF and the velocity once and writes the
velocity once, with ENFORCE_OPS float32 operations a voxel (the SDF's
gradient, its length and normal, the blend and the tangential projection);
the SDF's refresh writes one field, with SDF_OPS operations a voxel. Over
every row of the fine capacity T. Fixed cells only: a grown cell's shapes
change."""

import program_spans as spans
import roofline

NEEDS = "trace"
SPANS = ("collide.sdf", "collide.enforce")
ENFORCES = 4  # solver.step_impl with an SDF: step.collide, the velocity tail, two in project
ENFORCE_OPS = 40
SDF_OPS = 10


def bound_ms(shapes: dict) -> float:
    T, F32, VOX = shapes["T"], roofline.F32, roofline.VOX
    enforce = roofline._bound_ms((1 + 3 + 3) * T * VOX * F32, ENFORCE_OPS * T * VOX)
    refresh = roofline._bound_ms(T * VOX * F32, SDF_OPS * T * VOX)
    return ENFORCES * enforce + refresh


def read(run):
    ms = spans.ms_a_frame(run, SPANS)
    shapes = run.rec.shapes if run.rec is not None else None
    return 100.0 * bound_ms(shapes) / ms if ms and shapes else None
