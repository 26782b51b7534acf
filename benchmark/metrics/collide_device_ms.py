"""Collision (``ops/collision.py``, ``models/collider.py``): device ms a
traced frame in the program's spans ``collide.sdf`` (the SDF's refresh for
the frame, inside ``step.emit``) and ``collide.enforce`` (each
``enforce_collision`` call: four a frame, under ``step.collide``,
``step.advect_velocity`` and ``step.project``). Stream time between each
span's two events (``program_spans.py``): the collision's device time in a
device-bound cell (1024³). None where the program has no such span."""

import program_spans as spans

NEEDS = "trace"
SPANS = ("collide.sdf", "collide.enforce")


def read(run):
    return spans.ms_a_frame(run, SPANS)
