"""The fire (BASELINE config 3): the burner fireball of ``models/fire.py``,
combustion and vorticity confinement on.

The configuration's ``"burner"`` gives ``FireConfig``'s disk: ``center``,
``radius`` and ``height`` (voxels), ``fuel_rate``, ``ignition_temp`` and
``swirl``; its ``"emitter"`` is the sphere the seeded start draws its fuel
and flame in (``inputs.start_fields``), and nothing else. A fixed cell's
tiles are the configuration's envelope; the fire adds no field to the six.

The program's side drives ``models/fire.fire_step``; the reference's side
is ``reference/fire.py``. On the program's first frame ``Driver`` holds the
port's always-on count ``vorticity.applies`` (``ops/stencil.applies``) to
one more, so that a program whose confinement stops acting fails the cell
instead of timing a cheaper step; a program without that count is not held
to it. It runs fixed cells only: ``start_tiles`` refuses a grown one.
"""

from __future__ import annotations

import sys

import numpy as np

import inputs
import program_spans
from reference import fire as ref
from reference import topology as rt

SOLVER: dict = {}
COUNT = ("hnanosolver_tpu_torch.ops.stencil", "applies")  # the confinement's count


def start_tiles(cell) -> np.ndarray:
    """The configuration's envelope."""
    if cell.traffic["topology"] != "fixed":
        raise ValueError("the fire scene runs fixed cells only")
    return inputs.envelope(cell.config)


def extra_fields(cell, topo: rt.Topo, generator, device) -> dict:
    """The fire adds no field to the six the harness draws."""
    return {}


class Driver:
    """The program's frame: ``fire_step`` with the configuration's burner."""

    def __init__(self, cell):
        from hnanosolver_tpu_torch.models import fire

        self.fire = fire
        b = cell.config["burner"]
        self.cfg = fire.FireConfig(
            center=tuple(float(c) for c in b["center"]), radius=float(b["radius"]),
            height=float(b["height"]), fuel_rate=float(b["fuel_rate"]),
            ignition_temp=float(b["ignition_temp"]), swirl=float(b["swirl"]))
        self.checked = False

    def step(self, topo, state, params, hier, index: int):
        if self.checked:
            return self.fire.fire_step(topo, state, params, self.cfg, hier)
        before = program_spans.count(*COUNT)
        out = self.fire.fire_step(topo, state, params, self.cfg, hier)
        after = program_spans.count(*COUNT)
        if before is None:
            print("the program has no vorticity.applies count: its confinement is not checked",
                  file=sys.stderr)
        elif after - before != 1:
            raise RuntimeError(f"a fire frame applied the vorticity confinement {after - before} "
                               "times, expected 1")
        self.checked = True
        return out


def frame(cell, topo: rt.Topo, state: dict, levels: list, index: int) -> dict:
    return ref.frame(topo, state, cell.solver(), cell.config["burner"], levels)
