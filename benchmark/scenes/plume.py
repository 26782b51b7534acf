"""The rising plume (bench.py's plume, BASELINE configs 2 and 5): the scene of
every configuration without a ``"scene"`` key.

The program's side drives ``models/plume.plume_step`` and ``run_plume``; the
reference's side is ``reference/step.py``. Neither reads the frame's index:
the plume's emitter and solver are the same at every frame of a cook.
"""

from __future__ import annotations

import numpy as np

import inputs
from reference import step
from reference import topology as rt

SOLVER: dict = {}  # SolverParams keywords beyond the configuration's and the traffic's


def start_tiles(cell) -> np.ndarray:
    """A fixed cell's tiles are the developed plume's envelope; a grown
    cell starts from the emitter's tiles."""
    if cell.traffic["topology"] == "grow":
        em = cell.config["emitter"]
        return rt.emitter_tiles(em["center"], em["radius"], 1)
    return inputs.envelope(cell.config)


def extra_fields(cell, topo: rt.Topo, generator, device) -> dict:
    """The plume adds no field to the six the harness draws."""
    return {}


class Driver:
    """The program's frame and cook. Every call looks the function up on
    ``models.plume`` at call time."""

    def __init__(self, cell):
        from hnanosolver_tpu_torch.models import plume

        self.plume = plume
        em = cell.config["emitter"]
        self.cfg = plume.PlumeConfig(
            center=tuple(float(c) for c in em["center"]), radius=em["radius"],
            density_rate=em["density_rate"], fuel_rate=em["fuel_rate"],
            temperature_target=em["temperature_target"], velocity_jet=em["velocity_jet"],
            dilate_radius=em["dilate_radius"], occupancy_threshold=em["occupancy_threshold"])

    def step(self, topo, state, params, hier, index: int):
        return self.plume.plume_step(topo, state, params, self.cfg, hier)

    def cook(self, frames: int, params, topo, state, on_frame, interrupter):
        return self.plume.run_plume(frames, params, self.cfg, topo=topo, state=state,
                                    grow_every=1, on_frame=on_frame, interrupter=interrupter)


def frame(cell, topo: rt.Topo, state: dict, levels: list, index: int) -> dict:
    return step.frame(topo, state, cell.solver(), cell.config["emitter"], levels)


def occupancy(topo: rt.Topo, state: dict):
    return step.occupancy(topo, state)


def grown_tiles(cell, topo: rt.Topo, occ: np.ndarray, threshold: float, index: int):
    return step.grown_tiles(topo, occ, threshold, cell.config["emitter"])


def grow(cell, topo: rt.Topo, state: dict, index: int):
    return step.grow(topo, state, cell.config["emitter"])
