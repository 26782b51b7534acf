"""The moving collider (BASELINE config 4): the rising plume with an
analytic SDF sphere that crosses it at constant velocity, collision on.

The configuration's ``"collider"`` gives the sphere: ``center0`` and
``velocity`` (voxels, voxels/s), ``radius`` (voxels) and ``shell_tiles``,
the tiles kept around it. A fixed cell's tiles are the configuration's
envelope united with the sphere's shell at every frame of a cook, as
``cells.py``'s c4 covers its sweep. The start adds the SDF at frame 0 to
the six fields (nothing drawn); each side refreshes it for the frame's
index within its cook, as the SOP takes a fresh SDF every cook.

The program's side drives ``models/collider.collider_step`` (``SOLVER``
sets ``has_collision``); the reference's side is ``reference/collider.py``.
It runs fixed cells only: ``start_tiles`` refuses a grown one.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

import inputs
import spec
from reference import collider as ref
from reference import topology as rt

plume = spec.scene(Path(__file__).resolve().parents[1], "plume")

SOLVER = {"has_collision": True}


def start_tiles(cell) -> np.ndarray:
    """The envelope and the sphere's shell at every frame of a cook,
    unique."""
    if cell.traffic["topology"] != "fixed":
        raise ValueError("the collider scene runs fixed cells only")
    col, dt = cell.config["collider"], cell.config["solver"]["dt"]
    tiles = [inputs.envelope(cell.config)] + [ref.shell_tiles(col, f, dt) for f in
                                              range(cell.traffic["frames_per_cook"])]
    return np.unique(np.concatenate(tiles).astype(np.int32), axis=0)


def extra_fields(cell, topo: rt.Topo, generator, device) -> dict:
    """The SDF at frame 0 on the active rows (0 on the others); nothing is
    drawn."""
    sdf = ref.sphere_sdf(topo.origins, cell.config["collider"], 0,
                         cell.config["solver"]["dt"], device)
    rows = torch.arange(topo.capacity, device=device)[:, None]
    return {ref.FIELD: sdf * ((rows >= 1) & (rows <= topo.n_active)).float()}


class Driver(plume.Driver):
    """The program's frame: ``collider_step`` given the frame's index."""

    def __init__(self, cell):
        super().__init__(cell)
        from hnanosolver_tpu_torch.models import collider

        self.collider = collider
        c = cell.config["collider"]
        self.col = collider.ColliderConfig(
            center0=tuple(float(v) for v in c["center0"]),
            velocity=tuple(float(v) for v in c["velocity"]), radius=float(c["radius"]))

    def step(self, topo, state, params, hier, index: int):
        return self.collider.collider_step(topo, state, params, self.cfg, self.col, index, hier)


def frame(cell, topo: rt.Topo, state: dict, levels: list, index: int) -> dict:
    return ref.frame(topo, state, cell.solver(), cell.config["emitter"], cell.config["collider"],
                     levels, index)
