"""A scene for the tests alone: the plume whose emitter centre moves with the
frame's index within its cook, ``center + motion * index`` (voxels), and a
passive scalar ``dye`` that its start adds. ``test_harness_scene.py`` copies
it into a copy of the benchmark as ``scenes/moving_emitter.py``, beside a
configuration and a cell of its own: new files only. It runs fixed cells."""

from __future__ import annotations

import dataclasses
from pathlib import Path

import torch

import spec
from reference import step

plume = spec.scene(Path(__file__).resolve().parents[1], "plume")

SOLVER = plume.SOLVER
start_tiles, occupancy = plume.start_tiles, plume.occupancy


def center(cell, index: int) -> list:
    em = cell.config["emitter"]
    return [float(c + m * index) for c, m in zip(em["center"], cell.config["motion"])]


def extra_fields(cell, topo, generator, device) -> dict:
    rows = torch.arange(topo.capacity, device=device)[:, None]
    active = ((rows >= 1) & (rows <= topo.n_active)).float()
    dye = torch.rand((topo.capacity, 512), generator=generator, device=device)
    return {"dye": cell.config["dye"] * dye * active}


class Driver(plume.Driver):
    def __init__(self, cell):
        super().__init__(cell)
        self.cell = cell

    def step(self, topo, state, params, hier, index: int):
        cfg = dataclasses.replace(self.cfg, center=tuple(center(self.cell, index)))
        return self.plume.plume_step(topo, state, params, cfg, hier)

    def cook(self, *args):
        raise NotImplementedError("the moving emitter runs fixed cells only")


def frame(cell, topo, state: dict, levels: list, index: int) -> dict:
    em = {**cell.config["emitter"], "center": center(cell, index)}
    return step.frame(topo, state, cell.solver(), em, levels)
