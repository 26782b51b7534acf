"""The configurations that ``chip_smoke.py`` and ``profile_step`` drive on
the card, defined once: the bench plume (bench.py's domain and settings),
BASELINE config 5 (the 1024^3 plume cone of tools/scale1024_r5.py), each
with RBGS-50 and with multigrid pressure, and BASELINE config 4 (the bench
plume with a moving SDF sphere).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from hnanosolver_tpu_torch.config import SolverParams
from hnanosolver_tpu_torch.core.topology import Topology, build_topology
from hnanosolver_tpu_torch.models.collider import ColliderConfig, collider_tiles
from hnanosolver_tpu_torch.models.plume import PlumeConfig, build_plume_envelope

# bench.py: 50 pressure iterations at halo_lag 5, 1/24 s, dx 0.5
RBGS50 = SolverParams(dt=1.0 / 24.0, iterations=50, voxel_size=0.5)
# multigrid: FMG + 2 V-cycles a step; mg_levels per domain below
_MG = RBGS50.replace(pressure_solver="mg", iterations=2, mg_fmg=True)
# frames whose collider shells the config-4 topology covers (0..30)
SWEEP_FRAMES = 31


@dataclasses.dataclass(frozen=True)
class Cell:
    envelope: tuple  # build_plume_envelope's arguments
    plume: PlumeConfig
    params: SolverParams
    develop: int  # steps from rest that develop the flow first
    collider: Optional[ColliderConfig] = None  # config 4: the moving sphere

    def topology(self, device: torch.device | str | None = None) -> Topology:
        """The envelope's tiles, united with the collider's shell at every
        frame of its sweep where there is a collider (a fixed topology in
        place of per-frame growth), at bench.py's tight capacity: the active
        tiles and the null row, rounded up to a multiple of 512."""
        tiles = build_plume_envelope(*self.envelope)
        if self.collider is not None:
            tiles = np.concatenate([tiles] + [
                collider_tiles(self.collider, f, self.params.dt) for f in range(SWEEP_FRAMES)])
        n = len(np.unique(tiles, axis=0))
        return build_topology(tiles, capacity=((n + 1 + 511) // 512) * 512, device=device)


# 4196 tiles, capacity 4608
_BENCH = dict(envelope=(64, 256), plume=PlumeConfig(center=(128.0, 24.0, 128.0), radius=20.0),
              develop=20)
# 269,104 tiles (137.8 M voxels), capacity 269,312
_C5 = dict(envelope=(256, 1024, 512, 512),
           plume=PlumeConfig(center=(512.0, 96.0, 512.0), radius=80.0, velocity_jet=8.0),
           develop=4)
CELLS = {
    "bench": Cell(**_BENCH, params=RBGS50),
    "bench-mg": Cell(**_BENCH, params=_MG.replace(mg_levels=2)),
    "c5": Cell(**_C5, params=RBGS50),
    "c5-mg": Cell(**_C5, params=_MG.replace(mg_levels=5)),
    # 4354 tiles, capacity 4608: a sphere of radius 12 crossing the bench
    # plume at 2 voxels a frame (the `collide` CLI's speed), RBGS-50
    "c4": Cell(**_BENCH, params=RBGS50.replace(has_collision=True),
               collider=ColliderConfig(center0=(104.0, 96.0, 128.0),
                                       velocity=(48.0, 0.0, 0.0), radius=12.0)),
}
