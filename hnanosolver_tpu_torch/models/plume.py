"""Rising smoke/fire plume, the flagship scenario: a sphere emitter sources
density, temperature and fuel every frame, then the solver steps, and every
``grow_every`` frames the topology follows the plume
(``core/activation.expand_for_state``), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from hnanosolver_tpu_torch.config import SolverParams
from hnanosolver_tpu_torch.core import coords as C
from hnanosolver_tpu_torch.core.activation import expand_for_state
from hnanosolver_tpu_torch.core.layout import positions_flat
from hnanosolver_tpu_torch.core.topology import Topology, active_mask, build_topology
from hnanosolver_tpu_torch.fields import FieldState, zeros_state
from hnanosolver_tpu_torch.ops.multigrid import hierarchy_for
from hnanosolver_tpu_torch.solver import step


@dataclasses.dataclass(frozen=True)
class PlumeConfig:
    """Emitter + domain description; defaults give a 256^3-class plume."""

    center: Tuple[float, float, float] = (128.0, 24.0, 128.0)
    radius: float = 20.0
    density_rate: float = 2.0  # density added per second inside the emitter
    fuel_rate: float = 1.0
    temperature_target: float = 150.0  # emitter relaxes T toward this
    velocity_jet: float = 8.0  # upward velocity set inside the emitter
    dilate_radius: int = 1
    occupancy_threshold: float = 1e-3
    padding: "int | None" = None


def emitter_tiles(cfg: PlumeConfig, pad: int = 1) -> np.ndarray:
    """Tile coords covering the emitter sphere (+pad tiles)."""
    c = np.asarray(cfg.center)
    r = cfg.radius + pad * C.LEAF
    lo = np.floor((c - r) / C.LEAF).astype(np.int32)
    hi = np.ceil((c + r) / C.LEAF).astype(np.int32)
    gx, gy, gz = np.meshgrid(*(np.arange(l, h + 1) for l, h in zip(lo, hi)),
                             indexing="ij")
    tiles = np.stack([gx, gy, gz], -1).reshape(-1, 3)
    tc = (tiles + 0.5) * C.LEAF
    keep = np.linalg.norm(tc - c, axis=-1) <= r + C.LEAF
    return tiles[keep]


def build_plume_envelope(radius_vox=64, height_vox=256, center_x=128, center_z=128):
    """Tile set for a developed plume: emitter sphere + rising column (the
    bench domain: 4196 tiles at the defaults)."""
    r_t = radius_vox // C.LEAF
    h_t = height_vox // C.LEAF
    cx, cz = center_x // C.LEAF, center_z // C.LEAF
    tiles = []
    for y in range(h_t):
        # column widens slightly with height (plume cone)
        rr = r_t * (0.6 + 0.4 * y / max(h_t - 1, 1))
        for x in range(cx - r_t, cx + r_t + 1):
            for z in range(cz - r_t, cz + r_t + 1):
                if (x - cx) ** 2 + (z - cz) ** 2 <= rr * rr:
                    tiles.append((x, y, z))
    return np.array(tiles, np.int32)


def initial_topology(cfg: PlumeConfig, capacity: Optional[int] = None,
                     device: torch.device | str | None = None) -> Topology:
    """The emitter's tiles on ``device`` (default: the CUDA card)."""
    return build_topology(emitter_tiles(cfg, pad=1), capacity=capacity, device=device)


def emit(topo: Topology, state: FieldState, cfg: PlumeConfig, dt: float) -> FieldState:
    """Additive sourcing inside the emitter sphere."""
    px, py, pz = (p.to(torch.float32) for p in positions_flat(topo))
    d2 = (px - cfg.center[0]) ** 2 + (py - cfg.center[1]) ** 2 + (pz - cfg.center[2]) ** 2
    inside = (d2 < cfg.radius ** 2).to(torch.float32) * active_mask(topo)[:, None]
    hot = inside > 0

    s = dict(state.scalars)
    s["density"] = s["density"] + inside * (cfg.density_rate * dt)
    s["fuel"] = torch.clamp(s["fuel"] + inside * (cfg.fuel_rate * dt), max=1.0)
    s["temperature"] = torch.where(
        hot, torch.clamp(s["temperature"], min=cfg.temperature_target),
        s["temperature"])
    vel = state.velocity.clone()
    vel[1] = torch.where(hot, cfg.velocity_jet, state.velocity[1])
    return FieldState(velocity=vel, scalars=s)


def plume_step(topo: Topology, state: FieldState, params: SolverParams,
               cfg: PlumeConfig, hierarchy: tuple = ()) -> FieldState:
    """Emit + one full solver step. ``hierarchy``: from
    ``ops.multigrid.hierarchy_for`` when params selects multigrid."""
    return step(topo, emit(topo, state, cfg, params.dt), params, hierarchy)


def run_plume(
    frames: int,
    params: Optional[SolverParams] = None,
    cfg: Optional[PlumeConfig] = None,
    topo: Optional[Topology] = None,
    state: Optional[FieldState] = None,
    grow_every: int = 1,
    on_frame=None,
    device: torch.device | str | None = None,
):
    """Frame loop: step, then every ``grow_every`` frames (0: never)
    re-activate the topology around the matter, keeping the emitter's
    tiles. Returns (topo, state). ``device`` (default: the CUDA card) is
    used only when ``topo`` is not given."""
    params = params or SolverParams()
    cfg = cfg or PlumeConfig()
    if topo is None:
        topo = initial_topology(cfg, device=device)
    if state is None:
        state = zeros_state(topo)
    keep = emitter_tiles(cfg, pad=1)
    hier = hierarchy_for(topo, params)
    for f in range(frames):
        state = plume_step(topo, state, params, cfg, hier)
        if grow_every and (f + 1) % grow_every == 0:
            prev = topo
            topo, state = expand_for_state(
                topo, state, threshold=cfg.occupancy_threshold, radius=cfg.dilate_radius,
                keep_tiles=keep, padding=cfg.padding)
            if topo is not prev:
                hier = hierarchy_for(topo, params)
        if on_frame is not None:
            on_frame(f, topo, state)
    return topo, state
