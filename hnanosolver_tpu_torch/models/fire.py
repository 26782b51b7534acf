"""Fire / combustion scenario (BASELINE config 3): a fuel-rich burner disk
emits fuel and heat; oxygen-limited combustion releases temperature,
expansion drives divergence, buoyancy and vorticity confinement (at
``int(factor_scale)`` = 1) shape the fireball, and the topology grows
every frame. Counterpart of ``hnanosolver_tpu/models/fire.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from hnanosolver_tpu_torch.config import CombustionParams, SolverParams
from hnanosolver_tpu_torch.core import coords as C
from hnanosolver_tpu_torch.core.activation import expand_for_state
from hnanosolver_tpu_torch.core.layout import positions_flat
from hnanosolver_tpu_torch.core.topology import Topology, active_mask, build_topology
from hnanosolver_tpu_torch.fields import FieldState, zeros_state
from hnanosolver_tpu_torch.ops.multigrid import hierarchy_for
from hnanosolver_tpu_torch.solver import step


@dataclasses.dataclass(frozen=True)
class FireConfig:
    """Burner disk on the ground plane, defaults tuned for a fireball."""

    center: Tuple[float, float, float] = (64.0, 8.0, 64.0)
    radius: float = 14.0
    height: float = 4.0  # burner slab thickness in voxels
    fuel_rate: float = 4.0  # fuel injected per second
    ignition_temp: float = 80.0  # burner floor temperature
    swirl: float = 2.0  # tangential velocity seed
    dilate_radius: int = 1
    occupancy_threshold: float = 1e-3
    # voxel-granularity dilation (the reference SOP's "padding" param);
    # None = tile-granularity dilate_radius
    padding: "int | None" = None


def default_params() -> SolverParams:
    return SolverParams(
        dt=1.0 / 24.0,
        voxel_size=0.5,
        iterations=24,
        combustion=CombustionParams(
            expansion_rate=0.6,
            temperature_release=25.0,
            buoyancy_strength=2.0,
            ambient_temp=23.0,
            vorticity_scale=2.0,
            factor_scale=1.0,  # integer offset: confinement acts
        ),
    )


def burner_tiles(cfg: FireConfig, pad: int = 1) -> np.ndarray:
    c = np.asarray(cfg.center)
    r = cfg.radius + pad * C.LEAF
    lo = np.floor((c - [r, cfg.height + 8, r]) / C.LEAF).astype(np.int32)
    hi = np.ceil((c + [r, cfg.height + 8, r]) / C.LEAF).astype(np.int32)
    gx, gy, gz = np.meshgrid(*(np.arange(l, h + 1) for l, h in zip(lo, hi)), indexing="ij")
    return np.stack([gx, gy, gz], -1).reshape(-1, 3)


def initial(cfg: FireConfig, capacity: Optional[int] = None,
            device: torch.device | str | None = None):
    """(topology of the burner's tiles, zero state) on ``device`` (default:
    the CUDA card)."""
    topo = build_topology(burner_tiles(cfg), capacity=capacity, device=device)
    return topo, zeros_state(topo)


def emit(topo: Topology, state: FieldState, cfg: FireConfig, dt: float) -> FieldState:
    """Fuel, heat and soot inside the burner slab, and a tangential swirl
    around its axis."""
    px, py, pz = (p.to(torch.float32) for p in positions_flat(topo))
    dx = px - cfg.center[0]
    dz = pz - cfg.center[2]
    r2 = dx * dx + dz * dz
    in_disk = (r2 < cfg.radius ** 2) & (torch.abs(py - cfg.center[1]) < cfg.height)
    inside = in_disk.to(torch.float32) * active_mask(topo)[:, None]

    s = dict(state.scalars)
    s["fuel"] = torch.clamp(s["fuel"] + inside * (cfg.fuel_rate * dt), max=1.0)
    s["temperature"] = torch.maximum(s["temperature"], inside * cfg.ignition_temp)
    s["density"] = s["density"] + inside * dt  # soot proxy
    rinv = torch.rsqrt(r2 + 1.0)
    vel = state.velocity.clone()
    vel[0] = vel[0] + inside * cfg.swirl * (-dz) * rinv * dt
    vel[2] = vel[2] + inside * cfg.swirl * dx * rinv * dt
    return FieldState(velocity=vel, scalars=s)


def fire_step(topo: Topology, state: FieldState, params: SolverParams, cfg: FireConfig,
              hierarchy: tuple = ()) -> FieldState:
    """Emit + one full solver step."""
    return step(topo, emit(topo, state, cfg, params.dt), params, hierarchy)


def run_fire(frames: int, params: Optional[SolverParams] = None,
             cfg: Optional[FireConfig] = None, topo: Optional[Topology] = None,
             state: Optional[FieldState] = None, grow_every: int = 1, on_frame=None,
             device: torch.device | str | None = None):
    """Frame loop: step, then every ``grow_every`` frames (0: never)
    re-activate the topology, keeping the burner's tiles. Returns (topo,
    state). ``device`` (default: the CUDA card) is used only when ``topo``
    is not given."""
    params = params or default_params()
    cfg = cfg or FireConfig()
    if topo is None:
        topo, state = initial(cfg, device=device)
    if state is None:
        state = zeros_state(topo)
    keep = burner_tiles(cfg)
    hier = hierarchy_for(topo, params)
    for f in range(frames):
        state = fire_step(topo, state, params, cfg, hier)
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
