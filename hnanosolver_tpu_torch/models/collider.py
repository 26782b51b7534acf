"""Moving-collider scenario: a plume with an animated solid (BASELINE
config 4).

Houdini feeds a fresh collision SDF into the solver every cook; here the
``collision_sdf`` field is evaluated on the device each frame from an
analytic sphere translating at constant velocity, then the plume is emitted
and the solver steps with collision on.

Every ``grow_every`` frames the topology follows the plume and keeps the
emitter and the collider's shell at the next frame active, as in the JAX
package.
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
from hnanosolver_tpu_torch.core.topology import Topology, build_topology
from hnanosolver_tpu_torch.fields import COLLISION_FIELD, FieldState, zeros_state
from hnanosolver_tpu_torch.models import plume as P
from hnanosolver_tpu_torch.ops.multigrid import hierarchy_for
from hnanosolver_tpu_torch.solver import step
from hnanosolver_tpu_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class ColliderConfig:
    """A sphere translating at constant velocity (index-space units, like
    PlumeConfig): center(frame) = center0 + velocity * frame * dt."""

    center0: Tuple[float, float, float] = (100.0, 64.0, 128.0)
    velocity: Tuple[float, float, float] = (48.0, 0.0, 0.0)  # voxels/sec
    radius: float = 12.0


def sphere_sdf(topo: Topology, center: torch.Tensor, radius: float) -> torch.Tensor:
    """Index-space signed distance to a sphere at ``center`` ([3] float32
    tensor), [T,512], on every row (the null and padding rows hold their
    sentinel origins' distances)."""
    px, py, pz = (p.to(torch.float32) for p in positions_flat(topo))
    d = torch.sqrt((px - center[0]) ** 2 + (py - center[1]) ** 2 + (pz - center[2]) ** 2)
    return d - radius


def collider_center(col: ColliderConfig, frame, dt: float, device=None) -> torch.Tensor:
    """center0 + velocity * (frame * dt), in float32 as the JAX package
    computes it."""
    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    return f32(col.center0) + f32(col.velocity) * (f32(float(frame)) * dt)


def collider_step(topo: Topology, state: FieldState, params: SolverParams,
                  cfg: P.PlumeConfig, col: ColliderConfig, frame: int,
                  hierarchy: tuple = ()) -> FieldState:
    """Refresh the animated SDF for ``frame``, emit, and take one solver
    step (``params.has_collision`` must be set for the SDF to act). Traced
    (``utils/profiling``), the span ``collider.step`` starts a frame and
    holds the device span ``step.emit`` (the SDF's refresh and the emit)
    and the step's phase spans; the refresh is the device span
    ``collide.sdf`` inside ``step.emit``."""
    with profiling.frame("collider.step"):
        with profiling.span("step.emit", device=True):
            with profiling.span("collide.sdf", device=True):
                center = collider_center(col, frame, params.dt, topo.device)
                state = state.with_scalar(COLLISION_FIELD, sphere_sdf(topo, center, col.radius))
            state = P.emit(topo, state, cfg, params.dt)
        return step(topo, state, params, hierarchy)


collider_step_donated = collider_step  # donation is an XLA buffer concept (solver.step_donated)


def collider_tiles(col: ColliderConfig, frame: int, dt: float,
                   shell: float = 2.0) -> np.ndarray:
    """Tile coords overlapping the collider's boundary shell at ``frame``,
    kept active so the no-slip boundary stays resolved where the plume has
    not reached yet."""
    c = np.asarray(col.center0) + np.asarray(col.velocity) * (frame * dt)
    r = col.radius + shell * C.LEAF
    lo = np.floor((c - r) / C.LEAF).astype(np.int32)
    hi = np.ceil((c + r) / C.LEAF).astype(np.int32)
    gx, gy, gz = np.meshgrid(
        *(np.arange(l, h + 1) for l, h in zip(lo, hi)), indexing="ij")
    tiles = np.stack([gx, gy, gz], -1).reshape(-1, 3)
    tc = (tiles + 0.5) * C.LEAF
    keep = np.linalg.norm(tc - c, axis=-1) <= r + C.LEAF
    return tiles[keep]


def run_collider(
    frames: int,
    params: Optional[SolverParams] = None,
    cfg: Optional[P.PlumeConfig] = None,
    col: Optional[ColliderConfig] = None,
    topo: Optional[Topology] = None,
    state: Optional[FieldState] = None,
    grow_every: int = 1,
    on_frame=None,
    interrupter=None,
    device: torch.device | str | None = None,
):
    """Frame loop with the animated SDF and collision on: step, then every
    ``grow_every`` frames (0: never) re-activate the topology, keeping the
    emitter and the collider's shell at the next frame. Returns (topo,
    state). ``device`` (default: the CUDA card) is used only when ``topo``
    is not given; the default topology covers the emitter and the
    collider's shell at frame 0. ``interrupter`` is polled before each
    frame, as in ``plume.run_plume``."""
    params = dataclasses.replace(params or SolverParams(), has_collision=True)
    cfg = cfg or P.PlumeConfig()
    col = col or ColliderConfig()
    if topo is None:
        topo = build_topology(np.concatenate(
            [P.emitter_tiles(cfg, pad=1), collider_tiles(col, 0, params.dt)]), device=device)
    if state is None:
        state = zeros_state(topo)
    if COLLISION_FIELD not in state.scalars:
        state = state.with_scalar(COLLISION_FIELD, sphere_sdf(
            topo, collider_center(col, 0, params.dt, topo.device), col.radius))
    hier = hierarchy_for(topo, params)
    for f in range(frames):
        if interrupter is not None and interrupter.was_interrupted():
            break
        state = collider_step(topo, state, params, cfg, col, f, hier)
        if grow_every and (f + 1) % grow_every == 0:
            keep = np.concatenate([P.emitter_tiles(cfg, pad=1),
                                   collider_tiles(col, f + 1, params.dt)])
            prev = topo
            topo, state = expand_for_state(
                topo, state, threshold=cfg.occupancy_threshold, radius=cfg.dilate_radius,
                keep_tiles=keep, padding=cfg.padding)
            if topo is not prev:
                with profiling.span("grow.hierarchy"):
                    hier = hierarchy_for(topo, params)
        if on_frame is not None:
            on_frame(f, topo, state)
    return topo, state
