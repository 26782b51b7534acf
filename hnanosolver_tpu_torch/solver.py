"""The full simulation step and the standalone operator entry points.

``step`` runs the reference's kernel order:

  1. enforce collision boundaries on u             (with a collision SDF)
  2. u* = BFECC self-advection of u (SDF trace rejection and no-slip tail)
  3. u* += vorticity confinement force (an exact no-op at the default
     factor_scale 0.5)
  4. div = divergence(u*)                            (kernel B7a)
  5. combustion: burn fuel, heat, div += burn*expansion
  6. u* += buoyancy from the post-combustion temperature
  7. p = red-black SOR (``iterations`` red+black pairs) or, with
     ``pressure_solver="mg"`` and a hierarchy, multigrid
  8. u = u* - grad(p)                                (kernel B7b)
  9. enforce collision boundaries on u, twice        (with a collision SDF)
 10. scalars advected by the projected u (post-combustion values), skipping
     ``collision_sdf``, which is carried over unchanged
 11. null and padding rows zeroed (``mask_state``)

Each phase runs inside a device span of ``utils/profiling`` (on only
while a profiler records): ``step.collide`` (1), ``step.advect_velocity``
(2), ``step.forces`` (3-6), ``step.pressure`` (7), ``step.project`` (8-9),
``step.advect_scalars`` (10) and ``step.mask`` (11); nothing of the step
is launched outside them.

The collision SDF is the ``collision_sdf`` scalar, used when
``params.has_collision`` is set; without that field the step runs without
collision, as the JAX package's does.

``project`` and ``divergence_only`` are the HNanoProjectNonDivergent
operator; ``advect_scalars`` and ``advect_velocity`` are HNanoAdvect and
HNanoAdvectVelocity.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from hnanosolver_tpu_torch.config import SolverParams
from hnanosolver_tpu_torch.core.topology import Topology
from hnanosolver_tpu_torch.fields import (
    COLLISION_FIELD, COMBUSTION_FIELDS, FieldState, mask_state)
from hnanosolver_tpu_torch.ops import advection as adv
from hnanosolver_tpu_torch.ops import collision as col
from hnanosolver_tpu_torch.ops import combustion as comb
from hnanosolver_tpu_torch.ops import multigrid as mg
from hnanosolver_tpu_torch.ops import pressure as prs
from hnanosolver_tpu_torch.ops import stencil as stn
from hnanosolver_tpu_torch.utils.profiling import span


def _require_combustion_fields(state: FieldState):
    missing = [f for f in COMBUSTION_FIELDS if f not in state.scalars]
    if missing:
        raise ValueError(f"missing required combustion fields: {missing}")


def _identity(f):
    return f


def step_impl(topo: Topology, state: FieldState, params: SolverParams,
              hierarchy: tuple = (), refresh=_identity, coarse_reduce=None,
              tol_reduce=None) -> FieldState:
    """One full simulation step on the topology's device. Pure function:
    state in, new state out. ``hierarchy``: coarse levels from
    ``ops.multigrid.hierarchy_for`` when ``params.pressure_solver == "mg"``.

    ``refresh`` is the ghost-exchange hook of the sharded step
    (``parallel/slab.py``), applied right before each op that reads
    cross-tile neighbours, at the JAX package's points; the caller hands in
    ghost-fresh ``state``. On one device it is the identity, and the solvers
    are then given None, which keeps B5 and the B3 blocks (a refresh runs
    the textbook colour sweeps). ``coarse_reduce`` and ``tol_reduce`` go to
    the multigrid solver (``ops/multigrid.solve_pressure_mg``)."""
    _require_combustion_fields(state)
    c = params.combustion
    inv_dx = params.inv_voxel_size
    dt = params.dt

    sdf = state.sdf() if params.has_collision else None
    vel = state.velocity
    if sdf is not None:
        with span("step.collide", device=True):
            vel = refresh(col.enforce_collision(topo, vel, sdf, inv_dx))

    with span("step.advect_velocity", device=True):
        u_star = refresh(adv.advect_velocity(topo, vel, dt, inv_dx, sdf))
    with span("step.forces", device=True):
        u_star = refresh(stn.vorticity_confinement(
            topo, u_star, dt, inv_dx, c.vorticity_scale, c.factor_scale))
        div = stn.divergence(topo, u_star, inv_dx)
        fuel, waste, temp, flame, div = comb.combustion_oxygen(
            state.scalars["fuel"], state.scalars["waste"],
            state.scalars["temperature"], state.scalars["flame"],
            div, c.temperature_release, c.expansion_rate)
        # buoyancy reads the POST-combustion temperature
        u_star = comb.temperature_buoyancy(
            u_star, temp, dt, c.ambient_temp, c.buoyancy_strength)
        div = refresh(div)

    rf_solver = None if refresh is _identity else refresh
    with span("step.pressure", device=True):
        # "mg" with an empty hierarchy runs the RBGS solve: the JAX package's
        # own semantics (hnanosolver_tpu/solver.py:128), not a fallback
        if params.pressure_solver == "mg" and hierarchy:
            p = mg.solve_pressure_mg(
                topo, list(hierarchy), div, params.iterations, params.voxel_size,
                params.omega, tol=params.mg_tol, refresh=rf_solver,
                coarse_reduce=coarse_reduce, fmg=params.mg_fmg, tol_reduce=tol_reduce,
                n_pre=params.mg_pre, n_post=params.mg_post, n_coarsest=params.mg_coarsest)
        else:
            p = prs.solve_pressure(topo, div, params.iterations, params.voxel_size,
                                   params.omega, refresh=rf_solver,
                                   halo_lag=params.effective_halo_lag)
        p = refresh(p)
    with span("step.project", device=True):
        u_star = refresh(u_star)
        vel_out = stn.subtract_pressure_gradient(topo, u_star, p, inv_dx)
        if sdf is not None:
            # the gradient subtraction's collision tail, then the reference's
            # second enforceCollisionBoundaries launch
            vel_out = col.enforce_collision(topo, vel_out, sdf, inv_dx)
            vel_out = col.enforce_collision(topo, vel_out, sdf, inv_dx)
        vel_out = refresh(vel_out)

    with span("step.advect_scalars", device=True):
        to_advect = dict(state.scalars)
        to_advect.update(fuel=fuel, waste=waste, temperature=temp, flame=flame)
        sdf_in = to_advect.pop(COLLISION_FIELD, None)
        to_advect = {k: refresh(v) for k, v in to_advect.items()}
        advected = adv.advect_scalars_fused(topo, vel_out, to_advect, dt, inv_dx, sdf)
    if sdf_in is not None:
        advected[COLLISION_FIELD] = sdf_in  # preserved, not zeroed
    with span("step.mask", device=True):
        return mask_state(topo, FieldState(velocity=vel_out, scalars=advected))


step = step_impl
# The JAX package's frame-loop form donates the input state's buffers to
# XLA; donation is an XLA buffer concept, so here it is the plain step.
step_donated = step_impl


def advect_scalars(topo: Topology, vel: torch.Tensor, scalars: Dict[str, torch.Tensor],
                   dt: float, voxel_size: float) -> Dict[str, torch.Tensor]:
    """HNanoAdvect: BFECC-advect every float field by ``vel``."""
    return adv.advect_scalars_fused(topo, vel, dict(scalars), dt, 1.0 / voxel_size)


def advect_velocity(topo: Topology, vel: torch.Tensor, dt: float,
                    voxel_size: float) -> torch.Tensor:
    """HNanoAdvectVelocity: BFECC self-advection."""
    return adv.advect_velocity(topo, vel, dt, 1.0 / voxel_size)


def project(topo: Topology, vel: torch.Tensor, iterations: int, voxel_size: float,
            halo_lag: int = 5) -> torch.Tensor:
    """HNanoProjectNonDivergent: divergence -> red-black SOR -> gradient
    subtraction. ``iterations`` not a multiple of ``halo_lag`` runs the
    textbook solve (halo_lag 1), as the JAX package does."""
    inv_dx = 1.0 / voxel_size
    div = stn.divergence(topo, vel, inv_dx)
    omega = 2.0 / (1.0 + math.sin(3.14159 * voxel_size))
    p = prs.solve_pressure(topo, div, iterations, voxel_size, omega,
                           halo_lag=halo_lag if iterations % halo_lag == 0 else 1)
    return stn.subtract_pressure_gradient(topo, vel, p, inv_dx)


def divergence_only(topo: Topology, vel: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """HNanoProjectNonDivergent with "output divergence" on."""
    return stn.divergence(topo, vel, 1.0 / voxel_size)
