"""The full simulation step and the standalone projection entry points.

``step`` runs the reference's kernel order:

  1. u* = BFECC self-advection of u
  2. u* += vorticity confinement force (an exact no-op at the default
     factor_scale 0.5)
  3. div = divergence(u*)
  4. combustion: burn fuel, heat, div += burn*expansion
  5. u* += buoyancy from the post-combustion temperature
  6. p = red-black SOR (``iterations`` red+black pairs) or, with
     ``pressure_solver="mg"`` and a hierarchy, multigrid
  7. u = u* - grad(p)
  8. scalars advected by the projected u (post-combustion values)
  9. null and padding rows zeroed (``mask_state``)

``project`` and ``divergence_only`` are the HNanoProjectNonDivergent
operator. The collision branch raises until its ROADMAP item lands.
"""

from __future__ import annotations

import math

import torch

from hnanosolver_tpu_torch.config import SolverParams
from hnanosolver_tpu_torch.core.topology import Topology
from hnanosolver_tpu_torch.fields import COMBUSTION_FIELDS, FieldState, mask_state
from hnanosolver_tpu_torch.ops import advection as adv
from hnanosolver_tpu_torch.ops import combustion as comb
from hnanosolver_tpu_torch.ops import multigrid as mg
from hnanosolver_tpu_torch.ops import pressure as prs
from hnanosolver_tpu_torch.ops import stencil as stn


def _require_supported(state: FieldState, params: SolverParams):
    missing = [f for f in COMBUSTION_FIELDS if f not in state.scalars]
    if missing:
        raise ValueError(f"missing required combustion fields: {missing}")
    if params.has_collision:
        raise NotImplementedError(
            "collision is not ported yet (ROADMAP: modules still to port, collision)")


def step_impl(topo: Topology, state: FieldState, params: SolverParams,
              hierarchy: tuple = ()) -> FieldState:
    """One full simulation step on the topology's device. Pure function:
    state in, new state out. ``hierarchy``: coarse levels from
    ``ops.multigrid.hierarchy_for`` when ``params.pressure_solver == "mg"``."""
    _require_supported(state, params)
    c = params.combustion
    inv_dx = params.inv_voxel_size
    dt = params.dt

    u_star = adv.advect_velocity(topo, state.velocity, dt, inv_dx)
    u_star = stn.vorticity_confinement(
        topo, u_star, dt, inv_dx, c.vorticity_scale, c.factor_scale)

    div = stn.divergence(topo, u_star, inv_dx)
    fuel, waste, temp, flame, div = comb.combustion_oxygen(
        state.scalars["fuel"], state.scalars["waste"],
        state.scalars["temperature"], state.scalars["flame"],
        div, c.temperature_release, c.expansion_rate)
    # buoyancy reads the POST-combustion temperature
    u_star = comb.temperature_buoyancy(
        u_star, temp, dt, c.ambient_temp, c.buoyancy_strength)

    # "mg" with an empty hierarchy runs the RBGS solve: the JAX package's
    # own semantics (hnanosolver_tpu/solver.py:128), not a fallback
    if params.pressure_solver == "mg" and hierarchy:
        p = mg.solve_pressure_mg(
            topo, list(hierarchy), div, params.iterations, params.voxel_size,
            params.omega, tol=params.mg_tol, fmg=params.mg_fmg, n_pre=params.mg_pre,
            n_post=params.mg_post, n_coarsest=params.mg_coarsest)
    else:
        p = prs.solve_pressure(topo, div, params.iterations, params.voxel_size,
                               params.omega, halo_lag=params.effective_halo_lag)
    vel_out = stn.subtract_pressure_gradient(topo, u_star, p, inv_dx)

    to_advect = dict(state.scalars)
    to_advect.update(fuel=fuel, waste=waste, temperature=temp, flame=flame)
    advected = adv.advect_scalars_fused(topo, vel_out, to_advect, dt, inv_dx)
    return mask_state(topo, FieldState(velocity=vel_out, scalars=advected))


step = step_impl


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
