"""The full simulation step, in the reference's kernel order:

  1. u* = BFECC self-advection of u
  2. u* += vorticity confinement force (an exact no-op at the default
     factor_scale 0.5)
  3. div = divergence(u*)
  4. combustion: burn fuel, heat, div += burn*expansion
  5. u* += buoyancy from the post-combustion temperature
  6. p = red-black SOR, ``iterations`` red+black pairs
  7. u = u* - grad(p)
  8. scalars advected by the projected u (post-combustion values)
  9. null and padding rows zeroed (``mask_state``)

The collision and multigrid branches raise until their ROADMAP items land.
"""

from __future__ import annotations

from hnanosolver_tpu_torch.config import SolverParams
from hnanosolver_tpu_torch.core.topology import Topology
from hnanosolver_tpu_torch.fields import COMBUSTION_FIELDS, FieldState, mask_state
from hnanosolver_tpu_torch.ops import advection as adv
from hnanosolver_tpu_torch.ops import combustion as comb
from hnanosolver_tpu_torch.ops import pressure as prs
from hnanosolver_tpu_torch.ops import stencil as stn


def _require_supported(state: FieldState, params: SolverParams):
    missing = [f for f in COMBUSTION_FIELDS if f not in state.scalars]
    if missing:
        raise ValueError(f"missing required combustion fields: {missing}")
    if params.has_collision:
        raise NotImplementedError(
            "collision is not ported yet (ROADMAP: modules still to port, collision)")
    if params.pressure_solver != "rbgs":
        raise NotImplementedError(
            f"pressure_solver {params.pressure_solver!r} is not ported yet "
            "(ROADMAP: modules still to port, multigrid)")


def step_impl(topo: Topology, state: FieldState, params: SolverParams) -> FieldState:
    """One full simulation step on the topology's device. Pure function:
    state in, new state out."""
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

    p = prs.solve_pressure(topo, div, params.iterations, params.voxel_size,
                           params.omega, halo_lag=params.effective_halo_lag)
    vel_out = stn.subtract_pressure_gradient(topo, u_star, p, inv_dx)

    to_advect = dict(state.scalars)
    to_advect.update(fuel=fuel, waste=waste, temperature=temp, flame=flame)
    advected = adv.advect_scalars_fused(topo, vel_out, to_advect, dt, inv_dx)
    return mask_state(topo, FieldState(velocity=vel_out, scalars=advected))


step = step_impl
