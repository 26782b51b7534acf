"""Dense full-step oracle: the pipeline order of ``solver.step``, on plain
dense tensors (``dense/ops.py``), in the JAX package's ``dense/solver.py``
order. No collision, no emitter and no ``mask_state``."""

from __future__ import annotations

from typing import Dict

import torch

from hnanosolver_tpu_torch.config import SolverParams
from hnanosolver_tpu_torch.dense import ops as D


def step_dense(vel: torch.Tensor, scalars: Dict[str, torch.Tensor], params: SolverParams):
    """One step; returns (vel, scalars). ``vel`` is [Nx,Ny,Nz,3], each
    scalar [Nx,Ny,Nz]; the scalars must include the combustion fields
    fuel/waste/temperature/flame (the reference's contract)."""
    c = params.combustion
    inv_dx = params.inv_voxel_size
    dt = params.dt

    u_star = D.advect_bfecc(vel, vel, dt, inv_dx)
    u_star = D.vorticity_confinement(u_star, dt, inv_dx, c.vorticity_scale, c.factor_scale)
    div = D.divergence(u_star, inv_dx)

    zero = torch.zeros((), dtype=vel.dtype, device=vel.device)
    fuel = torch.where(scalars["fuel"] < 0.001, zero, scalars["fuel"])
    waste, temp, flame = scalars["waste"], scalars["temperature"], scalars["flame"]
    oxygen = 1.0 - fuel - waste
    valid = oxygen >= 0.0
    burn = torch.where(valid, torch.minimum(oxygen, fuel), zero)
    fuel = fuel - burn
    waste = waste + burn * 2.0
    flame = torch.where(valid, torch.maximum(flame, torch.clamp(burn * 10.0, max=1.0)), flame)
    temp = temp + burn * c.temperature_release
    div = div + burn * c.expansion_rate

    lift = torch.clamp(temp - c.ambient_temp, min=0.0) * c.buoyancy_strength * dt
    u_star = torch.stack([u_star[..., 0], u_star[..., 1] + lift, u_star[..., 2]], dim=-1)

    p = D.solve_pressure(div, params.iterations, params.voxel_size, params.omega)
    vel_out = D.subtract_pressure_gradient(u_star, p, inv_dx)

    out = dict(scalars)
    out.update(fuel=fuel, waste=waste, temperature=temp, flame=flame)
    out = {k: D.advect_bfecc(vel_out, v, dt, inv_dx) for k, v in out.items()}
    return vel_out, out
