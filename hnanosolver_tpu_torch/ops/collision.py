"""SDF collision boundaries on the flat layout ([T,512] sdf, [3,T,512]
velocity). Plain torch: the JAX package runs these as XLA, never as a
Pallas kernel.

- sdf < 0: inside the solid, velocity is zeroed.
- 0 <= sdf < margin (0.1 voxels): blend toward the no-slip (tangential)
  projection v - (v.n) n with blend = 1 - sdf/blend_denom.
- The normal is the central-difference SDF gradient, normalised (zero
  where its length is <= 1e-6).
- Back traces that land inside the solid are rejected in the advection
  samplers (B1, ``ops/advection.py``), not here.
"""

from __future__ import annotations

from typing import Optional

import torch

from hnanosolver_tpu_torch.ops.stencil import pressure_gradient

COLLISION_MARGIN = 0.1  # voxels


def sdf_normal_field(topo, sdf: torch.Tensor, inv_dx: float) -> torch.Tensor:
    """Normalised SDF gradient at every voxel, [3,T,512]."""
    g = pressure_gradient(topo, sdf, inv_dx)
    glen = torch.sqrt(g[0] * g[0] + g[1] * g[1] + g[2] * g[2])[None]
    return torch.where(glen > 1e-6, g / torch.clamp(glen, min=1e-30), 0.0)


def no_slip(vel: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """Project velocity onto the boundary's tangent plane."""
    vdotn = (vel[0] * normal[0] + vel[1] * normal[1] + vel[2] * normal[2])[None]
    return vel - normal * vdotn


def enforce_collision(
    topo,
    vel: torch.Tensor,
    sdf: torch.Tensor,
    inv_dx: float,
    margin: float = COLLISION_MARGIN,
    blend_denom: Optional[float] = None,
) -> torch.Tensor:
    """Zero inside, distance-blended no-slip within ``margin``.
    ``blend_denom`` (default ``margin``) reproduces the velocity advection's
    quirk of blending with 1 - sdf/1.5 while gating on 0.1."""
    if blend_denom is None:
        blend_denom = margin
    normal = sdf_normal_field(topo, sdf, inv_dx)
    blend = torch.clamp(1.0 - sdf / blend_denom, 0.0, 1.0)[None]
    blended = vel * (1.0 - blend) + no_slip(vel, normal) * blend
    out = torch.where((sdf < margin)[None], blended, vel)
    return torch.where((sdf < 0.0)[None], 0.0, out)
