"""Collocated central-difference stencil ops on the flat layout: divergence,
pressure-gradient subtraction and vorticity confinement.

Divergence and u - grad(p) are kernels B7a and B7b
(``ops/cuda_stencil.py``). Out-of-domain reads are exact background 0 via
the null tile.
"""

from __future__ import annotations

import torch

from hnanosolver_tpu_torch.ops import cuda_stencil


def divergence(topo, vel: torch.Tensor, inv_dx: float) -> torch.Tensor:
    """div(u) at cell centres: (u_{+1} - u_{-1}) / (2 dx) per axis, the
    three axis terms added left to right. vel [3,T,512] -> [T,512]."""
    return cuda_stencil.divergence(topo.nbr, vel.contiguous(), inv_dx)


def pressure_gradient(topo, p: torch.Tensor, inv_dx: float) -> torch.Tensor:
    """grad(p) at cell centres, [3,T,512] (plain torch)."""
    return cuda_stencil.gradient(topo.nbr, p, inv_dx)


def subtract_pressure_gradient(
    topo, vel: torch.Tensor, p: torch.Tensor, inv_dx: float
) -> torch.Tensor:
    """u <- u* - grad(p); dt/rho is absorbed into p's units."""
    return cuda_stencil.subtract_gradient(topo.nbr, vel.contiguous(), p.contiguous(), inv_dx)


def vorticity_confinement(
    topo,
    vel: torch.Tensor,
    dt: float,
    inv_dx: float,
    confinement_scale: float,
    factor_scale: float,
) -> torch.Tensor:
    """u += scale * (N x omega) * dt with N = normalize(grad |omega|), the
    gradient sampled at integer offset ``s = int(factor_scale)`` (the
    reference truncates the float parameter). With s = 0 every gradient
    component is an exact 0, so the force vanishes and ``vel`` is returned
    unchanged; the default factor_scale 0.5 lands here."""
    s = int(factor_scale)
    if s == 0:
        return vel
    raise NotImplementedError(
        "vorticity confinement with int(factor_scale) >= 1 is not ported yet "
        "(ROADMAP: modules still to port, vorticity s >= 1)"
    )
