"""Collocated central-difference stencil ops on the flat layout: divergence,
pressure-gradient subtraction and vorticity confinement.

Divergence and u - grad(p) are kernels B7a and B7b
(``ops/cuda_stencil.py``) and vorticity confinement is kernel VC
(``ops/cuda_vorticity.py``); the curl is plain torch, as it was XLA in the
JAX package. Out-of-domain reads are exact background 0 via the null tile.

A :func:`vorticity_confinement` call that acts (offset >= 1) is the device
span ``forces.vorticity`` (``utils/profiling``: on only while a profiler
records; inside the step's ``step.forces``) and adds one to the always-on
count :data:`applies` (``vorticity.applies``); a call at offset 0 is
neither.
"""

from __future__ import annotations

import torch

from hnanosolver_tpu_torch.ops import cuda_stencil, cuda_vorticity
from hnanosolver_tpu_torch.ops.shifts import shifted_view
from hnanosolver_tpu_torch.utils import profiling

applies = profiling.Count("vorticity.applies")  # vorticity_confinement calls that act


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


def curl(topo, vel: torch.Tensor, factor: float) -> torch.Tensor:
    """omega = curl(u) by central differences, ``factor`` = 0.5/dx;
    [3,T,512]."""
    ux, uy, uz = vel[0], vel[1], vel[2]

    def dvd(f, off_p, off_m):
        return shifted_view(topo, f, off_p) - shifted_view(topo, f, off_m)

    wx = (dvd(uz, (0, 1, 0), (0, -1, 0)) - dvd(uy, (0, 0, 1), (0, 0, -1))) * factor
    wy = (dvd(ux, (0, 0, 1), (0, 0, -1)) - dvd(uz, (1, 0, 0), (-1, 0, 0))) * factor
    wz = (dvd(uy, (1, 0, 0), (-1, 0, 0)) - dvd(ux, (0, 1, 0), (0, -1, 0))) * factor
    return torch.stack([wx, wy, wz])


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
    reference truncates the float parameter) and normalised with the
    reference's +1e-5. With s = 0 every gradient component is an exact 0,
    so the force vanishes and ``vel`` is returned unchanged; the default
    factor_scale 0.5 lands here. Otherwise the force is one VC launch
    (:func:`cuda_vorticity.vorticity_confinement`, 1 <= |s| <= 7) into a new
    tensor."""
    s = int(factor_scale)
    if s == 0:
        return vel
    applies.add()
    with profiling.span("forces.vorticity", device=True):
        return cuda_vorticity.vorticity_confinement(topo.nbr, vel.contiguous(), dt, inv_dx,
                                                    confinement_scale, s)
