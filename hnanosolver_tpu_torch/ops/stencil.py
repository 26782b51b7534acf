"""Collocated central-difference stencil ops on the flat layout: divergence,
pressure-gradient subtraction and vorticity confinement.

Divergence and u - grad(p) are kernels B7a and B7b
(``ops/cuda_stencil.py``); the curl and vorticity confinement are plain
torch, as they were XLA in the JAX package. Out-of-domain reads are exact
background 0 via the null tile.
"""

from __future__ import annotations

import torch

from hnanosolver_tpu_torch.ops import cuda_stencil
from hnanosolver_tpu_torch.ops.shifts import offset_view, shifted_view


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


def _curl_mag_at_offset(topo, vel: torch.Tensor, off, factor: float) -> torch.Tensor:
    """|curl u| evaluated at voxel + off (nonzero just outside the active
    set, as the reference's pointwise recomputation is)."""
    def v(c, o):
        return offset_view(topo, vel[c], (off[0] + o[0], off[1] + o[1], off[2] + o[2]))

    wx = ((v(2, (0, 1, 0)) - v(2, (0, -1, 0))) - (v(1, (0, 0, 1)) - v(1, (0, 0, -1)))) * factor
    wy = ((v(0, (0, 0, 1)) - v(0, (0, 0, -1))) - (v(2, (1, 0, 0)) - v(2, (-1, 0, 0)))) * factor
    wz = ((v(1, (1, 0, 0)) - v(1, (-1, 0, 0))) - (v(0, (0, 1, 0)) - v(0, (0, -1, 0)))) * factor
    return torch.sqrt(wx * wx + wy * wy + wz * wz)


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
    factor_scale 0.5 lands here."""
    s = int(factor_scale)
    if s == 0:
        return vel
    factor = 0.5 * inv_dx
    omega = curl(topo, vel, factor)

    def grad(axis):
        p, m = [0, 0, 0], [0, 0, 0]
        p[axis], m[axis] = s, -s
        return (_curl_mag_at_offset(topo, vel, p, factor)
                - _curl_mag_at_offset(topo, vel, m, factor)) * factor

    g = torch.stack([grad(0), grad(1), grad(2)])
    glen = torch.sqrt(torch.sum(g * g, dim=0, keepdim=True)) + 1e-5
    N = g / glen
    force = torch.stack([
        N[1] * omega[2] - N[2] * omega[1],
        N[2] * omega[0] - N[0] * omega[2],
        N[0] * omega[1] - N[1] * omega[0],
    ])
    return vel + confinement_scale * force * dt
