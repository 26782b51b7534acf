"""Pressure solve: red-black SOR on the 7-point Laplacian,

    pGS = (sum_{6 nbrs} p - div * dx^2) / 6
    p  += omega * (pGS - p)      for voxels of the active colour

one iteration being a red sweep then a black sweep. Out-of-domain pressure
reads are background 0 (Dirichlet p = 0 on the sparse boundary).

``solve_pressure`` dispatches as the JAX package's TPU ("pallas") branch
does (``hnanosolver_tpu/ops/pressure.py:69-109``), in this order:

1. T <= ``MAX_FUSED_ROWS``: the whole textbook solve in one launch (B5).
2. ``halo_lag > 1`` or ``pair_blocks``: ``iterations // halo_lag`` lagged
   blocks (B3); the remainder as textbook colour sweeps (B4).
3. otherwise the textbook solve as one B4 launch per colour sweep.

``mask`` (multigrid coarse levels) is the in-domain voxel mask: ``p``
enters multiplied by it and voxels outside it never update.
"""

from __future__ import annotations

import torch

from hnanosolver_tpu_torch.ops import cuda_pressure, cuda_stencil


def solve_pressure(
    topo,
    div: torch.Tensor,
    iterations: int,
    dx: float,
    omega: float,
    p0: torch.Tensor | None = None,
    halo_lag: int = 1,
    pair_blocks: bool = False,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Run ``iterations`` red+black SOR pairs from p0 (zeros by default).
    div, p: [T,512]. Returns a new tensor."""
    if halo_lag < 1:
        raise ValueError(f"halo_lag must be >= 1, got {halo_lag}")
    dx2 = dx * dx
    if div.shape[0] <= cuda_pressure.MAX_FUSED_ROWS:
        return cuda_pressure.rbsor_fused(topo.nbr, div, iterations, omega, dx2,
                                         p0=p0, mask=mask)
    p = torch.zeros_like(div) if p0 is None else p0
    if mask is not None:
        p = p * mask
    blocks = iterations // halo_lag if halo_lag > 1 or pair_blocks else 0
    for _ in range(blocks):
        p = cuda_pressure.rbsor_lagged(topo.nbr, p, div, halo_lag, omega, dx2, mask)
    rem = iterations - blocks * halo_lag
    if rem and p is p0:
        p = p.clone()  # the colour sweeps update in place
    for _ in range(rem):
        for color in (0, 1):
            p = cuda_pressure.rbsor_color(topo.nbr, p, div, color, omega, dx2, mask)
    return p


def residual(topo, p: torch.Tensor, div: torch.Tensor, dx: float) -> torch.Tensor:
    """Pointwise residual r = div - L(p), L(p) = (sum nbrs - 6 p) / dx^2
    (kernel B6)."""
    return cuda_stencil.residual(topo.nbr, p, div, dx)
