"""Pressure solve: red-black SOR on the 7-point Laplacian,

    pGS = (sum_{6 nbrs} p - div * dx^2) / 6
    p  += omega * (pGS - p)      for voxels of the active colour

one iteration being a red sweep then a black sweep. Out-of-domain pressure
reads are background 0 (Dirichlet p = 0 on the sparse boundary).

Two semantics, chosen by ``halo_lag``:
- ``halo_lag > 1``: blocks of ``halo_lag`` pairs with the cross-tile halo
  taken once per block (kernel B3, ``ops/cuda_pressure.py``). In-tile
  neighbours stay fresh.
- ``halo_lag == 1``: the textbook per-colour sweep, halo fresh every colour.
  Plain PyTorch only for now: its kernel (B4) is not ported, so on CUDA it
  raises, as do remainder sweeps (``iterations % halo_lag != 0``).
"""

from __future__ import annotations

import torch

from hnanosolver_tpu_torch.core.layout import parity_flat
from hnanosolver_tpu_torch.kernels import build
from hnanosolver_tpu_torch.ops import cuda_pressure
from hnanosolver_tpu_torch.ops.shifts import neighbor_sum

_NO_B4 = ("the textbook per-colour sweep on CUDA needs kernel B4, not ported "
          "yet (ROADMAP: kernels still to port, B4)")


def _textbook(topo, div, iterations, dx, omega, p):
    dx2 = dx * dx
    red = parity_flat(topo) == 0
    for _ in range(iterations):
        for color_mask in (red, ~red):
            pgs = (neighbor_sum(topo, p) - div * dx2) * (1.0 / 6.0)
            p = torch.where(color_mask, p + omega * (pgs - p), p)
    return p


def solve_pressure(
    topo,
    div: torch.Tensor,
    iterations: int,
    dx: float,
    omega: float,
    p0: torch.Tensor | None = None,
    halo_lag: int = 1,
) -> torch.Tensor:
    """Run ``iterations`` red+black SOR pairs from p0 (zeros by default).
    div, p: [T,512]."""
    p = torch.zeros_like(div) if p0 is None else p0
    on_cpu = build.on_cpu(div.device)
    if halo_lag < 1:
        raise ValueError(f"halo_lag must be >= 1, got {halo_lag}")
    if halo_lag == 1:
        if not on_cpu:
            raise NotImplementedError(_NO_B4)
        return _textbook(topo, div, iterations, dx, omega, p)
    blocks, rem = divmod(iterations, halo_lag)
    if rem and not on_cpu:
        raise NotImplementedError(
            f"iterations {iterations} % halo_lag {halo_lag} != 0: " + _NO_B4)
    for _ in range(blocks):
        p = cuda_pressure.rbsor_lagged(topo.nbr, p, div, halo_lag, omega, dx * dx)
    return _textbook(topo, div, rem, dx, omega, p) if rem else p


def residual(topo, p: torch.Tensor, div: torch.Tensor, dx: float) -> torch.Tensor:
    """Pointwise residual r = div - L(p), L(p) = (sum nbrs - 6 p) / dx^2."""
    lap = (neighbor_sum(topo, p) - 6.0 * p) / (dx * dx)
    return div - lap
