"""The red-black SOR kernels and their plain PyTorch versions:

- B3 ``rbsor_lagged`` (``csrc/rbsor_lagged.cu``): ``pairs`` red+black pairs
  per launch with the cross-tile halo lagged; counterpart of
  ``hnanosolver_tpu/ops/pallas_pressure.py::solve_pressure_lagged`` (one
  call here is one grid launch there).
- B4 ``rbsor_color`` (``csrc/rbsor_color.cu``): one colour half-sweep with
  a fresh halo, in place; counterpart of ``solve_pressure_pallas``'s
  per-colour launch.
- B5 ``rbsor_fused`` (``csrc/rbsor_fused.cu``): the whole textbook solve
  in one launch, for T <= ``MAX_FUSED_ROWS``; counterpart of
  ``solve_pressure_fused``.

Each takes an optional in-domain ``mask [T,512]`` (multigrid coarse
levels): voxels where it is not > 0 never update. On a CPU tensor a
wrapper runs its plain version; on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from hnanosolver_tpu_torch.core.layout import TILE, col_coords
from hnanosolver_tpu_torch.kernels import build
from hnanosolver_tpu_torch.ops.shifts import (
    FACE_DIRS, _DIRS, _boundary_mask, d_of, neighbor_sum_nbr)

# Largest T solved by B5 (the JAX package's value): above it the solve
# runs as B3 blocks or B4 sweeps. Read at call time by ops/pressure.py.
MAX_FUSED_ROWS = 2_048
_COOPERATIVE_LAUNCH_TOO_LARGE = 82  # cudaErrorCooperativeLaunchTooLarge

launches_lagged = build.LaunchCount("rbsor_lagged")
launches_color = build.LaunchCount("rbsor_color")
launches_fused = build.LaunchCount("rbsor_fused")


def _check(nbr, p, div, mask):
    T = p.shape[0]
    build.require(p, "p", (T, TILE), torch.float32, p.device)
    build.require(div, "div", (T, TILE), torch.float32, p.device)
    build.require(nbr, "nbr", (T, 27), torch.int32, p.device)
    if mask is not None:
        build.require(mask, "mask", (T, TILE), torch.float32, p.device)
    return T


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _update_mask(color: int, mask, dev) -> torch.Tensor:
    """Voxels a half-sweep of ``color`` updates (tile origins are multiples
    of 8, so the in-tile coordinates give the global parity)."""
    cx, cy, cz = col_coords(dev)
    upd = ((cx + cy + cz) & 1) == color
    return upd if mask is None else upd & (mask > 0)


# -- B3 ----------------------------------------------------------------------

def rbsor_lagged(nbr: torch.Tensor, p: torch.Tensor, div: torch.Tensor,
                 pairs: int, omega: float, dx2: float,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """``pairs`` red+black SOR pairs on ``p [T,512]`` with the cross-tile
    halo taken once, from the input ``p``. Voxels outside ``mask`` keep
    their value (the caller zeroes them once, before the first block).
    Returns a new tensor."""
    T = _check(nbr, p, div, mask)
    if pairs < 1:
        raise ValueError(f"pairs must be >= 1, got {pairs}")
    if build.on_cpu(p.device):
        return rbsor_lagged_plain(nbr, p, div, pairs, omega, dx2, mask)
    out = torch.empty_like(p)
    with torch.cuda.device(p.device):
        code = build.library().hn_rbsor_lagged(
            p.data_ptr(), div.data_ptr(), nbr.data_ptr(), _ptr(mask), out.data_ptr(),
            T, int(pairs), float(omega), float(dx2), build.stream_ptr(p.device))
    build.check(code, "rbsor_lagged")
    launches_lagged.n += 1
    return out


def rbsor_lagged_plain(nbr: torch.Tensor, p: torch.Tensor, div: torch.Tensor,
                       pairs: int, omega: float, dx2: float,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`rbsor_lagged` (same op order)."""
    dev = p.device
    masks = [_boundary_mask(off, dev) for off in FACE_DIRS]
    fixes = [torch.roll(p.index_select(0, nbr[:, d_of(off)]), _DIRS[off][3], -1)
             for off in FACE_DIRS]
    upd = [_update_mask(color, mask, dev) for color in (0, 1)]
    rhs = div * dx2
    for _ in range(pairs):
        for color in (0, 1):
            v = [torch.where(m, fix, torch.roll(p, _DIRS[off][2], -1))
                 for off, m, fix in zip(FACE_DIRS, masks, fixes)]
            pgs = (v[0] + v[1] + v[2] + v[3] + v[4] + v[5] - rhs) * (1.0 / 6.0)
            p = torch.where(upd[color], p + omega * (pgs - p), p)
    return p


# -- B4 ----------------------------------------------------------------------

def rbsor_color(nbr: torch.Tensor, p: torch.Tensor, div: torch.Tensor, color: int,
                omega: float, dx2: float,
                mask: torch.Tensor | None = None) -> torch.Tensor:
    """One half-sweep of ``color`` (0 red, 1 black) with every face value
    read from the current ``p``. Updates ``p`` IN PLACE and returns it:
    a colour reads only the other colour, so in place is exact."""
    T = _check(nbr, p, div, mask)
    if color not in (0, 1):
        raise ValueError(f"color must be 0 or 1, got {color}")
    if build.on_cpu(p.device):
        return p.copy_(rbsor_color_plain(nbr, p, div, color, omega, dx2, mask))
    with torch.cuda.device(p.device):
        code = build.library().hn_rbsor_color(
            p.data_ptr(), div.data_ptr(), nbr.data_ptr(), _ptr(mask), T, int(color),
            float(omega), float(dx2), build.stream_ptr(p.device))
    build.check(code, "rbsor_color")
    launches_color.n += 1
    return p


def rbsor_color_plain(nbr: torch.Tensor, p: torch.Tensor, div: torch.Tensor, color: int,
                      omega: float, dx2: float,
                      mask: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`rbsor_color`; returns a new tensor."""
    pgs = (neighbor_sum_nbr(nbr, p) - div * dx2) * (1.0 / 6.0)
    return torch.where(_update_mask(color, mask, p.device), p + omega * (pgs - p), p)


# -- B5 ----------------------------------------------------------------------

def rbsor_fused(nbr: torch.Tensor, div: torch.Tensor, iterations: int, omega: float,
                dx2: float, p0: torch.Tensor | None = None,
                mask: torch.Tensor | None = None) -> torch.Tensor:
    """``iterations`` textbook red+black pairs from ``p0`` (zeros by
    default; voxels outside ``mask`` start at 0 and stay there) in one
    launch. Returns a new tensor."""
    p0 = torch.zeros_like(div) if p0 is None else p0
    T = _check(nbr, p0, div, mask)
    if iterations < 0:
        raise ValueError(f"iterations must be >= 0, got {iterations}")
    if build.on_cpu(div.device):
        return rbsor_fused_plain(nbr, div, iterations, omega, dx2, p0, mask)
    out = torch.empty_like(div)
    with torch.cuda.device(div.device):
        code = build.library().hn_rbsor_fused(
            p0.data_ptr(), div.data_ptr(), nbr.data_ptr(), _ptr(mask), out.data_ptr(),
            T, int(iterations), float(omega), float(dx2), build.stream_ptr(div.device))
    if code == _COOPERATIVE_LAUNCH_TOO_LARGE:
        raise RuntimeError(f"rbsor_fused: grid of T={T} tiles not co-resident (a bug in "
                           "the grid sizing: it is capped at the occupancy limit)")
    build.check(code, "rbsor_fused")
    launches_fused.n += 1
    return out


def rbsor_fused_plain(nbr: torch.Tensor, div: torch.Tensor, iterations: int,
                      omega: float, dx2: float, p0: torch.Tensor | None = None,
                      mask: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`rbsor_fused`."""
    p = torch.zeros_like(div) if p0 is None else p0
    if mask is not None:
        p = torch.where(mask > 0, p, 0.0)
    for _ in range(iterations):
        for color in (0, 1):
            p = rbsor_color_plain(nbr, p, div, color, omega, dx2, mask)
    return p
