"""Kernel B3: lagged-halo red-black SOR, ``pairs`` red+black pairs per
launch (CUDA source ``csrc/rbsor_lagged.cu``), and its plain PyTorch version.

Counterpart of ``hnanosolver_tpu/ops/pallas_pressure.py::solve_pressure_lagged``:
one call here is one grid launch there. On a CPU tensor the wrapper runs
the plain version; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from hnanosolver_tpu_torch.core.layout import TILE, col_coords
from hnanosolver_tpu_torch.kernels import build
from hnanosolver_tpu_torch.ops.shifts import FACE_DIRS, _DIRS, _boundary_mask, d_of

launches = build.LaunchCount("rbsor_lagged")


def rbsor_lagged(nbr: torch.Tensor, p: torch.Tensor, div: torch.Tensor,
                 pairs: int, omega: float, dx2: float) -> torch.Tensor:
    """``pairs`` red+black SOR pairs on ``p [T,512]`` with the cross-tile
    halo taken once, from the input ``p``. Returns a new tensor."""
    T = p.shape[0]
    build.require(p, "p", (T, TILE), torch.float32, p.device)
    build.require(div, "div", (T, TILE), torch.float32, p.device)
    build.require(nbr, "nbr", (T, 27), torch.int32, p.device)
    if pairs < 1:
        raise ValueError(f"pairs must be >= 1, got {pairs}")
    if build.on_cpu(p.device):
        return rbsor_lagged_plain(nbr, p, div, pairs, omega, dx2)
    out = torch.empty_like(p)
    with torch.cuda.device(p.device):
        code = build.library().hn_rbsor_lagged(
            p.data_ptr(), div.data_ptr(), nbr.data_ptr(), out.data_ptr(),
            T, int(pairs), float(omega), float(dx2), build.stream_ptr(p.device))
    build.check(code, "rbsor_lagged")
    launches.n += 1
    return out


def rbsor_lagged_plain(nbr: torch.Tensor, p: torch.Tensor, div: torch.Tensor,
                       pairs: int, omega: float, dx2: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`rbsor_lagged` (same op order)."""
    dev = p.device
    cx, cy, cz = col_coords(dev)
    parity = (cx + cy + cz) & 1  # tile origins are multiples of 8
    masks = [_boundary_mask(off, dev) for off in FACE_DIRS]
    fixes = [torch.roll(p.index_select(0, nbr[:, d_of(off)]), _DIRS[off][3], -1)
             for off in FACE_DIRS]
    rhs = div * dx2
    for _ in range(pairs):
        for color in (0, 1):
            v = [torch.where(m, fix, torch.roll(p, _DIRS[off][2], -1))
                 for off, m, fix in zip(FACE_DIRS, masks, fixes)]
            pgs = (v[0] + v[1] + v[2] + v[3] + v[4] + v[5] - rhs) * (1.0 / 6.0)
            p = torch.where(parity == color, p + omega * (pgs - p), p)
    return p
