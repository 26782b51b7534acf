"""Kernel B1: fused BFECC sampling (CUDA source ``csrc/bfecc_sample.cu``),
and its plain PyTorch version.

Counterpart of ``hnanosolver_tpu/ops/pallas_bfecc.py::bfecc_sample_fused``
at trace order 1 without an SDF, except that the back-trace displacement
d = clamp(-u*sdt) is computed here from the velocity rows of ``fields``.
On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from hnanosolver_tpu_torch.core.layout import TILE, col_coords
from hnanosolver_tpu_torch.kernels import build

DISP_LIMIT = 7.0 - 1e-3  # max |displacement| per axis per trace (voxels)
MAX_SCALARS = 8  # scalar-mode fields the kernel is instantiated for

launches = build.LaunchCount("bfecc_sample")


def _check(nbr, fields, f_lo):
    if fields.dim() != 3:
        raise ValueError(f"fields: expected [nb, T, 512], got {tuple(fields.shape)}")
    nb, T, _ = fields.shape
    build.require(fields, "fields", (nb, T, TILE), torch.float32, fields.device)
    build.require(nbr, "nbr", (T, 27), torch.int32, fields.device)
    if not ((f_lo == 0 and nb == 3) or (f_lo == 3 and 4 <= nb <= 3 + MAX_SCALARS)):
        raise ValueError(
            f"unsupported (nb={nb}, f_lo={f_lo}): velocity mode is (3, 0), "
            f"scalar mode f_lo=3 with 1..{MAX_SCALARS} scalars")


def bfecc_sample(nbr: torch.Tensor, fields: torch.Tensor, sdt: float,
                 f_lo: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """BFECC back and forward samples of ``fields [nb,T,512]`` (rows 0..2 =
    velocity): returns (phiF, phiB), each ``[nb-f_lo, T, 512]`` over
    fields[f_lo:]. One launch."""
    _check(nbr, fields, f_lo)
    if build.on_cpu(fields.device):
        return bfecc_sample_plain(nbr, fields, sdt, f_lo)
    nb, T, _ = fields.shape
    out = torch.empty((2, nb - f_lo, T, TILE), dtype=torch.float32,
                      device=fields.device)
    with torch.cuda.device(fields.device):
        code = build.library().hn_bfecc_sample(
            fields.data_ptr(), nbr.data_ptr(), out.data_ptr(), T, nb, f_lo,
            float(sdt), DISP_LIMIT, build.stream_ptr(fields.device))
    build.check(code, "bfecc_sample")
    launches.n += 1
    return out[0], out[1]


def _trilinear(nbr: torch.Tensor, fields: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Trilinear samples of ``fields [n,T,512]`` at x + d (``d [3,T,512]``,
    |d| < 7): floor/frac weights (wx*wy)*wz, the eight corners read
    through ``nbr`` and summed in (di, dj, dk) order."""
    n, T, _ = fields.shape
    cx, cy, cz = col_coords(fields.device)
    lx = cx.to(torch.float32) + d[0]
    ly = cy.to(torch.float32) + d[1]
    lz = cz.to(torch.float32) + d[2]
    bx, by, bz = torch.floor(lx), torch.floor(ly), torch.floor(lz)
    fx, fy, fz = lx - bx, ly - by, lz - bz
    ix, iy, iz = 1.0 - fx, 1.0 - fy, 1.0 - fz
    bx, by, bz = bx.to(torch.int32), by.to(torch.int32), bz.to(torch.int32)
    flat = fields.reshape(n, T * TILE)
    acc = None
    for di in (0, 1):
        wx = fx if di else ix
        for dj in (0, 1):
            wy = fy if dj else iy
            for dk in (0, 1):
                wz = fz if dk else iz
                qx, qy, qz = bx + di, by + dj, bz + dk
                dsel = ((qx + 8) >> 3) * 9 + ((qy + 8) >> 3) * 3 + ((qz + 8) >> 3)
                row = torch.gather(nbr, 1, dsel.long()).long()
                idx = row * TILE + ((qx & 7) * 64 + (qy & 7) * 8 + (qz & 7))
                v = flat[:, idx.reshape(-1)].reshape(n, T, TILE) * (wx * wy * wz)
                acc = v if acc is None else acc + v
    return acc


def bfecc_sample_plain(nbr: torch.Tensor, fields: torch.Tensor, sdt: float,
                       f_lo: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`bfecc_sample` (same op order)."""
    d = torch.clamp(-fields[:3] * sdt, -DISP_LIMIT, DISP_LIMIT)
    back = _trilinear(nbr, fields, d)
    d2 = torch.clamp(d + back[:3] * sdt, -DISP_LIMIT, DISP_LIMIT)
    return back[f_lo:], _trilinear(nbr, fields[f_lo:], d2)
