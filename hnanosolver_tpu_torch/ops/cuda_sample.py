"""Kernel B8/B9: trilinear samples at per-voxel displacements (CUDA source
``csrc/sample_at.cu``), and its plain PyTorch version.

Counterpart of ``hnanosolver_tpu/ops/pallas_interp2.py::sample_tables``
(B8) and ``hnanosolver_tpu/ops/pallas_interp.py::sample_fields_pallas``
(B9): both sample F fields at x + d, one through chunk tables and one
through per-tile 27-row tables. Here corners are read through ``nbr``.
The plain version is also the trilinear of B1's plain version
(``cuda_bfecc.bfecc_sample_plain``). On a CPU tensor the wrapper runs the
plain version; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from hnanosolver_tpu_torch.core.layout import TILE, col_coords
from hnanosolver_tpu_torch.kernels import build

MAX_FIELDS = 8  # fields per launch the kernel is instantiated for

launches = build.LaunchCount("sample_at")


def sample_at(nbr: torch.Tensor, fields: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Trilinear samples of ``fields [n,T,512]`` at x + d (``d [3,T,512]``,
    clamped by the caller to ``cuda_bfecc.DISP_LIMIT`` voxels per axis):
    ``[n,T,512]``. One launch per group of ``MAX_FIELDS`` fields."""
    if fields.dim() != 3 or fields.shape[0] < 1:
        raise ValueError(f"fields: expected [n >= 1, T, 512], got {tuple(fields.shape)}")
    n, T, _ = fields.shape
    build.require(fields, "fields", (n, T, TILE), torch.float32, fields.device)
    build.require(d, "d", (3, T, TILE), torch.float32, fields.device)
    build.require(nbr, "nbr", (T, 27), torch.int32, fields.device)
    if build.on_cpu(fields.device):
        return sample_at_plain(nbr, fields, d)
    out = torch.empty_like(fields)
    for g in range(0, n, MAX_FIELDS):
        k = min(MAX_FIELDS, n - g)
        with torch.cuda.device(fields.device):
            code = build.library().hn_sample_at(
                fields[g].data_ptr(), d.data_ptr(), nbr.data_ptr(), out[g].data_ptr(), T, k,
                build.stream_ptr(fields.device))
        build.check(code, "sample_at")
        launches.n += 1
    return out


def sample_at_plain(nbr: torch.Tensor, fields: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`sample_at`: the eight corners read
    through ``nbr`` (:func:`trilinear_plain`)."""
    n, T, _ = fields.shape
    flat = fields.reshape(n, T * TILE)

    def read(qx, qy, qz):
        dsel = ((qx + 8) >> 3) * 9 + ((qy + 8) >> 3) * 3 + ((qz + 8) >> 3)
        row = torch.gather(nbr, 1, dsel.long()).long()
        idx = row * TILE + ((qx & 7) * 64 + (qy & 7) * 8 + (qz & 7))
        return flat[:, idx.reshape(-1)].reshape(n, T, TILE)

    return trilinear_plain(d, read)


def trilinear_plain(d: torch.Tensor, read) -> torch.Tensor:
    """The trilinear sample of every plain sampler at x + d: floor/frac
    weights (wx*wy)*wz, the eight corners summed in (di, dj, dk) order;
    ``read(qx, qy, qz)`` returns the fields' values ``[n, T, 512]`` at the
    corners' in-tile positions (three [T, 512] int32 tensors), as the
    kernels' Corners policies do (``csrc/trilinear.cuh``)."""
    cx, cy, cz = col_coords(d.device)
    lx = cx.to(torch.float32) + d[0]
    ly = cy.to(torch.float32) + d[1]
    lz = cz.to(torch.float32) + d[2]
    bx, by, bz = torch.floor(lx), torch.floor(ly), torch.floor(lz)
    fx, fy, fz = lx - bx, ly - by, lz - bz
    ix, iy, iz = 1.0 - fx, 1.0 - fy, 1.0 - fz
    bx, by, bz = bx.to(torch.int32), by.to(torch.int32), bz.to(torch.int32)
    acc = None
    for di in (0, 1):
        wx = fx if di else ix
        for dj in (0, 1):
            wy = fy if dj else iy
            for dk in (0, 1):
                wz = fz if dk else iz
                v = read(bx + di, by + dj, bz + dk) * (wx * wy * wz)
                acc = v if acc is None else acc + v
    return acc
