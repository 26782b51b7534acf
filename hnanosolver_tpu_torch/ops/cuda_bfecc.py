"""Kernel B1: fused BFECC sampling (CUDA source ``csrc/bfecc_sample.cu``),
and its plain PyTorch version.

Counterpart of ``hnanosolver_tpu/ops/pallas_bfecc.py::bfecc_sample_fused``
at trace order 1, with or without a collision SDF, except that the
back-trace displacement d = clamp(-u*sdt) is computed here from the
velocity rows of ``fields``. On a CPU tensor the wrapper runs the plain
version; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from hnanosolver_tpu_torch.core.layout import TILE
from hnanosolver_tpu_torch.kernels import build
from hnanosolver_tpu_torch.ops.cuda_sample import sample_at_plain

DISP_LIMIT = 7.0 - 1e-3  # max |displacement| per axis per trace (voxels)
MAX_SCALARS = 8  # scalar-mode fields the kernel is instantiated for

launches = build.LaunchCount("bfecc_sample")


def _check(nbr, fields, f_lo, sdf):
    if fields.dim() != 3:
        raise ValueError(f"fields: expected [nb, T, 512], got {tuple(fields.shape)}")
    nb, T, _ = fields.shape
    build.require(fields, "fields", (nb, T, TILE), torch.float32, fields.device)
    build.require(nbr, "nbr", (T, 27), torch.int32, fields.device)
    if sdf is not None:
        build.require(sdf, "sdf", (T, TILE), torch.float32, fields.device)
    if not ((f_lo == 0 and nb == 3) or (f_lo == 3 and 4 <= nb <= 3 + MAX_SCALARS)):
        raise ValueError(
            f"unsupported (nb={nb}, f_lo={f_lo}): velocity mode is (3, 0), "
            f"scalar mode f_lo=3 with 1..{MAX_SCALARS} scalars")


def bfecc_sample(nbr: torch.Tensor, fields: torch.Tensor, sdt: float, f_lo: int,
                 sdf: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """BFECC back and forward samples of ``fields [nb,T,512]`` (rows 0..2 =
    velocity): returns (phiF, phiB), each ``[nb-f_lo, T, 512]`` over
    fields[f_lo:]. With ``sdf [T,512]``, traces whose end point probes
    sdf < 0 are rejected (back trace to d = 0, re-trace to d). One launch."""
    _check(nbr, fields, f_lo, sdf)
    if build.on_cpu(fields.device):
        return bfecc_sample_plain(nbr, fields, sdt, f_lo, sdf)
    nb, T, _ = fields.shape
    out = torch.empty((2, nb - f_lo, T, TILE), dtype=torch.float32,
                      device=fields.device)
    with torch.cuda.device(fields.device):
        code = build.library().hn_bfecc_sample(
            fields.data_ptr(), None if sdf is None else sdf.data_ptr(), nbr.data_ptr(),
            out.data_ptr(), T, nb, f_lo, float(sdt), DISP_LIMIT,
            build.stream_ptr(fields.device))
    build.check(code, "bfecc_sample")
    launches.n += 1
    return out[0], out[1]


def bfecc_sample_plain(nbr: torch.Tensor, fields: torch.Tensor, sdt: float, f_lo: int,
                       sdf: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`bfecc_sample` (same op order)."""
    d = torch.clamp(-fields[:3] * sdt, -DISP_LIMIT, DISP_LIMIT)
    if sdf is not None:
        d = torch.where(sample_at_plain(nbr, sdf[None], d)[0] < 0.0, 0.0, d)
    back = sample_at_plain(nbr, fields, d)
    d2 = torch.clamp(d + back[:3] * sdt, -DISP_LIMIT, DISP_LIMIT)
    if sdf is not None:
        d2 = torch.where(sample_at_plain(nbr, sdf[None], d2)[0] < 0.0, d, d2)
    return back[f_lo:], sample_at_plain(nbr, fields[f_lo:], d2)
