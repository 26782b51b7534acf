"""Kernel B1: fused BFECC sampling (CUDA source ``csrc/bfecc_sample.cu``),
in its nbr form and its dual-table form, and their plain PyTorch versions.

Counterpart of ``hnanosolver_tpu/ops/pallas_bfecc.py::bfecc_sample_fused``
at trace order 1, with or without a collision SDF, except that the
back-trace displacement d = clamp(-u*sdt) is computed here from the
velocity rows. ``bfecc_sample`` reads corners through ``nbr`` and serves
every clamped displacement; ``bfecc_sample_dual`` reads them from a chunk's
dual table (``ops/tables.py``, or kernel B11) and serves the narrow window
(the JAX kernel's ``dual=True``, ``win=16``) in the modes "both", "back"
and "fwd". On a CPU tensor a wrapper runs the plain version; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from hnanosolver_tpu_torch.core.layout import TILE
from hnanosolver_tpu_torch.kernels import build
from hnanosolver_tpu_torch.ops.cuda_sample import sample_at_plain, trilinear_plain

DISP_LIMIT = 7.0 - 1e-3  # max |displacement| per axis per trace (voxels)
MAX_SCALARS = 8  # scalar-mode fields the kernel is instantiated for
# The dual table covers the tile +-4 voxels. Mode "both" re-traces to up to
# 2*CFL, so it needs max|d| < CFL_LIMIT; "back" and "fwd" sample once and
# need max|d| < CFL_MID (the JAX package's bounds, 0.1 voxel of slack).
CFL_LIMIT = 1.9
CFL_MID = 3.9

launches = build.LaunchCount("bfecc_sample")
launches_dual = build.LaunchCount("bfecc_sample_dual")


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
    with torch.cuda.device(fields.device), launches.launch():
        code = build.library().hn_bfecc_sample(
            fields.data_ptr(), None if sdf is None else sdf.data_ptr(), nbr.data_ptr(),
            out.data_ptr(), T, nb, f_lo, float(sdt), DISP_LIMIT,
            build.stream_ptr(fields.device))
        build.check(code, "bfecc_sample")
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


def _check_dual(tbl, ldual, vd, sdt, nb, f_lo, mode, has_sdf):
    """(nf, Ud) of the table; raises on shapes the kernel does not take and
    (a host check, one sync) where a corner would leave the window."""
    if mode not in ("both", "back", "fwd"):
        raise ValueError(f"mode {mode!r}: expected 'both', 'back' or 'fwd'")
    if mode != "both" and has_sdf:
        raise ValueError(f"mode {mode!r} takes no SDF (the JAX kernel's split modes neither)")
    if mode == "both" and not ((f_lo == 0 and nb == 3)
                               or (f_lo == 3 and 4 <= nb <= 3 + MAX_SCALARS)):
        raise ValueError(f"unsupported (nb={nb}, f_lo={f_lo}) in mode 'both'")
    if mode != "both" and not (0 <= f_lo < nb <= 3 + MAX_SCALARS):
        raise ValueError(f"unsupported (nb={nb}, f_lo={f_lo}) in mode {mode!r}")
    if tbl.dim() != 4 or ldual.dim() != 2:
        raise ValueError(f"tbl {tuple(tbl.shape)}, ldual {tuple(ldual.shape)}: expected "
                         "[nc, Ud*nf, 8, 64] and [T, 8]")
    nf = nb + int(has_sdf)
    nc, R = tbl.shape[:2]
    T = ldual.shape[0]
    if R % nf or T % nc:
        raise ValueError(f"tbl rows {R} not a multiple of nf={nf}, or T={T} of nc={nc}")
    build.require(tbl, "tbl", (nc, R, 8, 64), torch.float32, vd.device)
    build.require(ldual, "ldual", (T, 8), torch.int32, vd.device)
    build.require(vd, "vel" if mode != "fwd" else "d", (3, T, TILE), torch.float32, vd.device)
    # a corner outside the tile +-4 voxels would read another dual row
    lim = CFL_LIMIT if mode == "both" else CFL_MID
    dmax = vd.abs().amax()
    if mode != "fwd":  # d = clamp(-u*sdt)
        dmax = torch.clamp(dmax * sdt, max=DISP_LIMIT)
    if not float(dmax) < lim:
        raise ValueError(f"mode {mode!r}: max|d| = {float(dmax)} is not < {lim}: corners would "
                         "leave the dual table's window (the tile +-4 voxels)")
    return nf, R // nf


def bfecc_sample_dual(tbl: torch.Tensor, ldual: torch.Tensor, vd: torch.Tensor, sdt: float,
                      nb: int, f_lo: int, mode: str = "both", has_sdf: bool = False):
    """B1 on the dual table ``tbl [nc, Ud*nf, 8, 64]`` of nf = nb (+1: the
    SDF, last) fields, the first three the velocity, with ``ldual [T, 8]``
    (``topo.chunk_ldual``). ``mode``:

    - "both": ``vd`` is the velocity; returns (phiF, phiB), each
      ``[nb-f_lo, T, 512]``, as :func:`bfecc_sample` (with the SDF probes
      when ``has_sdf``); needs max|d| < CFL_LIMIT;
    - "back": ``vd`` is the velocity; returns fields[f_lo:nb] sampled at
      x + clamp(-u*sdt); needs max|d| < CFL_MID;
    - "fwd": ``vd`` is the displacement d; returns fields[f_lo:nb] at x + d;
      needs max|d| < CFL_MID.

    Raises (a host check, one sync) where the displacement leaves the
    window. One launch."""
    nf, Ud = _check_dual(tbl, ldual, vd, sdt, nb, f_lo, mode, has_sdf)
    if build.on_cpu(vd.device):
        return bfecc_sample_dual_plain(tbl, ldual, vd, sdt, nb, f_lo, mode, has_sdf)
    T = ldual.shape[0]
    C = T // tbl.shape[0]
    n = nb - f_lo
    out = torch.empty((2 * n if mode == "both" else n, T, TILE), dtype=torch.float32,
                      device=vd.device)
    with torch.cuda.device(vd.device), launches_dual.launch():
        if mode == "both":
            code = build.library().hn_bfecc_sample_dual(
                tbl.data_ptr(), ldual.data_ptr(), vd.data_ptr(), out.data_ptr(), T, C, Ud,
                nb, f_lo, int(has_sdf), float(sdt), DISP_LIMIT, build.stream_ptr(vd.device))
        else:
            code = build.library().hn_sample_dual(
                tbl.data_ptr(), ldual.data_ptr(), vd.data_ptr(), out.data_ptr(), T, C, Ud,
                nf, f_lo, n, int(mode == "back"), float(sdt), DISP_LIMIT,
                build.stream_ptr(vd.device))
        build.check(code, "bfecc_sample_dual")
    return (out[:n], out[n:]) if mode == "both" else out


def sample_dual_plain(tbl: torch.Tensor, ldual: torch.Tensor, d: torch.Tensor, lo: int,
                      n: int, nf: int) -> torch.Tensor:
    """Fields [lo, lo+n) of the dual table ``tbl`` (nf fields) at x + d,
    ``[n, T, 512]``: :func:`trilinear_plain` with each corner read from its
    dual row."""
    T = ldual.shape[0]
    Ud = tbl.shape[1] // nf
    chunk = (torch.arange(T, device=d.device) // (T // tbl.shape[0]))[:, None]
    flat = tbl.reshape(-1)
    fo = (torch.arange(n, device=d.device) * TILE)[:, None]

    def read(qx, qy, qz):
        px, py, pz = qx + 4, qy + 4, qz + 4
        j = (px >> 3) * 4 + (py >> 3) * 2 + (pz >> 3)
        row = torch.gather(ldual, 1, j.long()).long()
        base = ((chunk * Ud + row) * nf + lo) * TILE + ((px & 7) * 64 + (py & 7) * 8 + (pz & 7))
        return flat[fo + base.reshape(1, -1)].reshape(n, T, TILE)

    return trilinear_plain(d, read)


def bfecc_sample_dual_plain(tbl: torch.Tensor, ldual: torch.Tensor, vd: torch.Tensor,
                            sdt: float, nb: int, f_lo: int, mode: str = "both",
                            has_sdf: bool = False):
    """Plain PyTorch version of :func:`bfecc_sample_dual` (same op order)."""
    nf = nb + int(has_sdf)
    if mode == "fwd":
        return sample_dual_plain(tbl, ldual, vd, f_lo, nb - f_lo, nf)
    d = torch.clamp(-vd * sdt, -DISP_LIMIT, DISP_LIMIT)
    if mode == "back":
        return sample_dual_plain(tbl, ldual, d, f_lo, nb - f_lo, nf)
    if has_sdf:
        d = torch.where(sample_dual_plain(tbl, ldual, d, nb, 1, nf)[0] < 0.0, 0.0, d)
    back = sample_dual_plain(tbl, ldual, d, 0, nb, nf)
    d2 = torch.clamp(d + back[:3] * sdt, -DISP_LIMIT, DISP_LIMIT)
    if has_sdf:
        d2 = torch.where(sample_dual_plain(tbl, ldual, d2, nb, 1, nf)[0] < 0.0, d, d2)
    return back[f_lo:], sample_dual_plain(tbl, ldual, d2, f_lo, nb - f_lo, nf)
