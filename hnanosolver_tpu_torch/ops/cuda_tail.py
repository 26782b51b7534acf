"""Kernel B2: fused BFECC tail (CUDA source ``csrc/bfecc_tail.cu``), and
its plain PyTorch version.

Counterpart of ``hnanosolver_tpu/ops/pallas_tail.py::bfecc_tail_fused``:
clip(pf + 0.5 (phi0 - pb), min/max over {phi0, its 6 faces, pf}) for F
stacked fields, bitwise equal to the plain version. On a CPU tensor the
wrapper runs the plain version; on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from hnanosolver_tpu_torch.core.layout import TILE
from hnanosolver_tpu_torch.kernels import build
from hnanosolver_tpu_torch.ops.shifts import face_views_nbr

launches = build.LaunchCount("bfecc_tail")


def bfecc_tail(nbr: torch.Tensor, phi0s: torch.Tensor, pfs: torch.Tensor,
               pbs: torch.Tensor) -> torch.Tensor:
    """The BFECC correction + limiter over ``[F,T,512]`` fields. One launch."""
    if phi0s.dim() != 3:
        raise ValueError(f"phi0s: expected [F, T, 512], got {tuple(phi0s.shape)}")
    F, T, _ = phi0s.shape
    for name, t in (("phi0s", phi0s), ("pfs", pfs), ("pbs", pbs)):
        build.require(t, name, (F, T, TILE), torch.float32, phi0s.device)
    build.require(nbr, "nbr", (T, 27), torch.int32, phi0s.device)
    if build.on_cpu(phi0s.device):
        return bfecc_tail_plain(nbr, phi0s, pfs, pbs)
    out = torch.empty_like(phi0s)
    with torch.cuda.device(phi0s.device), launches.launch():
        code = build.library().hn_bfecc_tail(
            phi0s.data_ptr(), pfs.data_ptr(), pbs.data_ptr(), nbr.data_ptr(),
            out.data_ptr(), F, T, build.stream_ptr(phi0s.device))
        build.check(code, "bfecc_tail")
    return out


def bfecc_tail_plain(nbr: torch.Tensor, phi0s: torch.Tensor, pfs: torch.Tensor,
                     pbs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`bfecc_tail`."""
    views = face_views_nbr(nbr, phi0s)  # [6,F,T,512]
    lo = torch.minimum(torch.minimum(phi0s, pfs), views.amin(0))
    hi = torch.maximum(torch.maximum(phi0s, pfs), views.amax(0))
    corr = pfs + 0.5 * (phi0s - pbs)
    return torch.clamp(corr, lo, hi)
