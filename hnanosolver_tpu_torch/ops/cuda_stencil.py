"""Kernel B6: the Poisson residual (CUDA source ``csrc/residual.cu``), and
its plain PyTorch version.

Counterpart of ``hnanosolver_tpu/ops/pallas_stencil.py::residual_fused``:
r = div - (sum_6 p_nbr - 6 p) / dx^2, the six faces added left to right in
FACE_DIRS order and a true division by dx^2, bitwise equal to the plain
version. On a CPU tensor the wrapper runs the plain version; on a CUDA
tensor it launches the kernel or raises.
"""

from __future__ import annotations

import torch

from hnanosolver_tpu_torch.core.layout import TILE
from hnanosolver_tpu_torch.kernels import build
from hnanosolver_tpu_torch.ops.shifts import neighbor_sum_nbr

launches = build.LaunchCount("residual")


def residual(nbr: torch.Tensor, p: torch.Tensor, div: torch.Tensor, dx: float) -> torch.Tensor:
    """r = div - L(p) on ``p, div [T,512]``. One launch."""
    T = p.shape[0]
    build.require(p, "p", (T, TILE), torch.float32, p.device)
    build.require(div, "div", (T, TILE), torch.float32, p.device)
    build.require(nbr, "nbr", (T, 27), torch.int32, p.device)
    if build.on_cpu(p.device):
        return residual_plain(nbr, p, div, dx)
    out = torch.empty_like(p)
    with torch.cuda.device(p.device):
        code = build.library().hn_residual(
            p.data_ptr(), div.data_ptr(), nbr.data_ptr(), out.data_ptr(), T,
            float(dx) * float(dx), build.stream_ptr(p.device))
    build.check(code, "residual")
    launches.n += 1
    return out


def residual_plain(nbr: torch.Tensor, p: torch.Tensor, div: torch.Tensor,
                   dx: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`residual`. dx^2 is a tensor on p's
    device: a Python number would let PyTorch's CUDA division multiply by
    its reciprocal instead of dividing."""
    dx2 = torch.tensor(float(dx) * float(dx), dtype=torch.float32, device=p.device)
    return div - (neighbor_sum_nbr(nbr, p) - 6.0 * p) / dx2
