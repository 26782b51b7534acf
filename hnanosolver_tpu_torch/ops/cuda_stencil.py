"""The stencil kernels and their plain PyTorch versions:

- B6 ``residual`` (``csrc/residual.cu``): r = div - (sum_6 p_nbr - 6 p) /
  dx^2, the six faces added left to right in FACE_DIRS order and a true
  division by dx^2; counterpart of
  ``hnanosolver_tpu/ops/pallas_stencil.py::residual_fused``.
- B7a ``divergence`` (``csrc/stencil.cu``): ((ux+ - ux-) + (uy+ - uy-)) +
  (uz+ - uz-), times 0.5 * inv_dx; counterpart of ``divergence_fused``.
- B7b ``subtract_gradient`` (``csrc/stencil.cu``): vel[a] - (p+a - p-a) *
  0.5 * inv_dx; counterpart of ``subtract_gradient_fused``.

Each kernel is bitwise equal to its plain version. On a CPU tensor a
wrapper runs the plain version; on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from hnanosolver_tpu_torch.core.layout import TILE
from hnanosolver_tpu_torch.kernels import build
from hnanosolver_tpu_torch.ops.shifts import neighbor_sum_nbr, shifted_view_nbr

launches_residual = build.LaunchCount("residual")
launches_div = build.LaunchCount("divergence")
launches_subgrad = build.LaunchCount("subtract_gradient")

_AXIS_DIRS = (((1, 0, 0), (-1, 0, 0)), ((0, 1, 0), (0, -1, 0)), ((0, 0, 1), (0, 0, -1)))


# -- B6 ----------------------------------------------------------------------

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
    launches_residual.n += 1
    return out


def residual_plain(nbr: torch.Tensor, p: torch.Tensor, div: torch.Tensor,
                   dx: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`residual`. dx^2 is a tensor on p's
    device: a Python number would let PyTorch's CUDA division multiply by
    its reciprocal instead of dividing."""
    dx2 = torch.tensor(float(dx) * float(dx), dtype=torch.float32, device=p.device)
    return div - (neighbor_sum_nbr(nbr, p) - 6.0 * p) / dx2


# -- B7a, B7b ----------------------------------------------------------------

def _check_vel(nbr, vel):
    T = vel.shape[1] if vel.dim() == 3 else -1
    build.require(vel, "vel", (3, T, TILE), torch.float32, vel.device)
    build.require(nbr, "nbr", (T, 27), torch.int32, vel.device)
    return T


def divergence(nbr: torch.Tensor, vel: torch.Tensor, inv_dx: float) -> torch.Tensor:
    """div(u) of ``vel [3,T,512]`` at cell centres, ``[T,512]``. One launch."""
    T = _check_vel(nbr, vel)
    if build.on_cpu(vel.device):
        return divergence_plain(nbr, vel, inv_dx)
    out = torch.empty((T, TILE), dtype=torch.float32, device=vel.device)
    with torch.cuda.device(vel.device):
        code = build.library().hn_divergence(
            vel.data_ptr(), nbr.data_ptr(), out.data_ptr(), T, float(0.5 * inv_dx),
            build.stream_ptr(vel.device))
    build.check(code, "divergence")
    launches_div.n += 1
    return out


def divergence_plain(nbr: torch.Tensor, vel: torch.Tensor, inv_dx: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`divergence`: the three axis terms
    added left to right, then scaled."""
    acc = None
    for a, (op, om) in enumerate(_AXIS_DIRS):
        term = shifted_view_nbr(nbr, vel[a], op) - shifted_view_nbr(nbr, vel[a], om)
        acc = term if acc is None else acc + term
    return acc * (0.5 * inv_dx)


def gradient(nbr: torch.Tensor, p: torch.Tensor, inv_dx: float) -> torch.Tensor:
    """grad(p) of ``p [T,512]`` at cell centres, ``[3,T,512]`` (plain)."""
    return torch.stack([shifted_view_nbr(nbr, p, op) - shifted_view_nbr(nbr, p, om)
                        for op, om in _AXIS_DIRS]) * (0.5 * inv_dx)


def subtract_gradient(nbr: torch.Tensor, vel: torch.Tensor, p: torch.Tensor,
                      inv_dx: float) -> torch.Tensor:
    """``vel [3,T,512]`` - grad(``p [T,512]``), ``[3,T,512]``. One launch."""
    T = _check_vel(nbr, vel)
    build.require(p, "p", (T, TILE), torch.float32, vel.device)
    if build.on_cpu(vel.device):
        return subtract_gradient_plain(nbr, vel, p, inv_dx)
    out = torch.empty_like(vel)
    with torch.cuda.device(vel.device):
        code = build.library().hn_subtract_gradient(
            vel.data_ptr(), p.data_ptr(), nbr.data_ptr(), out.data_ptr(), T,
            float(0.5 * inv_dx), build.stream_ptr(vel.device))
    build.check(code, "subtract_gradient")
    launches_subgrad.n += 1
    return out


def subtract_gradient_plain(nbr: torch.Tensor, vel: torch.Tensor, p: torch.Tensor,
                            inv_dx: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`subtract_gradient`."""
    return vel - gradient(nbr, p, inv_dx)
