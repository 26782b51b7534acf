"""The vorticity confinement's kernel and its plain PyTorch version
(``csrc/vorticity.cu``; no TPU kernel: XLA computed the confinement,
``hnanosolver_tpu/ops/stencil.py``):

- VC ``vorticity_confinement``: ``vel [3,T,512]`` plus scale * (N x omega)
  * dt, with omega the curl and N the normalised gradient of |omega| taken
  at voxel +- s along each axis. One launch; it writes a new tensor and
  leaves ``vel`` as it is.

The plain version is the composition ``ops/stencil.vorticity_confinement``
ran before the kernel (``stencil.curl``, :func:`curl_mag_at_offset` at the
six offsets, the normalisation and the cross product); the kernel is
bitwise equal to it on the card. On a CPU tensor the wrapper runs the plain
version; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from hnanosolver_tpu_torch.core.layout import TILE
from hnanosolver_tpu_torch.kernels import build
from hnanosolver_tpu_torch.ops.shifts import offset_view

launches = build.LaunchCount("vorticity_confinement")

# the largest |s|: |omega| at voxel + s reads voxel + s +- 1, which must lie
# in the tile's 3x3x3 neighbourhood (offset_view's [-8, 8])
MAX_OFFSET = 7


def smem_bytes(s: int) -> int:
    """A VC block's dynamic shared memory at offset ``s`` (vorticity.cu's
    VcShape): the three components of the box [-h, 8 + h)^3, h = |s| + 1,
    and |omega| on the tile and the six slabs of |s| planes beside it."""
    edge = 8 + 2 * (abs(s) + 1)
    return (3 * edge ** 3 + TILE + 6 * abs(s) * 64) * 4


def vorticity_confinement(nbr: torch.Tensor, vel: torch.Tensor, dt: float, inv_dx: float,
                          confinement_scale: float, s: int) -> torch.Tensor:
    """``vel [3,T,512]`` with the confinement force at the integer offset
    ``s`` (1 <= |s| <= 7) added, ``[3,T,512]``. One launch."""
    T = vel.shape[1] if vel.dim() == 3 else -1
    build.require(vel, "vel", (3, T, TILE), torch.float32, vel.device)
    build.require(nbr, "nbr", (T, 27), torch.int32, vel.device)
    if not 1 <= abs(int(s)) <= MAX_OFFSET:
        raise ValueError(f"offset {s}: the confinement takes 1 <= |s| <= {MAX_OFFSET}")
    if build.on_cpu(vel.device):
        return vorticity_confinement_plain(nbr, vel, dt, inv_dx, confinement_scale, s)
    # the float32 values PyTorch's CUDA ops cast the plain version's Python
    # scalars to
    f32 = [float(np.float32(x)) for x in (0.5 * inv_dx, confinement_scale, dt)]
    out = torch.empty_like(vel)
    with torch.cuda.device(vel.device), launches.launch():
        code = build.library().hn_vorticity_confinement(
            vel.data_ptr(), nbr.data_ptr(), out.data_ptr(), T, int(s), *f32,
            build.stream_ptr(vel.device))
        build.check(code, "vorticity_confinement")
    return out


def vorticity_confinement_plain(nbr: torch.Tensor, vel: torch.Tensor, dt: float, inv_dx: float,
                                confinement_scale: float, s: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`vorticity_confinement`."""
    from hnanosolver_tpu_torch.ops import stencil  # it imports this module

    topo = SimpleNamespace(nbr=nbr)
    factor = 0.5 * inv_dx
    omega = stencil.curl(topo, vel, factor)

    def grad(axis):
        p, m = [0, 0, 0], [0, 0, 0]
        p[axis], m[axis] = s, -s
        return (curl_mag_at_offset(topo, vel, p, factor)
                - curl_mag_at_offset(topo, vel, m, factor)) * factor

    g = torch.stack([grad(0), grad(1), grad(2)])
    glen = torch.sqrt(torch.sum(g * g, dim=0, keepdim=True)) + 1e-5
    N = g / glen
    force = torch.stack([
        N[1] * omega[2] - N[2] * omega[1],
        N[2] * omega[0] - N[0] * omega[2],
        N[0] * omega[1] - N[1] * omega[0],
    ])
    return vel + confinement_scale * force * dt


def curl_mag_at_offset(topo, vel: torch.Tensor, off, factor: float) -> torch.Tensor:
    """|curl u| evaluated at voxel + off (nonzero just outside the active
    set, as the reference's pointwise recomputation is)."""
    def v(c, o):
        return offset_view(topo, vel[c], (off[0] + o[0], off[1] + o[1], off[2] + o[2]))

    wx = ((v(2, (0, 1, 0)) - v(2, (0, -1, 0))) - (v(1, (0, 0, 1)) - v(1, (0, 0, -1)))) * factor
    wy = ((v(0, (0, 0, 1)) - v(0, (0, 0, -1))) - (v(2, (1, 0, 0)) - v(2, (-1, 0, 0)))) * factor
    wz = ((v(1, (1, 0, 0)) - v(1, (-1, 0, 0))) - (v(0, (0, 1, 0)) - v(0, (0, -1, 0)))) * factor
    return torch.sqrt(wx * wx + wy * wy + wz * wz)
