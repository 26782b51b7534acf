"""The collision's enforce kernel and its plain PyTorch version
(``csrc/collision.cu``; no TPU kernel: XLA computed the collision,
``hnanosolver_tpu/ops/collision.py``):

- CE ``enforce_collision``: ``vel [3,T,512]`` with the SDF ``sdf [T,512]``
  applied: zero where sdf < 0, the distance-blended no-slip projection
  where 0 <= sdf < margin (blend 1 - sdf/blend_denom, the normal the
  normalised central-difference SDF gradient), unchanged elsewhere. One
  launch; it writes a new tensor and leaves ``vel`` and ``sdf`` as they are.

The plain version is ``ops/collision.py``'s composition (``sdf_normal_field``,
``no_slip``, the blend and the two gates); the kernel is bitwise equal to
it on the card. On a CPU tensor the wrapper runs the plain version; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from hnanosolver_tpu_torch.core.layout import TILE
from hnanosolver_tpu_torch.kernels import build

launches = build.LaunchCount("enforce_collision")


def enforce_collision(nbr: torch.Tensor, vel: torch.Tensor, sdf: torch.Tensor, inv_dx: float,
                      margin: float, blend_denom: float) -> torch.Tensor:
    """``vel [3,T,512]`` with the collision of ``sdf [T,512]`` enforced,
    ``[3,T,512]``. One launch."""
    T = vel.shape[1] if vel.dim() == 3 else -1
    build.require(vel, "vel", (3, T, TILE), torch.float32, vel.device)
    build.require(sdf, "sdf", (T, TILE), torch.float32, vel.device)
    build.require(nbr, "nbr", (T, 27), torch.int32, vel.device)
    if build.on_cpu(vel.device):
        return enforce_collision_plain(nbr, vel, sdf, inv_dx, margin, blend_denom)
    # what PyTorch's CUDA division by a Python number multiplies by
    inv_denom = float(np.float32(1.0) / np.float32(blend_denom))
    out = torch.empty_like(vel)
    with torch.cuda.device(vel.device), launches.launch():
        code = build.library().hn_enforce_collision(
            vel.data_ptr(), sdf.data_ptr(), nbr.data_ptr(), out.data_ptr(), T,
            float(0.5 * inv_dx), float(margin), inv_denom, build.stream_ptr(vel.device))
        build.check(code, "enforce_collision")
    return out


def enforce_collision_plain(nbr: torch.Tensor, vel: torch.Tensor, sdf: torch.Tensor,
                            inv_dx: float, margin: float, blend_denom: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`enforce_collision`."""
    from hnanosolver_tpu_torch.ops import collision  # it imports this module

    normal = collision.sdf_normal_field(SimpleNamespace(nbr=nbr), sdf, inv_dx)
    blend = torch.clamp(1.0 - sdf / blend_denom, 0.0, 1.0)[None]
    blended = vel * (1.0 - blend) + collision.no_slip(vel, normal) * blend
    out = torch.where((sdf < margin)[None], blended, vel)
    return torch.where((sdf < 0.0)[None], 0.0, out)
