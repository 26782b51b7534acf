"""The plume's emit kernel and its plain PyTorch version (``csrc/emit.cu``;
no TPU kernel: XLA computed the emit, ``hnanosolver_tpu/models/plume.py``):

- EM ``emit``: the emitter sphere's sourcing on every row of the flat
  layout. Inside the sphere, on the active rows 1..``n_active``, it adds
  ``density_step`` to density and ``fuel_step`` to fuel, raises the
  temperature to ``target`` and sets u_y to ``jet``; fuel is clamped to at
  most 1 everywhere. One launch; it writes new density, fuel, temperature
  and velocity tensors and leaves its inputs as they are.

The plain version is the composition ``models/plume.emit`` ran before the
kernel (the voxel positions, the squared distance, the row mask, the four
updates); the kernel is bitwise equal to it on the card. On a CPU tensor the
wrapper runs the plain version; on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from hnanosolver_tpu_torch.core.layout import TILE, positions_flat
from hnanosolver_tpu_torch.core.topology import active_mask
from hnanosolver_tpu_torch.kernels import build

launches = build.LaunchCount("emit")


def emit(origins: torch.Tensor, n_active: int, density: torch.Tensor, fuel: torch.Tensor,
         temperature: torch.Tensor, velocity: torch.Tensor, center, radius: float,
         density_step: float, fuel_step: float, target: float, jet: float) -> tuple:
    """(density, fuel, temperature, velocity) with the emitter sphere of
    ``center`` and ``radius`` sourced on the rows of ``origins [T,3]``: new
    ``[T,512]``, ``[T,512]``, ``[T,512]`` and ``[3,T,512]`` tensors. One
    launch."""
    T = velocity.shape[1] if velocity.dim() == 3 else -1
    dev = velocity.device
    build.require(velocity, "velocity", (3, T, TILE), torch.float32, dev)
    for name, f in (("density", density), ("fuel", fuel), ("temperature", temperature)):
        build.require(f, name, (T, TILE), torch.float32, dev)
    build.require(origins, "origins", (T, 3), torch.int32, dev)
    if build.on_cpu(dev):
        return emit_plain(origins, n_active, density, fuel, temperature, velocity, center,
                          radius, density_step, fuel_step, target, jet)
    build.require_aligned((density, fuel, temperature, velocity), "emit", 16)
    out = tuple(torch.empty_like(f) for f in (density, fuel, temperature, velocity))
    # the float32 values PyTorch's CUDA ops cast the plain version's Python
    # scalars to
    f32 = [float(np.float32(x)) for x in (*center, radius ** 2, density_step, fuel_step,
                                           target, jet)]
    with torch.cuda.device(dev), launches.launch():
        code = build.library().hn_emit(
            density.data_ptr(), fuel.data_ptr(), temperature.data_ptr(), velocity.data_ptr(),
            origins.data_ptr(), *(o.data_ptr() for o in out), T, int(n_active), *f32,
            build.stream_ptr(dev))
        build.check(code, "emit")
    return out


def emit_plain(origins: torch.Tensor, n_active: int, density: torch.Tensor,
               fuel: torch.Tensor, temperature: torch.Tensor, velocity: torch.Tensor, center,
               radius: float, density_step: float, fuel_step: float, target: float,
               jet: float) -> tuple:
    """Plain PyTorch version of :func:`emit`."""
    rows = SimpleNamespace(origins=origins, n_active=n_active, capacity=origins.shape[0],
                           device=origins.device)
    px, py, pz = (p.to(torch.float32) for p in positions_flat(rows))
    d2 = (px - center[0]) ** 2 + (py - center[1]) ** 2 + (pz - center[2]) ** 2
    inside = (d2 < radius ** 2).to(torch.float32) * active_mask(rows)[:, None]
    hot = inside > 0

    density = density + inside * density_step
    fuel = torch.clamp(fuel + inside * fuel_step, max=1.0)
    temperature = torch.where(hot, torch.clamp(temperature, min=target), temperature)
    vel = velocity.clone()
    vel[1] = torch.where(hot, jet, velocity[1])
    return density, fuel, temperature, vel
