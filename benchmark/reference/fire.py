"""One frame of the fire, plain (BASELINE config 3: HNanoSolver's step with
the combustion fields and vorticity confinement on), in any float dtype.

- :func:`emit`: the burner, a disk on the ground plane: on the active rows,
  ``inside`` where r^2 = (x - cx)^2 + (z - cz)^2 < radius^2 and |y - cy| <
  height; fuel clamp(fuel + inside rate dt, max=1), temperature max(T,
  inside ignition) (on every voxel, as the burner's own emit writes it),
  density + inside dt, and a swirl about the disk's axis: u_x -= inside
  swirl dz rsqrt(r^2 + 1) dt, u_z += inside swirl dx rsqrt(r^2 + 1) dt.
- :func:`confine`: vorticity confinement (``vorticityConfinement``,
  HNanoSolver ``Kernel.cu:970-1025``): omega = curl u by central
  differences with factor 0.5/dx; N = grad|omega| / (|grad|omega|| +
  EPS), the gradient (factor 0.5/dx) taken between |omega| at voxel + s
  and voxel - s along each axis, s = int(factor_scale), with |omega|
  recomputed there from the velocity at that voxel's six faces, read
  through the neighbour tiles, so that it is nonzero just outside the
  active set; u += scale (N x omega) dt.
- :func:`solver_step`: ``step.solver_step``'s order with the confinement
  after the velocity's BFECC and before the divergence, at any s; at s = 0
  the force vanishes and the step is the plume's.
- :func:`frame`: the burner's emit, then the step.

Departures from the program: none in what is computed. The offset reads
are written here from the tile layout (one read a lane through the
neighbour table's column for voxel + offset), not from the program's
shifts; the squared gradient is summed left to right, where the program
sums it with one reduction over the three components.
"""

from __future__ import annotations

import numpy as np
import torch

from . import multigrid as mg
from . import ops, step
from .topology import TILE, Topo

EPS = 1e-5  # added to |grad |omega|| before it divides (Kernel.cu's)


def emit(topo: Topo, state: dict, burner: dict, dt: float) -> dict:
    dtype = state["velocity"].dtype
    px, py, pz = step.positions(topo, dtype)
    c = burner["center"]
    dx, dz = px - c[0], pz - c[2]
    r2 = dx * dx + dz * dz
    in_disk = (r2 < burner["radius"] ** 2) & (torch.abs(py - c[1]) < burner["height"])
    inside = in_disk.to(dtype) * topo.active(dtype)[:, None]
    s = dict(state)
    s["fuel"] = torch.clamp(s["fuel"] + inside * (burner["fuel_rate"] * dt), max=1.0)
    s["temperature"] = torch.maximum(s["temperature"], inside * burner["ignition_temp"])
    s["density"] = s["density"] + inside * dt
    rinv = torch.rsqrt(r2 + 1.0)
    vel = state["velocity"].clone()
    vel[0] = vel[0] + inside * burner["swirl"] * (-dz) * rinv * dt
    vel[2] = vel[2] + inside * burner["swirl"] * dx * rinv * dt
    s["velocity"] = vel
    return s


def at(nbr, f, off):
    """``f [T, 512]`` at voxel + ``off`` (each component in [-8, 8]): a read
    a lane from the row of the tile that holds it (the null row's 0 where
    that tile is absent)."""
    cx, cy, cz = ops.lanes(f.device)
    qx, qy, qz = cx + off[0], cy + off[1], cz + off[2]
    col = ((qx + 8) >> 3) * 9 + ((qy + 8) >> 3) * 3 + ((qz + 8) >> 3)  # [512]
    lane = (qx & 7) * 64 + (qy & 7) * 8 + (qz & 7)
    idx = nbr[:, col] * TILE + lane  # [T, 512]
    return f.reshape(-1)[idx.reshape(-1)].reshape(f.shape)


def curl_magnitude_at(nbr, vel, off, factor: float):
    """|curl u| at voxel + ``off``, from the velocity at that voxel's six
    faces."""
    def v(c, o):
        return at(nbr, vel[c], tuple(a + b for a, b in zip(off, o)))

    wx = ((v(2, (0, 1, 0)) - v(2, (0, -1, 0))) - (v(1, (0, 0, 1)) - v(1, (0, 0, -1)))) * factor
    wy = ((v(0, (0, 0, 1)) - v(0, (0, 0, -1))) - (v(2, (1, 0, 0)) - v(2, (-1, 0, 0)))) * factor
    wz = ((v(1, (1, 0, 0)) - v(1, (-1, 0, 0))) - (v(0, (0, 1, 0)) - v(0, (0, -1, 0)))) * factor
    return torch.sqrt(wx * wx + wy * wy + wz * wz)


def curl(nbr, vel, factor: float):
    """omega [3, T, 512] by central differences."""
    def d(f, a):
        op, om = ops.AXES[a]
        return ops.face(nbr, f, op) - ops.face(nbr, f, om)

    ux, uy, uz = vel[0], vel[1], vel[2]
    return torch.stack([(d(uz, 1) - d(uy, 2)) * factor, (d(ux, 2) - d(uz, 0)) * factor,
                        (d(uy, 0) - d(ux, 1)) * factor])


def confine(nbr, vel, dt: float, inv_dx: float, scale: float, factor_scale: float):
    """u + scale (N x omega) dt at the offset s = int(factor_scale); ``vel``
    itself at s = 0, where every gradient is 0."""
    s = int(factor_scale)
    if s == 0:
        return vel
    factor = 0.5 * inv_dx
    omega = curl(nbr, vel, factor)
    g = []
    for a in range(3):
        p = tuple(s if i == a else 0 for i in range(3))
        m = tuple(-s if i == a else 0 for i in range(3))
        g.append((curl_magnitude_at(nbr, vel, p, factor)
                  - curl_magnitude_at(nbr, vel, m, factor)) * factor)
    glen = torch.sqrt(g[0] * g[0] + g[1] * g[1] + g[2] * g[2]) + EPS
    n = [gi / glen for gi in g]
    del g, glen
    force = torch.stack([n[1] * omega[2] - n[2] * omega[1], n[2] * omega[0] - n[0] * omega[2],
                         n[0] * omega[1] - n[1] * omega[0]])
    return vel + scale * force * dt


def solver_step(topo: Topo, state: dict, sp: dict, levels: list) -> dict:
    """``step.solver_step`` with the confinement."""
    c = sp["combustion"]
    dt, dx = sp["dt"], sp["voxel_size"]
    inv_dx = 1.0 / dx
    nbr = topo.nbr
    u = ops.advect_velocity(nbr, state["velocity"], dt, inv_dx)
    u = confine(nbr, u, dt, inv_dx, c["vorticity_scale"], c["factor_scale"])
    div = ops.divergence(nbr, u, inv_dx)
    fuel, waste, temp, flame, div = ops.combustion(
        state["fuel"], state["waste"], state["temperature"], state["flame"], div,
        c["temperature_release"], c["expansion_rate"])
    u = ops.buoyancy(u, temp, dt, c["ambient_temp"], c["buoyancy_strength"])
    pr = sp["pressure"]
    omega = 2.0 / (1.0 + np.sin(3.14159 * dx))  # the reference solver's truncated pi
    if pr["solver"] == "mg":
        p = mg.solve(topo, levels, div, pr["cycles"], dx, omega, pr["pre"], pr["post"],
                     pr["coarsest"], pr["fmg"])
    else:
        p = ops.solve_pressure(nbr, div, pr["iterations"], dx, omega, halo_lag=pr["halo_lag"])
    vel = ops.subtract_gradient(nbr, u, p, inv_dx)
    scalars = {k: v for k, v in state.items() if k != "velocity"}
    scalars.update(fuel=fuel, waste=waste, temperature=temp, flame=flame)
    out = ops.advect_scalars(nbr, vel, scalars, dt, inv_dx)
    m = topo.active(vel.dtype)[:, None]
    out = {k: v * m for k, v in out.items()}
    out["velocity"] = vel * m[None]
    return out


def frame(topo: Topo, state: dict, sp: dict, burner: dict, levels: list) -> dict:
    """The burner's emit, then the step."""
    return solver_step(topo, emit(topo, state, burner, sp["dt"]), sp, levels)
