"""One frame of the moving collider, plain (BASELINE config 4: HNanoSolver
with a collision SDF on the SOP's input 2), in any float dtype.

- :func:`sphere_sdf`: the signed distance to a sphere translating at
  constant velocity, on the voxel lattice. It is an input of the step
  (Houdini hands a fresh SDF in every cook), computed here in float32 as
  the host would: centre = f32(center0) + f32(velocity) * (f32(index) *
  dt), then sqrt(|x - centre|^2) - radius over the integer voxel
  positions. The caller widens it to the step's dtype; at an integral
  centre it holds exact zeros on the lattice, which a float64 distance
  would keep too but whose ``< 0`` and ``< 0.1`` gates would then flip on
  the centre's rounding.
- :func:`enforce`: enforceCollisionBoundaries (``Kernel.cu:77-116``): where
  sdf < 0 the velocity is zero; where sdf < MARGIN (0.1 voxels) it is
  blended toward its tangential part v - (v.n) n with blend clamp(1 - sdf /
  blend_denom, 0, 1), n the central-difference gradient of the SDF
  normalised (0 where its length is at most 1e-6). The velocity
  advection's tail gates on 0.1 but blends with 1 - sdf / 1.5
  (TAIL_BLEND): a quirk of the solver, kept.
- :func:`bfecc`: the plume's BFECC (``ops.bfecc``) with the trace
  rejection of ``Kernel.cu:118-266``: a back trace whose end probes sdf < 0
  stays home (d = 0); a re-trace whose end probes sdf < 0 goes back to d.
- :func:`frame`: the SDF refreshed for the frame's index, the emit, then
  the plume's step (``step.solver_step``'s order) with collision at its
  four points: before the velocity's advection, the advection's tail, and
  twice after u - grad p. The scalars but the SDF are advected; the SDF
  is carried over, and every field is 0 on the null and padding rows.
"""

from __future__ import annotations

import numpy as np
import torch

from . import multigrid as mg
from . import ops, step
from .topology import Topo, emitter_tiles

FIELD = "collision_sdf"
MARGIN = 0.1  # voxels: the collision band's gate
TAIL_BLEND = 1.5  # the velocity advection's tail blends with 1 - sdf / 1.5


def center(col: dict, index: int, dt: float, device) -> torch.Tensor:
    """[3] float32: center0 + velocity * (index * dt)."""
    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    return f32([float(c) for c in col["center0"]]) + f32(
        [float(v) for v in col["velocity"]]) * (f32(float(index)) * dt)


def sphere_sdf(origins: np.ndarray, col: dict, index: int, dt: float, device) -> torch.Tensor:
    """[T, 512] float32 signed distance (voxels) of every lane of the rows
    whose tile origins are ``origins [T, 3]`` (the null and padding rows at
    their sentinel origins) to the sphere at frame ``index``."""
    org = torch.from_numpy(origins.astype(np.int64) * 8).to(device)
    cx, cy, cz = ops.lanes(device)
    px, py, pz = ((org[:, a:a + 1] + c).to(torch.float32) for a, c in enumerate((cx, cy, cz)))
    c = center(col, index, dt, device)
    d = torch.sqrt((px - c[0]) ** 2 + (py - c[1]) ** 2 + (pz - c[2]) ** 2)
    return d - float(col["radius"])


def shell_tiles(col: dict, index: int, dt: float) -> np.ndarray:
    """Tiles over the sphere at frame ``index`` and ``col["shell_tiles"]``
    tiles around it (the no-slip band resolved where the smoke has not
    reached)."""
    c = np.asarray(col["center0"], np.float64) + np.asarray(col["velocity"], np.float64) * (
        index * dt)
    return emitter_tiles(c, float(col["radius"]), int(col["shell_tiles"]))


def normal(nbr, sdf, inv_dx: float):
    """The SDF's central-difference gradient, normalised: [3, T, 512]."""
    g = torch.stack([ops.face(nbr, sdf, op) - ops.face(nbr, sdf, om) for op, om in ops.AXES])
    g = g * (0.5 * inv_dx)
    glen = torch.sqrt(g[0] * g[0] + g[1] * g[1] + g[2] * g[2])
    return torch.where(glen > 1e-6, g / torch.clamp(glen, min=1e-30), 0.0)


def enforce(vel, sdf, n, blend_denom: float = MARGIN):
    """enforceCollisionBoundaries on ``vel [3, T, 512]`` with the SDF's
    normal ``n`` (:func:`normal`)."""
    blend = torch.clamp(1.0 - sdf / blend_denom, 0.0, 1.0)
    vdotn = vel[0] * n[0] + vel[1] * n[1] + vel[2] * n[2]
    blended = vel * (1.0 - blend) + (vel - n * vdotn) * blend
    out = torch.where(sdf < MARGIN, blended, vel)
    return torch.where(sdf < 0.0, 0.0, out)


def bfecc(nbr, fields, sdf, sdt: float, f_lo: int):
    """``ops.bfecc`` with the SDF's trace rejection: the back trace d =
    clamp(-u sdt) to 0 where sdf(x + d) < 0; the re-trace d2 = clamp(d + u(x
    + d) sdt) to d where sdf(x + d2) < 0."""
    phi0 = fields[f_lo:]
    out = torch.empty_like(phi0)
    probe = sdf[None]
    for rows in ops.blocks(fields.shape[1]):
        nb = nbr[rows]
        d = torch.clamp(-fields[:3, rows] * sdt, -ops.DISP_LIMIT, ops.DISP_LIMIT)
        d = torch.where(ops.sample(nb, probe, d)[0] < 0.0, 0.0, d)
        back = ops.sample(nb, fields, d)
        d2 = torch.clamp(d + back[:3] * sdt, -ops.DISP_LIMIT, ops.DISP_LIMIT)
        d2 = torch.where(ops.sample(nb, probe, d2)[0] < 0.0, d, d2)
        pf, pb = back[f_lo:], ops.sample(nb, phi0, d2)
        views = torch.stack([ops.face(nbr, phi0, off, rows) for off in ops.DIRS])
        p0 = phi0[:, rows]
        lo = torch.minimum(torch.minimum(p0, pf), views.amin(0))
        hi = torch.maximum(torch.maximum(p0, pf), views.amax(0))
        out[:, rows] = torch.clamp(pf + 0.5 * (p0 - pb), lo, hi)
    return out


def advect_scalars(nbr, vel, scalars: dict, sdf, dt: float, inv_dx: float) -> dict:
    """``ops.advect_scalars`` with the trace rejection."""
    names = sorted(scalars)
    phi = torch.stack([scalars[k] for k in names])
    outs = [bfecc(nbr, torch.cat([vel, phi[i:i + ops.MAX_SCALARS]]), sdf, dt * inv_dx, 3)
            for i in range(0, len(names), ops.MAX_SCALARS)]
    out = torch.cat(outs)
    return {k: out[i] for i, k in enumerate(names)}


def solver_step(topo: Topo, state: dict, sp: dict, levels: list) -> dict:
    """``step.solver_step`` with the collision SDF ``state[FIELD]``."""
    c = sp["combustion"]
    if int(c["factor_scale"]) != 0:
        raise NotImplementedError("vorticity confinement at an offset >= 1")
    dt, dx = sp["dt"], sp["voxel_size"]
    inv_dx = 1.0 / dx
    nbr, sdf = topo.nbr, state[FIELD]
    n = normal(nbr, sdf, inv_dx)
    vel = enforce(state["velocity"], sdf, n)
    u = enforce(bfecc(nbr, vel, sdf, dt * inv_dx, 0), sdf, n, TAIL_BLEND)
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
    del div
    vel = enforce(enforce(ops.subtract_gradient(nbr, u, p, inv_dx), sdf, n), sdf, n)
    del u, p, n
    scalars = {k: v for k, v in state.items() if k not in ("velocity", FIELD)}
    scalars.update(fuel=fuel, waste=waste, temperature=temp, flame=flame)
    out = advect_scalars(nbr, vel, scalars, sdf, dt, inv_dx)
    out[FIELD] = sdf
    m = topo.active(vel.dtype)[:, None]
    out = {k: v * m for k, v in out.items()}
    out["velocity"] = vel * m[None]
    return out


def frame(topo: Topo, state: dict, sp: dict, em: dict, col: dict, levels: list,
          index: int) -> dict:
    """Frame ``index`` of its cook: the SDF at ``index``, the emit, the step."""
    s = dict(state)
    s[FIELD] = sphere_sdf(topo.origins, col, index, sp["dt"], topo.device).to(
        state["velocity"].dtype)
    return solver_step(topo, step.emit(topo, s, em, sp["dt"]), sp, levels)
