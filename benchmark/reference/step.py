"""One frame of the rising plume, plain: the emitter, the solver step and,
in a growing cook, the activation pass that follows the smoke.

A state is a dict of tensors of one dtype: ``velocity [3, T, 512]`` and
one ``[T, 512]`` field a scalar. The step's order is HNanoSolver's:

  1. emit: inside the emitter sphere add density and fuel, raise the
     temperature to its target and set the upward jet;
  2. BFECC self-advection of the velocity;
  3. divergence; combustion (which adds its expansion to the divergence);
     buoyancy from the burnt temperature;
  4. the pressure solve: red-black SOR (lagged halo every ``halo_lag``
     pairs) or multigrid;
  5. u - grad p; BFECC advection of every scalar by the projected velocity;
  6. the null and padding rows set to 0.

Vorticity confinement enters only at an integer confinement offset of 1 or
more; the configurations here state 0.5, which truncates to 0, so it is no
part of their step.
"""

from __future__ import annotations

import numpy as np
import torch

from . import multigrid as mg
from . import ops
from .topology import Topo, build, emitter_tiles, round_capacity, pack


def positions(topo: Topo, dtype):
    """World voxel coordinates of every lane, three [T, 512] tensors."""
    org = torch.from_numpy(topo.origins.astype(np.int64) * 8).to(topo.device)
    cx, cy, cz = ops.lanes(topo.device)
    return tuple((org[:, a:a + 1] + c).to(dtype) for a, c in enumerate((cx, cy, cz)))


def emit(topo: Topo, state: dict, em: dict, dt: float) -> dict:
    dtype = state["velocity"].dtype
    px, py, pz = positions(topo, dtype)
    c = em["center"]
    d2 = (px - c[0]) ** 2 + (py - c[1]) ** 2 + (pz - c[2]) ** 2
    inside = (d2 < em["radius"] ** 2).to(dtype) * topo.active(dtype)[:, None]
    hot = inside > 0
    s = dict(state)
    s["density"] = s["density"] + inside * (em["density_rate"] * dt)
    s["fuel"] = torch.clamp(s["fuel"] + inside * (em["fuel_rate"] * dt), max=1.0)
    s["temperature"] = torch.where(hot, torch.clamp(s["temperature"], min=em["temperature_target"]),
                                   s["temperature"])
    vel = state["velocity"].clone()
    vel[1] = torch.where(hot, torch.full_like(vel[1], em["velocity_jet"]), state["velocity"][1])
    s["velocity"] = vel
    return s


def solver_step(topo: Topo, state: dict, sp: dict, levels: list) -> dict:
    """Steps 2-6 above. ``sp``: the configuration's solver settings with the
    traffic's pressure settings; ``levels``: the multigrid hierarchy."""
    c = sp["combustion"]
    if int(c["factor_scale"]) != 0:
        raise NotImplementedError("vorticity confinement at an offset >= 1")
    dt, dx = sp["dt"], sp["voxel_size"]
    inv_dx = 1.0 / dx
    nbr = topo.nbr
    u = ops.advect_velocity(nbr, state["velocity"], dt, inv_dx)
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


def levels_for(topo: Topo, sp: dict, dtype) -> list:
    pr = sp["pressure"]
    return mg.hierarchy(topo, pr["levels"], dtype) if pr["solver"] == "mg" else []


def frame(topo: Topo, state: dict, sp: dict, em: dict, levels: list) -> dict:
    return solver_step(topo, emit(topo, state, em, sp["dt"]), sp, levels)


def occupancy(topo: Topo, state: dict):
    """[T] the largest |value| of a tile over the velocity and the scalars."""
    occ = state["velocity"].abs().amax(dim=(0, 2))
    for k, v in state.items():
        if k != "velocity":
            occ = torch.maximum(occ, v.abs().amax(dim=1))
    return occ * topo.active(occ.dtype)


def grown_tiles(topo: Topo, occ: np.ndarray, threshold: float, em: dict) -> np.ndarray:
    """The tiles of the next topology: every active tile whose occupancy
    exceeds ``threshold`` and the emitter's tiles, dilated by the
    configuration's tile radius."""
    hot = topo.origins[np.nonzero(occ > threshold)[0]]
    tiles = np.concatenate([hot, emitter_tiles(em["center"], em["radius"], 1)])
    r = np.arange(-em["dilate_radius"], em["dilate_radius"] + 1)
    offs = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1).reshape(-1, 3).astype(np.int32)
    return (tiles[:, None, :] + offs[None]).reshape(-1, 3)


def grown_capacity(old_capacity: int, n: int) -> int:
    """Capacity never shrinks; it grows by :func:`round_capacity`."""
    return old_capacity if old_capacity >= n + 1 else max(old_capacity, round_capacity(n))


def grow(topo: Topo, state: dict, em: dict):
    """The activation pass: (topo, state) on the grown tile set, every
    field carried over by tile key (new tiles 0); the same objects when
    neither the tiles nor the capacity change."""
    occ = occupancy(topo, state).double().cpu().numpy()
    tiles = grown_tiles(topo, occ, em["occupancy_threshold"], em)
    n = len(np.unique(pack(tiles)))
    new = build(tiles, grown_capacity(topo.capacity, n), topo.device)
    if new.capacity == topo.capacity and np.array_equal(new.keys, topo.keys):
        return topo, state
    return new, remap(topo, new, state)


def remap(old: Topo, new: Topo, state: dict) -> dict:
    pos = np.minimum(np.searchsorted(old.keys[1:old.n_active + 1], new.keys), old.n_active - 1)
    found = old.keys[1:old.n_active + 1][pos] == new.keys
    rows = np.where(found, pos + 1, 0)
    rows[0] = 0
    rows[new.n_active + 1:] = 0
    r = torch.from_numpy(rows).to(new.device)
    return {k: v.index_select(-2, r) for k, v in state.items()}
