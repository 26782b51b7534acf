"""Full-solver cook on user VDB data — the HNanoSolver SOP node's
file-level contract
(`reference/src/SOP/HNanoSolver/SOP_HNanoSolver.cpp:105-199`), as the
JAX package's ``models/solve.py`` defines it:

  input 0 (feedback): the simulation state — every float grid becomes an
      advected scalar field, the first Vec3 grid is the velocity;
  input 1 (source, optional): composited additively into the feedback
      (``openvdb::tools::compSum``, :161-181) every frame;
  input 2 (collision, optional): the first float grid is the solid SDF
      (:124-145 — missing/invalid SDF degrades to a warning);

  domain topology = velocity topology dilated by ``padding`` voxels
      (box connectivity, :188-199) union the source and collision
      topologies, at a capacity of whole 512-row chunks; re-derived every
      frame by the activation pass (``core/activation.expand_for_state``).

The JAX package's documented deviations from the reference cook are kept:
- source grids pair with feedback fields BY NAME (the reference pairs by
  load order); a source field with no feedback counterpart creates it.
- missing combustion fields (fuel/waste/temperature/flame) are created as
  zeros with a warning unless ``strict=True``, where they raise like the
  reference (HNanoSolver.cu:193-201).
- Vec3 grids beyond the first are passed through to the output unchanged.
- the collision SDF is re-scattered from the input file after every
  topology change (it is a cook input, not an advected field) and is NOT
  zeroed on output (the reference zeroes it, HNanoSolver.cu:364-369, a bug).

The VDB grids stay numpy on the host; ``scatter_scalar`` / ``scatter_vec``
move a grid's leaves to the topology's device and place them there.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from hnanosolver_tpu_torch.config import SolverParams
from hnanosolver_tpu_torch.core import coords as C
from hnanosolver_tpu_torch.core.activation import expand_for_state, tiles_covering_boxes
from hnanosolver_tpu_torch.core.layout import TILE
from hnanosolver_tpu_torch.core.topology import Topology, build_topology, lookup_tiles
from hnanosolver_tpu_torch.fields import (
    COLLISION_FIELD, COMBUSTION_FIELDS, FieldState, source_into)
from hnanosolver_tpu_torch.ops.advection import cfl_clamped_count
from hnanosolver_tpu_torch.ops.multigrid import hierarchy_for
from hnanosolver_tpu_torch.solver import step
from hnanosolver_tpu_torch.utils.profiling import frame, span


@dataclasses.dataclass
class SolveInputs:
    """Parsed VDB inputs for one solve run (see module docstring)."""

    voxel_size: float
    scalars: Dict[str, dict]  # feedback float grids (raw read_vdb dicts)
    velocity: Optional[dict]  # primary Vec3 grid (None when resuming .npz)
    extra_vecs: List[dict]  # passthrough Vec3 grids beyond the first
    source_scalars: Dict[str, dict]
    source_velocity: Optional[dict]
    sdf: Optional[dict]

    @property
    def has_source(self) -> bool:
        return bool(self.source_scalars) or self.source_velocity is not None


def load_inputs(
    feedback_path: Optional[str],
    source_path: Optional[str] = None,
    collision_path: Optional[str] = None,
    warn=print,
) -> SolveInputs:
    """Read the three SOP inputs. ``feedback_path=None`` supports resuming
    from an .npz checkpoint (state comes from the caller instead)."""
    from hnanosolver_tpu_torch.io.vdb import read_vdb

    scalars: Dict[str, dict] = {}
    velocity = None
    extra: List[dict] = []
    if feedback_path:
        fb = read_vdb(feedback_path)
        scalars = {g["name"]: g for g in fb if g["values"].ndim == 2}
        vecs = [g for g in fb if g["values"].ndim == 3]
        if not vecs:
            raise ValueError(f"{feedback_path}: feedback input has no Vec3 (velocity) grid")
        velocity, extra = vecs[0], vecs[1:]
    src_scal: Dict[str, dict] = {}
    src_vel = None
    if source_path:
        sg = read_vdb(source_path)
        src_scal = {g["name"]: g for g in sg if g["values"].ndim == 2}
        svecs = [g for g in sg if g["values"].ndim == 3]
        src_vel = svecs[0] if svecs else None
    sdf = None
    if collision_path:
        sdf = next((g for g in read_vdb(collision_path) if g["values"].ndim == 2), None)
        if sdf is None:
            # reference degrades to a warning (SOP_HNanoSolver.cpp:138-143)
            warn("collision input has no float SDF grid — continuing without")
    vs = float(velocity["voxel_size"]) if velocity else (
        float(sdf["voxel_size"]) if sdf else 0.5)
    return SolveInputs(
        voxel_size=vs, scalars=scalars, velocity=velocity, extra_vecs=extra,
        source_scalars=src_scal, source_velocity=src_vel, sdf=sdf,
    )


# ---------------------------------------------------------------------------
# scatter: (origins, values) leaf lists -> capacity-padded [T,512] tensors
# ---------------------------------------------------------------------------


def _placed(topo: Topology, origins: np.ndarray):
    """(rows, ok): each leaf's topology row on the device and whether the
    leaf lies in the domain."""
    rows = lookup_tiles(topo, np.asarray(origins).reshape(-1, 3) // C.LEAF)
    return rows, rows > 0


def scatter_scalar(topo: Topology, origins, values, fill: float = 0.0) -> torch.Tensor:
    """Scatter leaf values into the table layout on the topology's device;
    active rows the grid does not cover read ``fill`` (0 for simulated
    fields, the grid background for an SDF — outside-positive so uncovered
    space is fluid), the null and padding rows 0. Leaves outside the domain
    are dropped, like the reference's build over the domain grid."""
    out = torch.full((topo.capacity, TILE), float(np.float32(fill)), dtype=torch.float32,
                     device=topo.device)
    out[0] = 0.0
    out[topo.n_active + 1:] = 0.0
    if len(origins):
        rows, ok = _placed(topo, origins)
        vals = torch.from_numpy(np.asarray(values, np.float32)).to(topo.device)
        out[rows[ok]] = vals[ok]
    return out


def scatter_vec(topo: Topology, origins, values) -> torch.Tensor:
    """[3,N,512] leaf values -> [3,T,512] on the topology's device, zero
    where the grid has no leaf."""
    out = torch.zeros((3, topo.capacity, TILE), dtype=torch.float32, device=topo.device)
    if len(origins):
        rows, ok = _placed(topo, origins)
        vals = torch.from_numpy(np.asarray(values, np.float32)).to(topo.device)
        out[:, rows[ok]] = vals[:, ok]
    return out


def _sdf_fill(sdf_grid: dict) -> float:
    """Uncovered-space SDF value: the grid background (narrow-band SDFs
    store +band outside). A non-positive background would mark all
    uncovered space as solid/surface — fall back to a far-outside value."""
    bg = float(np.asarray(sdf_grid.get("background", 0.0)).ravel()[0])
    return bg if bg > 0 else 1e3


def _leaf_voxel_bboxes(origins: np.ndarray, masks):
    """Per-leaf active-voxel bbox in world voxel coords (from the leaf
    value masks when the reader preserved them, else the full leaf)."""
    n = len(origins)
    if masks is None or len(masks) != n or not n:
        occ = np.ones(n, bool)
        lo = np.zeros((n, 3), np.int64)
        hi = np.full((n, 3), C.LEAF - 1, np.int64)
    else:
        m = np.asarray(masks).reshape(n, C.LEAF, C.LEAF, C.LEAF)
        occ = m.any(axis=(1, 2, 3))
        lo_l, hi_l = [], []
        for other in ((2, 3), (1, 3), (1, 2)):
            proj = m.any(axis=other)
            lo_l.append(proj.argmax(1))
            hi_l.append(C.LEAF - 1 - proj[:, ::-1].argmax(1))
        lo = np.stack(lo_l, -1)
        hi = np.stack(hi_l, -1)
    return occ, np.asarray(origins) + lo, np.asarray(origins) + hi


def _input_grids(inp: SolveInputs) -> list:
    """The source grids and the SDF: their tiles join the domain."""
    return (list(inp.source_scalars.values())
            + ([inp.source_velocity] if inp.source_velocity is not None else [])
            + ([inp.sdf] if inp.sdf is not None else []))


def domain_topology(inp: SolveInputs, padding: int, min_capacity: Optional[int] = None,
                    device: torch.device | str | None = None) -> Topology:
    """The cook's domain (SOP_HNanoSolver.cpp:188-199) on ``device``
    (default: the CUDA card): velocity topology dilated by ``padding``
    voxels, union collision topology. Source tiles are unioned too so
    frame-1 sourcing lands in-domain. The capacity is the active tiles and
    the null row rounded up to whole 512-row chunks, not
    ``topology._round_capacity``."""
    occ, wmin, wmax = _leaf_voxel_bboxes(inp.velocity["origins"], inp.velocity.get("leaf_masks"))
    parts = [tiles_covering_boxes(wmin[occ], wmax[occ], padding)]
    parts += [np.asarray(g["origins"]) // C.LEAF for g in _input_grids(inp) if len(g["origins"])]
    tiles = np.concatenate(parts).astype(np.int32)
    n = len(np.unique(C.pack_keys_np(tiles)))
    cap = ((n + 1 + 511) // 512) * 512
    return build_topology(tiles, capacity=max(cap, min_capacity or 0), device=device)


def _sdf_field(topo: Topology, inp: SolveInputs) -> torch.Tensor:
    return scatter_scalar(topo, inp.sdf["origins"], inp.sdf["values"], fill=_sdf_fill(inp.sdf))


def initial_state(topo: Topology, inp: SolveInputs, strict: bool = False,
                  warn=print) -> FieldState:
    zeros = lambda: torch.zeros((topo.capacity, TILE), dtype=torch.float32,  # noqa: E731
                                device=topo.device)
    scalars = {name: scatter_scalar(topo, g["origins"], g["values"])
               for name, g in inp.scalars.items()}
    # fields only the source has: created as zeros so the field set is
    # stable across frames
    for name in inp.source_scalars:
        if name not in scalars:
            scalars[name] = zeros()
    missing = [f for f in COMBUSTION_FIELDS if f not in scalars]
    if missing:
        if strict:
            # the reference contract (HNanoSolver.cu:193-201)
            raise ValueError(f"missing required combustion fields: {missing}")
        warn(f"adding zero combustion fields: {missing}")
        for f in missing:
            scalars[f] = zeros()
    if inp.sdf is not None:
        scalars[COLLISION_FIELD] = _sdf_field(topo, inp)
    vel = scatter_vec(topo, inp.velocity["origins"], inp.velocity["values"])
    return FieldState(velocity=vel, scalars=scalars)


def _source_state(topo: Topology, inp: SolveInputs) -> FieldState:
    """Source fields scattered onto the CURRENT topology (host grids, placed
    on the device every frame)."""
    scalars = {name: scatter_scalar(topo, g["origins"], g["values"])
               for name, g in inp.source_scalars.items()}
    vel = (scatter_vec(topo, inp.source_velocity["origins"], inp.source_velocity["values"])
           if inp.source_velocity is not None
           else torch.zeros((3, topo.capacity, TILE), dtype=torch.float32, device=topo.device))
    return FieldState(velocity=vel, scalars=scalars)


def _keep_tiles(inp: SolveInputs) -> Optional[np.ndarray]:
    """Tiles that must stay active across re-activation: the sourcing
    region (emitters) and the collision band."""
    parts = [np.asarray(g["origins"]) // C.LEAF for g in _input_grids(inp) if len(g["origins"])]
    if not parts:
        return None
    return np.concatenate(parts).astype(np.int32)


def run_solve(
    inp: SolveInputs,
    params: SolverParams,
    frames: int,
    padding: Optional[int] = None,
    topo: Optional[Topology] = None,
    state: Optional[FieldState] = None,
    strict: bool = False,
    threshold: float = 1e-4,
    on_frame=None,
    interrupter=None,
    warn=print,
    cfl_guard: bool = True,
    device: torch.device | str | None = None,
):
    """N cooks of the full solver on user data. Returns (topo, state).

    ``topo``/``state`` resume from a checkpoint (the .npz path); otherwise
    the domain is built from ``inp`` on ``device`` (default: the CUDA card)
    exactly like the reference cook.

    Each frame: poll ``interrupter`` (stop without raising once it trips),
    composite the source, count the active voxels whose trace can hit the
    CFL clamp (``cfl_guard``; the count is warned, since there the trace
    deviates from the reference's unbounded one), step, then re-activate
    the topology around the matter, keeping the source and collision
    tiles, and re-scatter the SDF onto a changed topology. Traced
    (``utils/profiling``), the span ``solve.step`` is a frame: the device
    span ``step.emit`` (the source and the CFL count), then the step's
    phase spans; the growth pass's spans follow it."""
    if inp.sdf is not None:
        params = dataclasses.replace(params, has_collision=True)
    if topo is None or state is None:
        topo = domain_topology(inp, padding if padding is not None else 1, device=device)
        state = initial_state(topo, inp, strict=strict, warn=warn)
    elif inp.sdf is not None and COLLISION_FIELD not in state.scalars:
        state = state.with_scalar(COLLISION_FIELD, _sdf_field(topo, inp))
    if params.has_collision and state.sdf() is None:
        # resumed checkpoint without an SDF and no collision input
        params = dataclasses.replace(params, has_collision=False)
    keep = _keep_tiles(inp)
    hier = hierarchy_for(topo, params)
    for f in range(frames):
        if interrupter is not None and interrupter.was_interrupted():
            break
        with frame("solve.step"):
            with span("step.emit", device=True):
                if inp.has_source:
                    # per-cook compSum sourcing (SOP_HNanoSolver.cpp:161-181)
                    state = source_into(state, _source_state(topo, inp))
                if cfl_guard:
                    ncl = int(cfl_clamped_count(topo, state.velocity, params.dt,
                                                params.inv_voxel_size))
                    if ncl:
                        warn(f"WARNING frame {f + 1}: CFL clamp engaged on {ncl} voxels "
                             f"(|u|*dt/dx near/over 7) — traces deviate from the reference's "
                             f"unbounded backtrace; reduce dt or increase voxel size")
            state = step(topo, state, params, hier)
        prev = topo
        topo, state = expand_for_state(topo, state, threshold=threshold, keep_tiles=keep,
                                       padding=padding)
        if topo is not prev:
            with span("grow.hierarchy"):
                hier = hierarchy_for(topo, params)
            if inp.sdf is not None:
                # the SDF is a cook input: re-scatter (newly active rows
                # would otherwise read 0 = "on the solid surface")
                state = state.with_scalar(COLLISION_FIELD, _sdf_field(topo, inp))
        if on_frame is not None:
            on_frame(f, topo, state)
    return topo, state
