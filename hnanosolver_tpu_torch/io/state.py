"""Checkpoint / resume: serialize (Topology, FieldState, frame metadata).

The file formats are the JAX package's (``hnanosolver_tpu/io/state.py``,
format version 2, the same keys and meta), so a checkpoint written by
either package loads in the other:

- ``save_npz`` / ``load_npz``: one self-contained file, the topology tables
  plus every field plus the params; loads are bit-exact, so a resumed run
  continues deterministically.
- ``save_sparse_npz`` / ``load_sparse_npz``: coordinate-list interchange
  (coords + per-field values of ACTIVE voxels only) through the native tile
  builder (``io/native.py``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

import numpy as np

from hnanosolver_tpu_torch.config import CombustionParams, SolverParams
from hnanosolver_tpu_torch.convert import state_from_numpy, topology_from_numpy
from hnanosolver_tpu_torch.core.topology import Topology, build_topology
from hnanosolver_tpu_torch.fields import FieldState

_FORMAT_VERSION = 2  # v2: flat layout (scalars [T,512], velocity [3,T,512])


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def save_npz(path: str, topo: Topology, state: FieldState,
             params: Optional[SolverParams] = None, frame: int = 0) -> None:
    meta = {
        "version": _FORMAT_VERSION,
        "frame": frame,
        "n_active": int(topo.n_active),
        "scalar_names": sorted(state.scalars),
        "params": dataclasses.asdict(params) if params else None,
    }
    arrays = {
        "keys": _host(topo.keys),
        "origins": _host(topo.origins),
        "nbr": _host(topo.nbr),
        "velocity": _host(state.velocity),
    }
    for k, v in state.scalars.items():
        arrays[f"scalar_{k}"] = _host(v)
    np.savez_compressed(path, meta=json.dumps(meta), **arrays)


def load_npz(path: str, device=None) -> Tuple[Topology, FieldState, Optional[SolverParams], int]:
    """(topo, state, params or None, frame) on ``device`` (default: the CUDA
    card); the topology keeps the file's keys, origins, nbr and capacity."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if meta["version"] != _FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {meta['version']}")
        topo = topology_from_numpy(z["keys"], z["origins"], z["nbr"], meta["n_active"],
                                   device=device)
        state = state_from_numpy(
            z["velocity"], {k: z[f"scalar_{k}"] for k in meta["scalar_names"]},
            device=topo.device)
        params = None
        if meta["params"]:
            p = dict(meta["params"])
            p["combustion"] = CombustionParams(**p["combustion"])
            params = SolverParams(**p)
        return topo, state, params, meta["frame"]


def save_sparse_npz(path: str, topo: Topology, state: FieldState,
                    frame: int = 0) -> None:
    """Coordinate-list export of active voxels only (compact interchange;
    decode path of the native tile builder)."""
    from hnanosolver_tpu_torch.io import native as NT

    n = int(topo.n_active)
    origins = _host(topo.origins[1 : n + 1])
    arrays = {"coords": NT.tile_coords(origins)}  # [n*512, 3]
    arrays["velocity"] = _host(state.velocity_blocks()[1 : n + 1]).reshape(-1, 3)
    for k, v in state.scalars.items():
        arrays[f"scalar_{k}"] = _host(v[1 : n + 1]).reshape(-1)
    meta = {"version": _FORMAT_VERSION, "frame": frame,
            "scalar_names": sorted(state.scalars)}
    np.savez_compressed(path, meta=json.dumps(meta), **arrays)


def load_sparse_npz(path: str, capacity: Optional[int] = None, device=None):
    """Rebuild (Topology, FieldState, frame) from a coordinate-list export, on
    ``device`` (default: the CUDA card)."""
    from hnanosolver_tpu_torch.io import native as NT

    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        _, origins, row, local = NT.build_index(z["coords"])
        topo = build_topology(origins, capacity=capacity, device=device)
        num_rows = topo.capacity
        # native row ids are 1..M in sorted-key order == topology rows 1..M
        vel = NT.scatter(row, local, z["velocity"], num_rows, channels=3)
        state = FieldState.from_blocks(
            vel.reshape(num_rows, 8, 8, 8, 3),
            {k: NT.scatter(row, local, z[f"scalar_{k}"], num_rows).reshape(num_rows, 8, 8, 8)
             for k in meta["scalar_names"]},
            device=topo.device,
        )
        return topo, state, meta["frame"]
