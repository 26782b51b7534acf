"""Flat-layout neighbour access on ``[T, 512]`` fields.

A face-shifted view takes the in-tile part by a lane roll of the field and
the boundary plane by a roll of the face neighbour's row (fetched through
``topo.nbr``). Absent neighbours point at the all-zero row 0, so reads
outside the domain are exact zeros.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from hnanosolver_tpu_torch.core.layout import TILE, col_coords

# direction -> (boundary axis, boundary coordinate, in-tile roll, fix roll);
# torch.roll(p, s, -1)[col] == p[col - s]
_DIRS: Dict[Tuple[int, int, int], tuple] = {
    (1, 0, 0): (0, 7, -64, 448),
    (-1, 0, 0): (0, 0, 64, -448),
    (0, 1, 0): (1, 7, -8, 56),
    (0, -1, 0): (1, 0, 8, -56),
    (0, 0, 1): (2, 7, -1, 7),
    (0, 0, -1): (2, 0, 1, -7),
}

FACE_DIRS = tuple(_DIRS)


def d_of(off) -> int:
    """Index of a neighbour offset in the 27-entry ``nbr`` table."""
    return (off[0] + 1) * 9 + (off[1] + 1) * 3 + (off[2] + 1)


def _boundary_mask(off, device) -> torch.Tensor:
    axis, at, _, _ = _DIRS[tuple(off)]
    return col_coords(device)[axis] == at


def shifted_view(topo, f: torch.Tensor, off) -> torch.Tensor:
    """One +-1 face-shifted view of ``f [..., T, 512]`` (one row gather for
    all leading fields)."""
    return shifted_view_nbr(topo.nbr, f, off)


def shifted_view_nbr(nbr: torch.Tensor, f: torch.Tensor, off) -> torch.Tensor:
    """:func:`shifted_view` given the ``nbr [T,27]`` table itself."""
    _, _, s_in, s_fix = _DIRS[tuple(off)]
    n = f.index_select(-2, nbr[:, d_of(off)])
    return torch.where(_boundary_mask(off, f.device),
                       torch.roll(n, s_fix, -1), torch.roll(f, s_in, -1))


def shifted_views(topo, f: torch.Tensor, dirs=FACE_DIRS) -> Dict[tuple, torch.Tensor]:
    """``{off: shifted_view(topo, f, off)}`` for each direction of ``dirs``."""
    return {off: shifted_view(topo, f, off) for off in dirs}


def face_minmax_multi(topo, fields: torch.Tensor):
    """Per-voxel (min, max) over the six face-shifted views of F stacked
    fields ``[F,T,512]`` (the JAX package's plane-gather form computes the
    same values)."""
    views = face_views_multi(topo, fields)
    return views.amin(0), views.amax(0)


def face_views_multi(topo, fields: torch.Tensor) -> torch.Tensor:
    """All six face-shifted views of F stacked fields: ``[F,T,512]`` ->
    ``[6,F,T,512]`` in FACE_DIRS order."""
    return face_views_nbr(topo.nbr, fields)


def face_views_nbr(nbr: torch.Tensor, fields: torch.Tensor) -> torch.Tensor:
    """:func:`face_views_multi` given the ``nbr [T,27]`` table itself."""
    views = []
    for off in FACE_DIRS:
        _, _, s_in, s_fix = _DIRS[off]
        n = fields.index_select(1, nbr[:, d_of(off)])
        views.append(torch.where(_boundary_mask(off, fields.device),
                                 torch.roll(n, s_fix, -1),
                                 torch.roll(fields, s_in, -1)))
    return torch.stack(views)


def neighbor_sum(topo, f: torch.Tensor) -> torch.Tensor:
    """Sum of the six face neighbours, added left to right in FACE_DIRS
    order (the JAX package's order)."""
    return neighbor_sum_nbr(topo.nbr, f)


def neighbor_sum_nbr(nbr: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """:func:`neighbor_sum` given the ``nbr [T,27]`` table itself."""
    v = face_views_nbr(nbr, f[None])[:, 0]
    return v[0] + v[1] + v[2] + v[3] + v[4] + v[5]


def offset_view(topo, f: torch.Tensor, off) -> torch.Tensor:
    """``f [..., T, 512]`` at the fixed integer offset ``off`` (each
    component in [-8, 8]): per column, one read from the neighbour tile
    row that holds voxel + off, through ``nbr`` (the null row where it is
    absent). The JAX package reads the same values from a [T, 27*512]
    neighbourhood table; this reads them without one."""
    ox, oy, oz = (int(o) for o in off)
    if not all(-8 <= o <= 8 for o in (ox, oy, oz)):
        raise ValueError(f"offset {off} outside [-8, 8]")
    cx, cy, cz = col_coords(f.device)
    qx, qy, qz = cx[0] + ox, cy[0] + oy, cz[0] + oz
    d = ((qx + 8) >> 3) * 9 + ((qy + 8) >> 3) * 3 + ((qz + 8) >> 3)  # [512]
    lane = (qx & 7) * 64 + (qy & 7) * 8 + (qz & 7)
    T = topo.nbr.shape[0]
    idx = topo.nbr[:, d].long() * TILE + lane  # [T, 512]
    flat = f.reshape(*f.shape[:-2], T * TILE)
    return flat[..., idx.reshape(-1)].reshape(f.shape)


def neighbor_table(topo, f: torch.Tensor) -> torch.Tensor:
    """``[T, 27*512]``: every tile's 3x3x3 neighbourhood values, entry
    ``d*512 + col`` with d the ``nbr`` column."""
    T = f.shape[0]
    return f.index_select(0, topo.nbr.reshape(-1)).reshape(T, 27 * TILE)


def gather_table(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched in-row gather: table ``[T, 13824]``, idx ``[T,512]`` -> ``[T,512]``."""
    return torch.gather(table, 1, idx.long())


def table_index(cx, cy, cz):
    """In-neighbourhood coords (each in [-8, 16)) -> index into the 27-tile
    neighbourhood table ``d*512 + col``, with d the ``nbr`` column."""
    ox = (cx + 8) >> 3
    oy = (cy + 8) >> 3
    oz = (cz + 8) >> 3
    d = (ox * 9 + oy * 3 + oz) * TILE
    return d + (cx & 7) * 64 + (cy & 7) * 8 + (cz & 7)
