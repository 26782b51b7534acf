"""Halo assembly, the JAX package's ``ops/halo.py``: an r-voxel shell
around every tile, gathered from the 26 neighbour tiles through
``Topology.nbr``.

Each of the 26 offset directions is one row gather (``index_select``) of
the pre-sliced neighbour planes, edges or corners; absent neighbours are
row 0, the null tile, whose zeros give the background for free. The
samplers of ``ops/sampling.py`` read their corners from these blocks.

Fields use the JAX package's block layout ``[T, 8, 8, 8, *ch]``.
"""

from __future__ import annotations

import torch


def _src(o: int, r: int) -> slice:
    """Source slice in the neighbour tile for axis offset o and radius r."""
    return {-1: slice(8 - r, 8), 0: slice(0, 8), 1: slice(0, r)}[o]


def _dst(o: int, r: int) -> slice:
    """Destination slice in the padded tile."""
    return {-1: slice(0, r), 0: slice(r, r + 8), 1: slice(r + 8, r + 8 + r)}[o]


def gather_halo(topo, field: torch.Tensor, radius: int = 1,
                faces_only: bool = False) -> torch.Tensor:
    """``[T, 8, 8, 8, *ch]`` -> ``[T, 8+2r, 8+2r, 8+2r, *ch]`` with an
    r-voxel halo from the neighbour tiles (1 <= r <= 8: everything needed
    lies in the 27-neighbourhood). ``faces_only`` gathers just the 6 face
    neighbours, enough for a 7-point stencil; edge and corner cells then
    stay zero and must not be read."""
    r = int(radius)
    if not 1 <= r <= 8:
        raise ValueError(f"halo radius {radius}: expected 1 <= r <= 8")
    T = field.shape[0]
    ch = tuple(field.shape[4:])
    E = 8 + 2 * r
    pad = torch.zeros((T, E, E, E) + ch, dtype=field.dtype, device=field.device)
    nbr = topo.nbr.long()
    for ox in (-1, 0, 1):
        for oy in (-1, 0, 1):
            for oz in (-1, 0, 1):
                nz = (ox != 0) + (oy != 0) + (oz != 0)
                if faces_only and nz > 1:
                    continue
                sub = field[:, _src(ox, r), _src(oy, r), _src(oz, r)]
                if nz:
                    sub = sub.index_select(0, nbr[:, (ox + 1) * 9 + (oy + 1) * 3 + (oz + 1)])
                pad[:, _dst(ox, r), _dst(oy, r), _dst(oz, r)] = sub
    return pad


def face_shift_views(topo, field: torch.Tensor) -> dict:
    """The six +-1 face-shifted views of a block-layout field
    ``[T, 8, 8, 8, *ch]`` without a padded buffer: each view is the in-tile
    slice joined to the face plane gathered from the neighbour tile.
    Returns ``{(dx, dy, dz): view}``, views shaped like ``field``."""
    nbr = topo.nbr.long()
    out = {}
    for axis in range(3):
        for step in (1, -1):
            off = tuple(step if a == axis else 0 for a in range(3))
            d = (off[0] + 1) * 9 + (off[1] + 1) * 3 + (off[2] + 1)
            ax = axis + 1
            if step == 1:  # i = 7 reads the +axis neighbour's plane 0
                inner = field.narrow(ax, 1, 7)
                face = field.narrow(ax, 0, 1).index_select(0, nbr[:, d])
                out[off] = torch.cat([inner, face], ax)
            else:  # i = 0 reads the -axis neighbour's plane 7
                inner = field.narrow(ax, 0, 7)
                face = field.narrow(ax, 7, 1).index_select(0, nbr[:, d])
                out[off] = torch.cat([face, inner], ax)
    return out


def center(pad: torch.Tensor) -> torch.Tensor:
    """The un-padded 8^3 interior of a halo array (any radius)."""
    r = (pad.shape[1] - 8) // 2
    return pad[:, r:r + 8, r:r + 8, r:r + 8]


def shift(pad: torch.Tensor, dx: int, dy: int, dz: int) -> torch.Tensor:
    """Neighbour view at integer offset (dx, dy, dz), each within the halo
    radius: ``shift(pad, 1, 0, 0)[t, i, j, k]`` is the field at the voxel
    one step along +x of (t, i, j, k)."""
    r = (pad.shape[1] - 8) // 2
    return pad[:, r + dx:r + 8 + dx, r + dy:r + 8 + dy, r + dz:r + 8 + dz]
