"""Dense box <-> sparse tile conversion: reshape/transpose between
``[Nx, Ny, Nz, *ch]`` boxes and ``[T, 8, 8, 8, *ch]`` tile stacks on the
topology's device. Used by tests, I/O and dense-vs-sparse comparisons.

(``hnanosolver_tpu_torch/convert.py`` is another module: it carries the JAX
package's numpy arrays into the port.)
"""

from __future__ import annotations

import numpy as np
import torch

from hnanosolver_tpu_torch.core import coords as C
from hnanosolver_tpu_torch.core.topology import Topology, lookup_tiles


def _box_tiles(tx: int, ty: int, tz: int, origin) -> np.ndarray:
    """Tile coords of a box of tx x ty x tz tiles at voxel ``origin``,
    x-major, [tx*ty*tz, 3]."""
    ot = np.asarray(origin, np.int32) // C.LEAF
    gx, gy, gz = np.meshgrid(np.arange(tx) + ot[0], np.arange(ty) + ot[1],
                             np.arange(tz) + ot[2], indexing="ij")
    return np.stack([gx, gy, gz], -1).reshape(-1, 3)


def dense_to_tiles(topo: Topology, dense, origin=(0, 0, 0)) -> torch.Tensor:
    """Scatter a dense ``[Nx, Ny, Nz, *ch]`` box (a tensor or an array; voxel
    ``origin`` aligned to 8) into tile layout ``[T, 8, 8, 8, *ch]`` matching
    ``topo``. Rows of tiles outside the box, and the null row, are zero."""
    L = C.LEAF
    dense = torch.as_tensor(dense, device=topo.device)
    Nx, Ny, Nz = dense.shape[:3]
    ch = tuple(dense.shape[3:])
    if Nx % L or Ny % L or Nz % L:
        raise ValueError(f"box {tuple(dense.shape[:3])} is not a multiple of {L}")
    tx, ty, tz = Nx // L, Ny // L, Nz // L
    blocks = dense.reshape((tx, L, ty, L, tz, L) + ch)
    blocks = torch.movedim(blocks, (1, 3), (3, 4)).reshape((tx * ty * tz, L, L, L) + ch)
    ids = lookup_tiles(topo, _box_tiles(tx, ty, tz, origin))
    out = torch.zeros((topo.capacity, L, L, L) + ch, dtype=dense.dtype, device=topo.device)
    keep = ids > 0
    out[ids[keep]] = blocks[keep]
    return out


def tiles_to_dense(topo: Topology, field: torch.Tensor, shape,
                   origin=(0, 0, 0)) -> torch.Tensor:
    """Gather tiles ``[T, 8, 8, 8, *ch]`` back into a dense box of ``shape``
    voxels (zeros where no tile is active)."""
    L = C.LEAF
    Nx, Ny, Nz = (int(s) for s in shape)
    ch = tuple(field.shape[4:])
    tx, ty, tz = Nx // L, Ny // L, Nz // L
    ids = lookup_tiles(topo, _box_tiles(tx, ty, tz, origin))
    blocks = field.index_select(0, ids).reshape((tx, ty, tz, L, L, L) + ch)
    blocks = torch.movedim(blocks, (3, 4), (1, 3))
    return blocks.reshape((Nx, Ny, Nz) + ch)
