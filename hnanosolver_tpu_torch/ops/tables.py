"""The table sampler's per-chunk tables, the table half of
``hnanosolver_tpu/ops/pallas_bfecc.py`` (``build_table``,
``build_table_dual``): plain torch gathers, as they were XLA in the JAX
package. Both use the JAX layout ``[nc, U*nf, 8, 64]``: row ``u*nf + f`` is
field f of the chunk's u-th row, column ``x*64 + y*8 + z``.

- ``build_table``: chunk c's unique 27-neighbourhood rows
  (``topo.chunk_uniq``).
- ``build_table_dual``: chunk c's half-shifted dual rows
  S[d][l] = f[d*8 + l - 4] (``topo.chunk_dsrc``). Voxel l = (x, y, z) of
  a dual row reads source j = (x>=4)*4 + (y>=4)*2 + (z>=4) at local
  l ^ (4, 4, 4), i.e. column ``col ^ 292``. Kernel B11
  (``ops/cuda_tables.py``) builds the same table from a ``build_table``
  result.

Fields are given as ``[nf, T, 512]`` (or a sequence of ``[T, 512]``).
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

from hnanosolver_tpu_torch.core.layout import TILE, col_coords

Fields = Union[torch.Tensor, Sequence[torch.Tensor]]


def _stacked(fields: Fields) -> torch.Tensor:
    return fields if isinstance(fields, torch.Tensor) else torch.stack(list(fields))


def dual_source(device) -> tuple[torch.Tensor, torch.Tensor]:
    """(j [512], src [512]) int64: the source index j and source column of
    each column of a dual row."""
    cx, cy, cz = (c[0].long() for c in col_coords(device))
    j = (cx >= 4).long() * 4 + (cy >= 4).long() * 2 + (cz >= 4).long()
    return j, torch.arange(TILE, device=device) ^ 292


def build_table(topo, fields: Fields) -> torch.Tensor:
    """[nc, U*nf, 8, 64]: row u*nf + f = field f of tile row chunk_uniq[c, u]."""
    f = _stacked(fields)
    nf, T, _ = f.shape
    nc, U = topo.chunk_uniq.shape
    packed = f.permute(1, 0, 2).reshape(T, nf * TILE)
    return packed.index_select(0, topo.chunk_uniq.reshape(-1).long()).reshape(nc, U * nf, 8, 64)


def build_table_dual(topo, fields: Fields, dsrc: torch.Tensor | None = None) -> torch.Tensor:
    """[nc, Ud*nf, 8, 64]: row u*nf + f = the half-shifted row of field f at
    chunk c's u-th dual tile."""
    f = _stacked(fields)
    nf, T, _ = f.shape
    dsrc = topo.chunk_dsrc if dsrc is None else dsrc
    nc, Ud, _ = dsrc.shape
    j, src = dual_source(f.device)
    idx = dsrc.long()[:, :, j] * TILE + src  # [nc, Ud, 512]
    out = f.reshape(nf, T * TILE)[:, idx.reshape(-1)]  # [nf, nc*Ud*512]
    return out.reshape(nf, nc, Ud, TILE).permute(1, 2, 0, 3).reshape(nc, Ud * nf, 8, 64)


def table_bytes(nc: int, U: int, nf: int) -> int:
    """The JAX package's byte model of one chunk table at its peak build
    (``pallas_bfecc._pick_slices``), which decides when it slices."""
    return nc * U * nf * 4 * (512 + 2 * 8 * 128)
