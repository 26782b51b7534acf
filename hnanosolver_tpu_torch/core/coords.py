"""Tile-coordinate packing (host numpy).

- ``LEAF = 8``: tile edge in voxels; a tile holds ``TILE_VOXELS = 512``.
- Tile coordinates live in ``[-TILE_OFFSET, TILE_OFFSET)`` per axis.
- Packed key: ``((tx+512) << 20) | ((ty+512) << 10) | (tz+512)``, a
  nonnegative int32 whose sort order is lexicographic (x, y, z).
- ``NULL_KEY`` marks row 0, the all-zero null tile; ``PAD_KEY`` marks the
  padding rows at the tail of the table.
"""

from __future__ import annotations

import numpy as np

LEAF = 8
TILE_VOXELS = LEAF * LEAF * LEAF
TILE_OFFSET = 512
_SHIFT_X = 20
_SHIFT_Y = 10

NULL_KEY = np.int32(np.iinfo(np.int32).min)
PAD_KEY = np.int32(1 << 30)


def pack_keys_np(tile_coords: np.ndarray) -> np.ndarray:
    """Pack int tile coordinates ``[..., 3]`` into sortable int32 keys."""
    t = np.asarray(tile_coords, dtype=np.int64)
    key = (
        ((t[..., 0] + TILE_OFFSET) << _SHIFT_X)
        | ((t[..., 1] + TILE_OFFSET) << _SHIFT_Y)
        | (t[..., 2] + TILE_OFFSET)
    )
    return key.astype(np.int32)


def unpack_keys_np(keys: np.ndarray) -> np.ndarray:
    """Inverse of :func:`pack_keys_np` -> int32 tile coords ``[..., 3]``."""
    k = np.asarray(keys)
    return np.stack(
        [(k >> _SHIFT_X) & 0x3FF, (k >> _SHIFT_Y) & 0x3FF, k & 0x3FF], axis=-1
    ).astype(np.int32) - TILE_OFFSET
