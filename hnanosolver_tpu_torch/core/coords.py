"""Tile-coordinate packing and voxel <-> tile index math, as host numpy
(``*_np``) and as tensors on any device.

- ``LEAF = 8``: tile edge in voxels; a tile holds ``TILE_VOXELS = 512``.
- Tile coordinates live in ``[-TILE_OFFSET, TILE_OFFSET)`` per axis.
- Packed key: ``((tx+512) << 20) | ((ty+512) << 10) | (tz+512)``, a
  nonnegative int32 whose sort order is lexicographic (x, y, z).
- ``NULL_KEY`` marks row 0, the all-zero null tile; ``PAD_KEY`` marks the
  padding rows at the tail of the table.
"""

from __future__ import annotations

import numpy as np
import torch

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


def pack_keys(tile_coords: torch.Tensor) -> torch.Tensor:
    """Tensor form of :func:`pack_keys_np`: int tile coordinates ``[..., 3]``
    -> int32 keys on the same device. Coordinates outside the packable
    range wrap as int32 arithmetic does (the JAX package's form); lookups
    reject them before they can alias a valid key."""
    t = tile_coords.to(torch.int64) + TILE_OFFSET
    key = (t[..., 0] << _SHIFT_X) | (t[..., 1] << _SHIFT_Y) | t[..., 2]
    return key.to(torch.int32)


def unpack_keys(keys: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_keys` -> int32 tile coords ``[..., 3]``."""
    k = keys.to(torch.int32)
    return torch.stack(
        [(k >> _SHIFT_X) & 0x3FF, (k >> _SHIFT_Y) & 0x3FF, k & 0x3FF], dim=-1
    ) - TILE_OFFSET


def voxel_to_tile(voxel_coords: torch.Tensor) -> torch.Tensor:
    """Voxel coord -> owning tile coord (arithmetic shift handles negatives)."""
    return voxel_coords >> 3


def voxel_to_local(voxel_coords: torch.Tensor) -> torch.Tensor:
    """Voxel coord -> offset within its tile, each component in [0, 8)."""
    return voxel_coords & 7


def local_flat_index(local: torch.Tensor) -> torch.Tensor:
    """(lx, ly, lz) in-tile offsets -> flat index in [0, 512), x-major."""
    return (local[..., 0] * LEAF + local[..., 1]) * LEAF + local[..., 2]
