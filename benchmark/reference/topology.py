"""The reference's own sparse tile index, built from a tile list.

A domain is a set of 8^3 voxel tiles. Row 0 is the null tile (all zeros),
rows 1..n the active tiles in the order of their packed keys, the rest
padding. ``nbr[t, (dx+1)*9 + (dy+1)*3 + (dz+1)]`` is the row of the tile at
offset (dx, dy, dz), 0 where it is absent; it is built on a device only
where a frame is stepped (:func:`with_index`): the inputs need the rows
alone. Packing, order and capacity rule
are the solver's published layout (HNanoSolver's leaf tiles as the JAX and
PyTorch packages lay them out), written here again from that description so
that nothing of the program under test is imported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

LEAF = 8
TILE = 512
TILE_OFFSET = 512
NULL_KEY = np.int32(np.iinfo(np.int32).min)
PAD_KEY = np.int32(1 << 30)
SENTINEL = np.int32(1 << 20)  # origin of the null and padding rows
OFFSETS = np.array([(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                    for dz in (-1, 0, 1)], np.int32)  # [27, 3]


def pack(tiles: np.ndarray) -> np.ndarray:
    """Tile coords [..., 3] -> int32 keys ((x+512) << 20 | (y+512) << 10 | z+512)."""
    t = np.asarray(tiles, np.int64) + TILE_OFFSET
    return ((t[..., 0] << 20) | (t[..., 1] << 10) | t[..., 2]).astype(np.int32)


def unpack(keys: np.ndarray) -> np.ndarray:
    k = np.asarray(keys)
    return np.stack([(k >> 20) & 0x3FF, (k >> 10) & 0x3FF, k & 0x3FF], -1).astype(
        np.int32) - TILE_OFFSET


def round_capacity(n: int) -> int:
    """Rows for n active tiles and the null row: a power of two up to 2048,
    above it 25% slack rounded up to a multiple of 2048."""
    need = n + 1
    if need <= 2048:
        cap = 16
        while cap < need:
            cap *= 2
        return cap
    return ((int(need * 1.25) + 2047) // 2048) * 2048


def tight_capacity(n: int) -> int:
    """bench.py's capacity for a fixed envelope: the active tiles and the
    null row, rounded up to a multiple of 512."""
    return ((n + 1 + 511) // 512) * 512


@dataclasses.dataclass(frozen=True)
class Topo:
    keys: np.ndarray  # [T] int32, host
    origins: np.ndarray  # [T, 3] int32, host
    nbr: torch.Tensor | None  # [T, 27] int64 on the device; None: the rows alone
    n_active: int

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    @property
    def device(self) -> torch.device:
        return self.nbr.device

    def active(self, dtype) -> torch.Tensor:
        """[T] 1 on the active rows, 0 on the null and padding rows."""
        ids = torch.arange(self.capacity, device=self.device)
        return ((ids >= 1) & (ids <= self.n_active)).to(dtype)


def build(tiles: np.ndarray, capacity: int | None, device=None) -> Topo:
    """The index of the unique tiles of ``tiles [M, 3]`` at ``capacity``
    rows (default :func:`round_capacity`), with its neighbour table on
    ``device``; without a device the rows alone, on the host."""
    keys = np.unique(pack(np.asarray(tiles, np.int32).reshape(-1, 3)))
    n = int(keys.shape[0])
    cap = round_capacity(n) if capacity is None else int(capacity)
    if cap < n + 1:
        raise ValueError(f"capacity {cap} < {n + 1}")
    full = np.full(cap, PAD_KEY, np.int32)
    full[0] = NULL_KEY
    full[1:n + 1] = keys
    origins = np.full((cap, 3), SENTINEL, np.int32)
    origins[1:n + 1] = unpack(keys)
    rows = Topo(full, origins, None, n)
    return rows if device is None else with_index(rows, device)


def with_index(topo: Topo, device) -> Topo:
    """``topo`` with its neighbour table on ``device``."""
    n, keys = topo.n_active, topo.keys[1:topo.n_active + 1]
    nbr = np.zeros((topo.capacity, 27), np.int64)
    if n:
        want = pack(topo.origins[1:n + 1, None, :] + OFFSETS[None])
        pos = np.minimum(np.searchsorted(keys, want), n - 1)
        nbr[1:n + 1] = np.where(keys[pos] == want, pos + 1, 0)
    return dataclasses.replace(topo, nbr=torch.from_numpy(nbr).to(device))


def from_keys(keys: np.ndarray, device) -> Topo:
    """The index whose rows hold ``keys`` (a full key column: null, sorted
    active keys, padding), at its capacity."""
    keys = np.asarray(keys, np.int32)
    n = int(((keys != NULL_KEY) & (keys != PAD_KEY)).sum())
    return build(unpack(keys[1:n + 1]), keys.shape[0], device)


def plume_envelope(radius_vox: int, height_vox: int, center_x: int, center_z: int) -> np.ndarray:
    """The developed plume's tile set (bench.py:248-296's envelope): a disc
    of tiles at every tile height, its radius widening from 0.6 to 1.0 of
    ``radius_vox`` with height. Vectorised; the same tiles as the loop."""
    r_t, h_t = radius_vox // LEAF, height_vox // LEAF
    cx, cz = center_x // LEAF, center_z // LEAF
    y = np.arange(h_t)
    rr = r_t * (0.6 + 0.4 * y / max(h_t - 1, 1))
    d = np.arange(-r_t, r_t + 1)
    dx, dz = np.meshgrid(d, d, indexing="ij")
    inside = (dx * dx + dz * dz)[None] <= (rr * rr)[:, None, None]
    yy, ix, iz = np.nonzero(inside)
    return np.stack([cx + d[ix], yy, cz + d[iz]], -1).astype(np.int32)


def emitter_tiles(center, radius: float, pad: int = 1) -> np.ndarray:
    """Tiles covering the emitter sphere and ``pad`` tiles around it."""
    c = np.asarray(center, np.float64)
    r = radius + pad * LEAF
    lo = np.floor((c - r) / LEAF).astype(np.int32)
    hi = np.ceil((c + r) / LEAF).astype(np.int32)
    g = np.meshgrid(*(np.arange(a, b + 1) for a, b in zip(lo, hi)), indexing="ij")
    tiles = np.stack(g, -1).reshape(-1, 3)
    keep = np.linalg.norm((tiles + 0.5) * LEAF - c, axis=-1) <= r + LEAF
    return tiles[keep].astype(np.int32)
