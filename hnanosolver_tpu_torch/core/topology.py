"""Sparse tile topology: sorted packed tile keys plus a 27-neighbour table.

- ``keys    [T]``      sorted packed tile keys; row 0 = NULL_KEY (the null
                       tile, all-zero values), rows ``[1, n_active]`` active,
                       tail rows = PAD_KEY.
- ``origins [T, 3]``   tile coords (voxel origin = ``origins * 8``); the null
                       and padding rows hold a far-away sentinel.
- ``nbr     [T, 27]``  row of each 3x3x3 neighbour, index
                       ``(dx+1)*9 + (dy+1)*3 + (dz+1)``, 0 where absent. The
                       null and padding rows are all 0 (``nbr[t, 13]`` is 0
                       there, not t).

The table is built on the host in numpy and moved to ``device`` once; the
tensors' device is the device every op on this topology runs on.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from hnanosolver_tpu_torch.core import coords as C

_ORIGIN_SENTINEL = np.int32(1 << 20)

_NBR_OFFSETS = np.array(
    [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)],
    dtype=np.int32,
)  # [27, 3]; centre at 13


@dataclasses.dataclass(frozen=True)
class Topology:
    """Static-capacity sparse tile index (int32 tensors on one device)."""

    keys: torch.Tensor  # [T] int32
    origins: torch.Tensor  # [T, 3] int32
    nbr: torch.Tensor  # [T, 27] int32
    n_active: int  # active rows are 1..n_active

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    @property
    def num_voxels(self) -> int:
        return self.n_active * C.TILE_VOXELS

    @property
    def device(self) -> torch.device:
        return self.nbr.device


def _round_capacity(n: int) -> int:
    """Capacity for n active tiles plus the null row: a power of two up to
    2048, above that 25% slack rounded to a multiple of 2048."""
    need = n + 1
    if need <= 2048:
        cap = 16
        while cap < need:
            cap *= 2
        return cap
    return ((int(need * 1.25) + 2047) // 2048) * 2048


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else the
    CUDA card. Raises when a CUDA device is asked for and none is present:
    the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but no CUDA device is available; pass "
            "device='cpu' explicitly to run the plain PyTorch versions on the CPU")
    return dev


def build_topology(
    tile_coords: np.ndarray,
    capacity: Optional[int] = None,
    device: torch.device | str | None = None,
) -> Topology:
    """Build a Topology on ``device`` (default: the CUDA card) from an
    ``[M, 3]`` array of (possibly duplicated) tile coordinates; the tables
    are computed in host numpy."""
    device = resolve_device(device)
    tile_coords = np.asarray(tile_coords, dtype=np.int32).reshape(-1, 3)
    if tile_coords.size:
        lo, hi = tile_coords.min(), tile_coords.max()
        if lo < -C.TILE_OFFSET or hi >= C.TILE_OFFSET:
            raise ValueError(
                f"tile coords out of packable range [-512, 512): [{lo}, {hi}]"
            )
    keys_np = np.unique(C.pack_keys_np(tile_coords))
    n = int(keys_np.shape[0])
    cap = capacity if capacity is not None else _round_capacity(n)
    if cap < n + 1:
        raise ValueError(f"capacity {cap} < {n + 1} required")

    full_keys = np.full((cap,), C.PAD_KEY, dtype=np.int32)
    full_keys[0] = C.NULL_KEY
    full_keys[1 : n + 1] = keys_np

    origins = np.full((cap, 3), _ORIGIN_SENTINEL, dtype=np.int32)
    if n:
        origins[1 : n + 1] = C.unpack_keys_np(keys_np)

    nbr = np.zeros((cap, 27), dtype=np.int32)
    if n:
        nbr_keys = C.pack_keys_np(origins[1 : n + 1, None, :] + _NBR_OFFSETS[None])
        pos = np.searchsorted(keys_np, nbr_keys)
        pos_c = np.minimum(pos, n - 1)
        found = keys_np[pos_c] == nbr_keys
        nbr[1 : n + 1] = np.where(found, pos_c + 1, 0).astype(np.int32)
    return Topology(
        keys=torch.from_numpy(full_keys).to(device),
        origins=torch.from_numpy(origins).to(device),
        nbr=torch.from_numpy(nbr).to(device),
        n_active=n,
    )


def active_mask(topo: Topology) -> torch.Tensor:
    """[T] float32: 1.0 for active tile rows, 0.0 for null/padding rows."""
    ids = torch.arange(topo.capacity, device=topo.device)
    return ((ids >= 1) & (ids <= topo.n_active)).to(torch.float32)
