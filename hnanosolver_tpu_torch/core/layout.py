"""Canonical field layout.

- scalar field: ``[T, 512]`` float32, x-major in-tile order
  ``col = x*64 + y*8 + z``;
- velocity: ``[3, T, 512]`` float32, channel-major.

Row 0 is the all-zero null tile and padding rows stay zero, so a read
through an absent neighbour is an exact background 0.
"""

from __future__ import annotations

import torch

TILE = 512


def col_coords(device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The in-tile coordinates (x, y, z) of each column, three [1, 512]
    int32 tensors, computed on ``device`` (a host-to-device copy would
    make the host wait for the device)."""
    col = torch.arange(TILE, dtype=torch.int32, device=device)[None, :]
    return col // 64, (col // 8) % 8, col % 8


CX, CY, CZ = col_coords("cpu")


def positions_flat(topo) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """World voxel coordinates as three [T, 512] int32 tensors."""
    org = topo.origins * 8
    cx, cy, cz = col_coords(org.device)
    return org[:, 0:1] + cx, org[:, 1:2] + cy, org[:, 2:3] + cz


def parity_flat(topo) -> torch.Tensor:
    """(i+j+k) & 1 per voxel, [T, 512] int32."""
    org = topo.origins * 8
    cx, cy, cz = col_coords(org.device)
    base = (org[:, 0] + org[:, 1] + org[:, 2])[:, None]
    return (base + cx + cy + cz) & 1
