"""Trilinear interpolation as one-hot contractions (the JAX package's
``ops/interp.py``, its ``INTERP = "mxu"`` sampler):

  out[v] = sum_{a,b,c} Wx[v,a] * Wy[v,b] * Wz[v,c] * B[a,b,c]

where ``B`` is the tile's 3x3x3-neighbourhood block (24^3 voxels, assembled
from the 27-table by static reshapes) and ``Wx/Wy/Wz [512, 24]`` are
per-voxel hat-function weights, each row holding the two nonzero trilinear
coefficients at floor(pos) and floor(pos)+1. The first contraction is a
[512,24] x [24,576] matrix product per tile, the other two collapse small
axes elementwise. Displacements must satisfy |d| < 7 per axis (corner
coordinates stay inside the neighbourhood): the advection's clamp.

The first contraction was an XLA ``dot_general`` at ``Precision.HIGHEST``
(true f32), not a Pallas kernel; here it is ``torch.bmm`` in true f32: TF32
is off for it (``torch.backends.cuda.matmul.allow_tf32`` is set False for
the call, under a lock, and restored after). The advection does not call
it: under ``INTERP = "mxu"`` it runs the nbr-form kernels, which take the
same samples (``ops/advection.py``'s module doc).
"""

from __future__ import annotations

import contextlib
import threading
from typing import List, Sequence

import torch

from hnanosolver_tpu_torch.core.layout import TILE, col_coords

A = 24  # neighbourhood extent per axis (3 tiles x 8 voxels)


_TF32_LOCK = threading.Lock()  # the flag is process-wide: one toggle at a time


@contextlib.contextmanager
def _true_f32():
    with _TF32_LOCK:
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev


def assemble_blocks(table: torch.Tensor) -> torch.Tensor:
    """27-table [C, 27*512] -> neighbourhood blocks [C, 24, 24, 24].

    Table entry d*512+col with d=(dx+1)*9+(dy+1)*3+(dz+1), col=x*64+y*8+z:
    a pure reshape/permute."""
    C = table.shape[0]
    t = table.reshape(C, 3, 3, 3, 8, 8, 8)  # [C, dx, dy, dz, x, y, z]
    t = t.permute(0, 1, 4, 2, 5, 3, 6)  # [C, dx, x, dy, y, dz, z]
    return t.reshape(C, A, A, A)


def hat_weights(local: torch.Tensor) -> torch.Tensor:
    """Per-voxel 1-D interpolation weights [C, 512, 24] for sample positions
    ``local`` [C,512] in neighbourhood coords ([0, 24); = in-tile coord + 8 +
    displacement). Two nonzeros per row: (1-frac) at floor, frac at floor+1."""
    base = torch.floor(local)
    frac = (local - base)[:, :, None]
    b = base.to(torch.int32)[:, :, None]
    ar = torch.arange(A, dtype=torch.int32, device=local.device)[None, None, :]
    zero = torch.zeros((), dtype=local.dtype, device=local.device)
    return torch.where(ar == b, 1.0 - frac, zero) + torch.where(ar == b + 1, frac, zero)


def trilinear_mxu(tables: Sequence[torch.Tensor], dx: torch.Tensor, dy: torch.Tensor,
                  dz: torch.Tensor) -> List[torch.Tensor]:
    """Sample every field's 27-table at per-voxel displacements (one chunk).

    tables: list of [C, 27*512]; dx/dy/dz: [C,512] clamped displacements.
    Returns a list of [C,512] sampled values."""
    C = dx.shape[0]
    cx, cy, cz = col_coords(dx.device)
    wx = hat_weights(cx.float() + 8.0 + dx)  # [C,512,24]
    wy = hat_weights(cy.float() + 8.0 + dy)
    wz = hat_weights(cz.float() + 8.0 + dz)
    outs = []
    for tb in tables:
        B = assemble_blocks(tb).reshape(C, A, A * A)
        with _true_f32():
            t1 = torch.bmm(wx, B).reshape(C, TILE, A, A)  # [C,512,24] x [C,24,576]
        t2 = torch.sum(t1 * wy[:, :, :, None], dim=2)  # [C,512,24]
        outs.append(torch.sum(t2 * wz, dim=2))  # [C,512]
    return outs
