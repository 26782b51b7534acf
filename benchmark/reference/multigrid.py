"""Geometric multigrid for the pressure solve on the tile hierarchy, plain.

Level k+1's tiles are the unique ``tile >> 1`` of level k, so a coarse
tile covers 2x2x2 fine tiles. Restriction averages 2x2x2 voxels;
prolongation is trilinear at cell centres (weights 0.75 / 0.25 along each
axis, Dirichlet 0 outside). A coarse voxel is in the domain when all of
its fine voxels are. A V-cycle smooths ``n_pre`` pairs (one lagged-halo
pair a block above MAX_FUSED_ROWS rows), restricts the residual, recurses,
adds the prolonged correction and smooths ``n_post`` pairs; the coarsest
level takes ``n_coarsest`` pairs. The full-multigrid start solves the
coarsest level and refines each finer one with one V-cycle. This is the
scheme the tile packages document for their "mg" solver, written again
here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import ops
from .topology import Topo, build, pack, unpack


@dataclasses.dataclass(frozen=True)
class Level:
    topo: Topo
    children: torch.Tensor  # [Tc, 8] fine rows by octant (0 absent)
    parent: torch.Tensor  # [Tf] coarse row of each fine row (0 none)
    octant: torch.Tensor  # [Tf] (x&1)*4 + (y&1)*2 + (z&1)
    mask: torch.Tensor  # [Tc, 512] 1 where the coarse voxel is in the domain


def hierarchy(topo: Topo, levels: int, dtype) -> list:
    dev = topo.device
    out = []
    nf, fine_cap = topo.n_active, topo.capacity
    fo = topo.origins[1:nf + 1]
    fine_mask = np.zeros((fine_cap, 512), np.float64)
    fine_mask[1:nf + 1] = 1.0
    for _ in range(levels):
        co = fo >> 1
        coarse = build(co, None, dev)
        nc = coarse.n_active
        ckeys = coarse.keys[1:nc + 1]
        prow = np.searchsorted(ckeys, pack(co)) + 1
        parent = np.zeros(fine_cap, np.int64)
        parent[1:nf + 1] = prow
        octant = np.zeros(fine_cap, np.int64)
        octant[1:nf + 1] = (fo[:, 0] & 1) * 4 + (fo[:, 1] & 1) * 2 + (fo[:, 2] & 1)
        children = np.zeros((coarse.capacity, 8), np.int64)
        children[prow, octant[1:nf + 1]] = np.arange(1, nf + 1)
        m = fine_mask.reshape(fine_cap, 4, 2, 4, 2, 4, 2).min(axis=(2, 4, 6))
        ch = m[children.reshape(-1)].reshape(-1, 2, 2, 2, 4, 4, 4)
        mask = np.moveaxis(ch, (1, 2, 3), (1, 3, 5)).reshape(-1, 512)
        out.append(Level(coarse, *(torch.from_numpy(a).to(dev) for a in (children, parent, octant)),
                         torch.from_numpy(mask).to(dev, dtype)))
        fo = unpack(ckeys)
        nf, fine_cap, fine_mask = nc, coarse.capacity, mask
    return out


def _lane_tables(device):
    lane = np.arange(512)
    lx, ly, lz = lane // 64, (lane // 8) % 8, lane % 8
    down = np.asarray([128 * a + 16 * b + 2 * c for a in range(4) for b in range(4)
                       for c in range(4)])
    assemble = ((lx // 4) * 4 + (ly // 4) * 2 + (lz // 4)) * 64 + (
        (lx % 4) * 16 + (ly % 4) * 4 + (lz % 4))
    o = np.arange(8)[:, None]
    idx_oct = (((o >> 2) & 1) * 4 + lx // 2) * 64 + (((o >> 1) & 1) * 4 + ly // 2) * 8 + (
        (o & 1) * 4 + lz // 2)
    q = (lz & 1) * 4 + (ly & 1) * 2 + (lx & 1)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (down, assemble, q[None, :] * 512 + idx_oct))


def restrict(level: Level, fine):
    down, assemble, _ = _lane_tables(fine.device)
    s = fine + torch.roll(fine, -1, 1)
    s = s + torch.roll(s, -8, 1)
    s = s + torch.roll(s, -64, 1)
    avg = s[:, down] * 0.125
    Tc = level.children.shape[0]
    return avg.index_select(0, level.children.reshape(-1)).reshape(Tc, 512)[:, assemble]


def prolong(level: Level, coarse):
    """Trilinear: the 8 parity combinations on the coarse grid, then each
    fine tile reads its octant of its parent's."""
    f = coarse[None]
    for axis in range(3):
        lo = 0.75 * f + 0.25 * ops.face(level.topo.nbr, f, tuple(-1 if a == axis else 0
                                                                  for a in range(3)))
        hi = 0.75 * f + 0.25 * ops.face(level.topo.nbr, f, tuple(1 if a == axis else 0
                                                                 for a in range(3)))
        f = torch.cat([lo, hi], 0)
    stacked = f.permute(1, 0, 2).reshape(coarse.shape[0], 8 * 512)
    idx = _lane_tables(coarse.device)[2]
    out = torch.zeros((level.parent.shape[0], 512), dtype=coarse.dtype, device=coarse.device)
    for o in range(8):
        out = torch.where(level.octant[:, None] == o,
                          stacked[:, idx[o]].index_select(0, level.parent), out)
    return out


def v_cycle(topo: Topo, levels: list, div, p, dx: float, omega: float, n_pre: int,
            n_post: int, n_coarsest: int, mask=None):
    if not levels:
        return ops.solve_pressure(topo.nbr, div, n_coarsest, dx, omega, p0=p, mask=mask,
                                  pair_blocks=True)
    lvl = levels[0]
    p = ops.solve_pressure(topo.nbr, div, n_pre, dx, omega, p0=p, mask=mask, pair_blocks=True)
    r = ops.residual(topo.nbr, p, div, dx)
    if mask is not None:
        r = r * mask
    rc = restrict(lvl, r) * lvl.mask
    ec = v_cycle(lvl.topo, levels[1:], rc, torch.zeros_like(rc), dx * 2.0, omega, n_pre,
                 n_post, n_coarsest, lvl.mask)
    p = p + prolong(lvl, ec)
    return ops.solve_pressure(topo.nbr, div, n_post, dx, omega, p0=p, mask=mask,
                              pair_blocks=True)


def solve(topo: Topo, levels: list, div, cycles: int, dx: float, omega: float, n_pre: int,
          n_post: int, n_coarsest: int, fmg: bool):
    """``cycles`` V-cycles from the full-multigrid start (``fmg``) or zero."""
    kw = dict(n_pre=n_pre, n_post=n_post, n_coarsest=n_coarsest)
    if fmg and levels:
        divs = [div]
        for lvl in levels:
            divs.append(restrict(lvl, divs[-1]) * lvl.mask)
        last = levels[-1]
        p = ops.solve_pressure(last.topo.nbr, divs[-1], n_coarsest, dx * 2.0 ** len(levels),
                               omega, mask=last.mask)
        for k in reversed(range(len(levels))):
            p = prolong(levels[k], p)
            t_k = topo if k == 0 else levels[k - 1].topo
            m_k = None if k == 0 else levels[k - 1].mask
            if m_k is not None:
                p = p * m_k
            p = v_cycle(t_k, levels[k:], divs[k], p, dx * 2.0 ** k, omega, mask=m_k, **kw)
    else:
        p = torch.zeros_like(div)
    for _ in range(cycles):
        p = v_cycle(topo, levels, div, p, dx, omega, **kw)
    return p
