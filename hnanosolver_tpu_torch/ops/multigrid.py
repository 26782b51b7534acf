"""Geometric multigrid pressure solver on the sparse tile hierarchy, one
device. Counterpart of ``hnanosolver_tpu/ops/multigrid.py``:

- Level k+1 tiles are the unique ``tile_coord >> 1`` of level k: each
  coarse 8^3 tile covers a 2x2x2 block of fine tiles, so restriction and
  prolongation are row gathers plus fixed lane permutations.
- Restriction: 2x2x2 averaging. Prolongation: trilinear (cell-centred) by
  default, piecewise-constant injection as ``prolong``.
- Smoother and coarsest solve: ``ops/pressure.solve_pressure`` (kernels
  B3, B4, B5 by level size), residual: kernel B6.
- Each coarse level carries an in-domain voxel mask restricted from the
  fine domain (mode "all" by default: a coarse voxel is in the domain when
  all of its 2^3 fine voxels are).

The hierarchy is built in host numpy and moved to the fine topology's
device once. The JAX package's sharded hooks (``refresh``,
``coarse_reduce``, ``tol_reduce``) belong to the multi-GPU port and are not
here.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List

import numpy as np
import torch

from hnanosolver_tpu_torch.core import coords as C
from hnanosolver_tpu_torch.core.topology import Topology, build_topology
from hnanosolver_tpu_torch.ops import pressure as prs
from hnanosolver_tpu_torch.ops import shifts as sh


@dataclasses.dataclass(frozen=True)
class MGLevel:
    """One coarse level: its topology plus child/parent row maps."""

    topo: Topology
    children: torch.Tensor  # [Tc, 8] fine-level rows per octant (0 = absent)
    parent: torch.Tensor  # [Tf] coarse-level row of each fine tile (0 = none)
    octant: torch.Tensor  # [Tf] in {0..7}: (tx&1)*4 + (ty&1)*2 + (tz&1)
    mask: torch.Tensor  # [Tc, 512] f32: 1 where the coarse voxel is in the domain


def _restrict_mask_np(children: np.ndarray, fine_mask: np.ndarray,
                      mode: str = "any") -> np.ndarray:
    """Coarse in-domain mask restricted from the fine level's mask with a
    min ("all") or max ("any") over each 2x2x2 block."""
    Tf = fine_mask.shape[0]
    red = np.max if mode == "any" else np.min
    m = red(fine_mask.reshape(Tf, 4, 2, 4, 2, 4, 2), axis=(2, 4, 6))
    Tc = children.shape[0]
    ch = m[children.reshape(-1)].reshape(Tc, 2, 2, 2, 4, 4, 4)
    out = np.moveaxis(ch, (1, 2, 3), (1, 3, 5))  # [Tc, 2,4, 2,4, 2,4]
    return out.reshape(Tc, 512)


def build_hierarchy(topo: Topology, levels: int,
                    mask_mode: str = "all") -> List[MGLevel]:
    """``levels`` coarse levels below ``topo``, built in host numpy and put
    on ``topo``'s device."""
    dev = topo.device
    out: List[MGLevel] = []
    nf = int(topo.n_active)
    fo = topo.origins[1 : nf + 1].cpu().numpy()  # fine tile coords
    fine_cap = topo.capacity
    fine_mask = np.zeros((fine_cap, 512), np.float32)
    fine_mask[1 : nf + 1] = 1.0  # fine active tiles are fully in-domain
    for _ in range(levels):
        co = fo >> 1
        coarse = build_topology(co, device=dev)
        nc = int(coarse.n_active)
        ckeys = coarse.keys[1 : nc + 1].cpu().numpy()

        # parent row per fine tile
        prow = (np.searchsorted(ckeys, C.pack_keys_np(co)) + 1).astype(np.int32)
        parent = np.zeros(fine_cap, np.int32)
        parent[1 : nf + 1] = prow
        oct_ = np.zeros(fine_cap, np.int32)
        oct_[1 : nf + 1] = (fo[:, 0] & 1) * 4 + (fo[:, 1] & 1) * 2 + (fo[:, 2] & 1)

        # children rows per coarse tile
        children = np.zeros((coarse.capacity, 8), np.int32)
        children[prow, oct_[1 : nf + 1]] = np.arange(1, nf + 1, dtype=np.int32)

        mask = _restrict_mask_np(children, fine_mask, mask_mode)
        out.append(MGLevel(
            topo=coarse,
            children=torch.from_numpy(children).to(dev),
            parent=torch.from_numpy(parent).to(dev),
            octant=torch.from_numpy(oct_).to(dev),
            mask=torch.from_numpy(mask).to(dev),
        ))
        fo = C.unpack_keys_np(ckeys)
        nf, fine_cap, fine_mask = nc, coarse.capacity, mask
    return out


def hierarchy_for(topo: Topology, params) -> tuple:
    """The hierarchy tuple ``solver.step`` expects for ``params``: empty for
    the RBGS solver, ``params.mg_levels`` coarse levels for "mg". Call
    after every topology (re)build."""
    if params.pressure_solver != "mg":
        return ()
    return tuple(build_hierarchy(topo, params.mg_levels))


# ---------------------------------------------------------------------------
# Transfer operators: fixed lane permutations over [T, 512] rows (the JAX
# package's lane tables, so both packages move the same values).
# ---------------------------------------------------------------------------

def _lane_tables():
    lane = np.arange(512)
    lx, ly, lz = lane // 64, (lane // 8) % 8, lane % 8
    # restrict: the 64 even-corner lanes holding each 2x2x2 block sum
    down = np.asarray([128 * a + 16 * b + 2 * c
                       for a in range(4) for b in range(4) for c in range(4)])
    # restrict: from octant-major [o*64 + k] to the coarse flat lane
    o = (lx // 4) * 4 + (ly // 4) * 2 + (lz // 4)
    k = (lx % 4) * 16 + (ly % 4) * 4 + (lz % 4)
    assemble = o * 64 + k
    # prolongation: per fine-tile octant o, the parent lane covering lane l
    octs = np.arange(8)[:, None]
    ox, oy, oz = (octs >> 2) & 1, (octs >> 1) & 1, octs & 1
    idx_oct = (ox * 4 + lx // 2) * 64 + (oy * 4 + ly // 2) * 8 + (oz * 4 + lz // 2)
    # trilinear: parity-field index q = pz*4 + py*2 + px per lane, combined
    # with the octant lane into one index over the [8, 512] lane space
    q = (lz & 1) * 4 + (ly & 1) * 2 + (lx & 1)
    return down, assemble, idx_oct, q[None, :] * 512 + idx_oct


@functools.lru_cache(maxsize=None)
def _lanes(device: torch.device):
    """The lane tables as int64 tensors on ``device`` (built once per
    device: (down [64], assemble [512], oct [8,512], oct_q [8,512]))."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(device)
                 for a in _lane_tables())


def restrict(level: MGLevel, fine: torch.Tensor) -> torch.Tensor:
    """[Tf,512] -> [Tc,512]: average 2x2x2 fine voxels, assemble the 8
    child tiles into the coarse tile's octants."""
    down_l, assemble, _, _ = _lanes(fine.device)
    Tc = level.children.shape[0]
    # pairwise sums along z, y, x via lane rolls; the wrap garbage lands on
    # odd lanes, which the even-corner selection never reads
    s = fine + torch.roll(fine, -1, 1)
    s = s + torch.roll(s, -8, 1)
    s = s + torch.roll(s, -64, 1)
    down = s[:, down_l] * 0.125  # [Tf, 64]
    ch = down.index_select(0, level.children.reshape(-1)).reshape(Tc, 512)
    return ch[:, assemble]


# Above this many bytes for the [Tc*8, 512] octant-expanded coarse array,
# prolongation takes the 8-pass sequential form (lower peak memory).
PROLONG_MERGE_BUDGET = 1 * 1024**3


def _land(level: MGLevel, src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Each fine tile's octant view of its parent: ``src [Tc, W]`` lanes
    ``idx [8, 512]`` (per octant) gathered to ``[Tf, 512]``."""
    Tc = src.shape[0]
    if Tc * 8 * 512 * 4 <= PROLONG_MERGE_BUDGET:
        # merged: one lane permutation expands to all 8 octant views
        # [Tc*8, 512], one row gather (parent*8 + octant) lands every tile
        sel = src[:, idx.reshape(-1)].reshape(Tc * 8, 512)
        return sel.index_select(0, level.parent * 8 + level.octant)
    out = torch.zeros((level.parent.shape[0], 512), dtype=src.dtype, device=src.device)
    oct_ = level.octant[:, None]
    for o in range(8):
        cand = src[:, idx[o]].index_select(0, level.parent)
        out = torch.where(oct_ == o, cand, out)
    return out


def prolong(level: MGLevel, coarse: torch.Tensor) -> torch.Tensor:
    """[Tc,512] -> [Tf,512]: each fine tile's 4^3 octant of its parent,
    upsampled 2x (piecewise constant)."""
    return _land(level, coarse, _lanes(coarse.device)[2])


def prolong_trilinear(level: MGLevel, coarse: torch.Tensor) -> torch.Tensor:
    """[Tc,512] -> [Tf,512]: trilinear (cell-centred) interpolation of the
    coarse correction at fine voxel centres. A fine voxel at an even (odd)
    index along an axis sits at coarse offset -0.25 (+0.25): weights 0.75
    on its parent cell and 0.25 on the -1 (+1) coarse neighbour. The 8
    parity combinations are evaluated on the coarse grid, then each fine
    tile reads its parent's octant of them. Out-of-domain coarse reads are
    0 (Dirichlet)."""
    fields = coarse[None]  # [1, Tc, 512]
    for axis in range(3):
        off_m = tuple(-1 if a == axis else 0 for a in range(3))
        off_p = tuple(+1 if a == axis else 0 for a in range(3))
        lo = 0.75 * fields + 0.25 * sh.shifted_view(level.topo, fields, off_m)
        hi = 0.75 * fields + 0.25 * sh.shifted_view(level.topo, fields, off_p)
        fields = torch.cat([lo, hi], 0)
    # stacking order: axis-k parity lands in bit k => index q = pz*4+py*2+px
    Tc = coarse.shape[0]
    stacked = fields.permute(1, 0, 2).reshape(Tc, 8 * 512)
    return _land(level, stacked, _lanes(coarse.device)[3])


def v_cycle(
    topo: Topology,
    hierarchy: List[MGLevel],
    div: torch.Tensor,
    p: torch.Tensor,
    dx: float,
    omega: float,
    n_pre: int = 2,
    n_post: int = 2,
    n_coarsest: int = 24,
    prolongation: str = "trilinear",
    mask: torch.Tensor | None = None,
    smooth_lag: bool | str = "pair",
) -> torch.Tensor:
    """One V-cycle recursing down ``hierarchy``. ``mask`` is THIS level's
    in-domain voxel mask (None at the fine level).

    ``smooth_lag``: the smoothers' halo granularity above MAX_FUSED_ROWS
    tiles: "pair" (default) one lagged B3 block per red+black pair; True
    one block of ``n_pre`` (``n_post``) pairs per smoothing call; False
    textbook per-colour sweeps (B4)."""
    if not smooth_lag:
        lag = {}
    elif smooth_lag == "pair":
        lag = {"pair_blocks": True}
    else:
        lag = {"halo_lag": n_pre}
    if not hierarchy:
        # the coarsest call is a solve, not a smoother: halos stay fresh
        # (pair granularity, or lag 4 in the True mode)
        if smooth_lag == "pair":
            ck = {"pair_blocks": True}
        elif smooth_lag is True and n_coarsest % 4 == 0:
            ck = {"halo_lag": 4}
        else:
            ck = {}
        return prs.solve_pressure(topo, div, n_coarsest, dx, omega, p0=p, mask=mask, **ck)
    lvl = hierarchy[0]
    p = prs.solve_pressure(topo, div, n_pre, dx, omega, p0=p, mask=mask, **lag)
    r = prs.residual(topo, p, div, dx)
    if mask is not None:
        r = r * mask
    rc = restrict(lvl, r) * lvl.mask
    ec = v_cycle(lvl.topo, hierarchy[1:], rc, torch.zeros_like(rc), dx * 2.0, omega,
                 n_pre, n_post, n_coarsest, prolongation, lvl.mask, smooth_lag=smooth_lag)
    if prolongation == "trilinear":
        p = p + prolong_trilinear(lvl, ec)
    else:
        p = p + prolong(lvl, ec)
    if lag.get("halo_lag") is not None:
        lag["halo_lag"] = n_post
    return prs.solve_pressure(topo, div, n_post, dx, omega, p0=p, mask=mask, **lag)


def fmg_initial_guess(
    topo: Topology,
    hierarchy: List[MGLevel],
    div: torch.Tensor,
    dx: float,
    omega: float,
    n_pre: int = 2,
    n_post: int = 2,
    n_coarsest: int = 24,
    prolongation: str = "trilinear",
    smooth_lag: bool | str = "pair",
) -> torch.Tensor:
    """Full-multigrid (nested-iteration) initial guess: restrict the RHS to
    every level, solve the coarsest, then per level prolong the solution up
    and refine it with one V-cycle at that level."""
    divs = [div]
    for lvl in hierarchy:
        divs.append(restrict(lvl, divs[-1]) * lvl.mask)
    last = hierarchy[-1]
    p = prs.solve_pressure(last.topo, divs[-1], n_coarsest, dx * (2.0 ** len(hierarchy)),
                           omega, mask=last.mask)
    for k in reversed(range(len(hierarchy))):
        lvl = hierarchy[k]
        p = prolong_trilinear(lvl, p) if prolongation == "trilinear" else prolong(lvl, p)
        t_k = topo if k == 0 else hierarchy[k - 1].topo
        m_k = None if k == 0 else hierarchy[k - 1].mask
        if m_k is not None:
            p = p * m_k
        p = v_cycle(t_k, hierarchy[k:], divs[k], p, dx * (2.0 ** k), omega,
                    n_pre, n_post, n_coarsest, prolongation, m_k, smooth_lag=smooth_lag)
    return p


def solve_pressure_mg(
    topo: Topology,
    hierarchy: List[MGLevel],
    div: torch.Tensor,
    cycles: int,
    dx: float,
    omega: float = 1.0,
    tol: float | None = None,
    fmg: bool = False,
    **kw,
) -> torch.Tensor:
    """``cycles`` V-cycles from a zero initial guess (or the FMG guess with
    ``fmg=True``). With ``tol`` set, cycling stops once ``max|r| <= tol *
    max|div|`` (``cycles`` is then the cap); the test reads one scalar back
    to the host per cycle."""
    if fmg and hierarchy:
        p = fmg_initial_guess(
            topo, hierarchy, div, dx, omega,
            n_pre=kw.get("n_pre", 2), n_post=kw.get("n_post", 2),
            n_coarsest=kw.get("n_coarsest", 24),
            prolongation=kw.get("prolongation", "trilinear"),
            smooth_lag=kw.get("smooth_lag", "pair"),
        )
    else:
        p = torch.zeros_like(div)
    if tol is None:
        for _ in range(cycles):
            p = v_cycle(topo, hierarchy, div, p, dx, omega, **kw)
        return p

    limit = tol * torch.clamp(div.abs().max(), min=1e-30)

    def above_tol(p) -> bool:
        return bool(prs.residual(topo, p, div, dx).abs().max() > limit)

    i = 0
    while i < cycles and above_tol(p):
        p = v_cycle(topo, hierarchy, div, p, dx, omega, **kw)
        i += 1
    return p
