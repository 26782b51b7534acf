"""Geometric multigrid pressure solver on the sparse tile hierarchy, one
device. Counterpart of ``hnanosolver_tpu/ops/multigrid.py``:

- Level k+1 tiles are the unique ``tile_coord >> 1`` of level k: each
  coarse 8^3 tile covers a 2x2x2 block of fine tiles, so restriction and
  prolongation are row gathers plus fixed lane permutations.
- Restriction: 2x2x2 averaging. Prolongation: trilinear (cell-centred) by
  default, piecewise-constant injection as ``prolong``.
- Restriction and trilinear prolongation are one launch a level each, the
  kernels MR and MP (``ops/cuda_transfer.py``), with the level's masks and
  the correction's add fused; ``restrict_plain`` and
  ``prolong_trilinear_plain`` are their plain versions (on a CPU tensor the
  wrappers run them). Injection ``prolong`` stays plain.
- Smoother and coarsest solve: ``ops/pressure.solve_pressure`` (kernels
  B3, B4, B5 by level size), residual: kernel B6.
- Traced (``utils/profiling``), every restriction and prolongation is a
  device span ``mg.restrict`` / ``mg.prolong`` whose ``level`` is the
  coarse level it restricts to or prolongs from (1 the first below the
  fine level).
- Each coarse level carries an in-domain voxel mask restricted from the
  fine domain (mode "all" by default: a coarse voxel is in the domain when
  all of its 2^3 fine voxels are).

The hierarchy is built in host numpy and moved to the fine topology's
device once.

The sharded step (``parallel/slab.py``) shards only the fine level and
replicates the coarse levels on every device, through three hooks in the
JAX package's places: ``refresh`` (the ghost exchange, in the fine-level
smoothers and before the fine residual; the smoothers then run textbook
colour sweeps), ``coarse_reduce`` (sums the devices' partial level-1
restrictions of their owned rows) and ``tol_reduce`` (the mesh-wide
``max|.|`` of the ``tol`` stop, so that every device stops on the same
cycle).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import List

import numpy as np
import torch

from hnanosolver_tpu_torch.core import coords as C
from hnanosolver_tpu_torch.core.topology import Topology, build_topology
from hnanosolver_tpu_torch.ops import cuda_transfer as ct
from hnanosolver_tpu_torch.ops import pressure as prs
from hnanosolver_tpu_torch.ops import shifts as sh
from hnanosolver_tpu_torch.utils.profiling import span


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


_LANES: dict = {}
_LANES_LOCK = threading.Lock()  # the sharded step's threads build them once


def _lanes(device: torch.device):
    """The lane tables as int64 tensors on ``device`` (built once per
    device: (down [64], assemble [512], oct [8,512], oct_q [8,512]))."""
    with _LANES_LOCK:
        if device not in _LANES:
            _LANES[device] = tuple(
                torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(device)
                for a in _lane_tables())
        return _LANES[device]


def restrict(level: MGLevel, fine: torch.Tensor, fine_mask: torch.Tensor | None = None,
             coarse_mask: torch.Tensor | None = None) -> torch.Tensor:
    """[Tf,512] -> [Tc,512]: :func:`restrict_plain` of ``fine * fine_mask``,
    times ``coarse_mask`` (each mask where given), one launch of MR on a
    CUDA tensor."""
    return ct.restrict(level.children, fine, fine_mask, coarse_mask)


def restrict_plain(level: MGLevel, fine: torch.Tensor) -> torch.Tensor:
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


def prolong(level: MGLevel, coarse: torch.Tensor,
            fine_capacity: int | None = None) -> torch.Tensor:
    """[Tc,512] -> [Tf,512]: each fine tile's 4^3 octant of its parent,
    upsampled 2x (piecewise constant). ``fine_capacity`` (the JAX
    package's parameter) is not needed: ``level.parent`` has Tf rows."""
    return _land(level, coarse, _lanes(coarse.device)[2])


def prolong_trilinear(level: MGLevel, coarse: torch.Tensor, p: torch.Tensor | None = None,
                      mask: torch.Tensor | None = None) -> torch.Tensor:
    """[Tc,512] -> [Tf,512]: ``p`` + :func:`prolong_trilinear_plain` of
    ``coarse``, times ``mask`` (``p`` and the mask where given), one launch
    of MP on a CUDA tensor."""
    return ct.prolong_trilinear(level.parent, level.octant, level.topo.nbr, coarse, p, mask)


def prolong_trilinear_plain(level: MGLevel, coarse: torch.Tensor) -> torch.Tensor:
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
    refresh=None,
    coarse_reduce=None,
    smooth_lag: bool | str = "pair",
    level: int = 0,
) -> torch.Tensor:
    """One V-cycle recursing down ``hierarchy``. ``mask`` is THIS level's
    in-domain voxel mask (None at the fine level); ``level`` is this level's
    depth (0 the fine one), the ``level`` attribute of the transfers' spans.

    ``smooth_lag``: the smoothers' halo granularity above MAX_FUSED_ROWS
    tiles: "pair" (default) one lagged B3 block per red+black pair; True
    one block of ``n_pre`` (``n_post``) pairs per smoothing call; False
    textbook per-colour sweeps (B4). ``refresh`` (this level's ghost
    exchange) makes the smoothers textbook with a refresh before each
    colour sweep, and runs before the residual; ``coarse_reduce`` combines
    the level-1 restriction. Neither goes down to the coarse levels."""
    if refresh is not None or not smooth_lag:
        lag = {}
    elif smooth_lag == "pair":
        lag = {"pair_blocks": True}
    else:
        lag = {"halo_lag": n_pre}
    if not hierarchy:
        # the coarsest call is a solve, not a smoother: halos stay fresh
        # (pair granularity, or lag 4 in the True mode)
        if refresh is None and smooth_lag == "pair":
            ck = {"pair_blocks": True}
        elif refresh is None and smooth_lag is True and n_coarsest % 4 == 0:
            ck = {"halo_lag": 4}
        else:
            ck = {}
        return prs.solve_pressure(topo, div, n_coarsest, dx, omega, p0=p, mask=mask,
                                  refresh=refresh, **ck)
    lvl = hierarchy[0]
    p = prs.solve_pressure(topo, div, n_pre, dx, omega, p0=p, mask=mask, refresh=refresh,
                           **lag)
    if refresh is not None:
        p = refresh(p)
    r = prs.residual(topo, p, div, dx)
    # r * mask and rc * lvl.mask fused into the restriction, but for the
    # sharded step's coarse_reduce, which sums the devices' partial
    # restrictions before the mask: there the mask stays after the sum
    with span("mg.restrict", device=True, level=level + 1):
        rc = restrict(lvl, r, mask, lvl.mask if coarse_reduce is None else None)
    if coarse_reduce is not None:
        rc = coarse_reduce(rc) * lvl.mask
    ec = v_cycle(lvl.topo, hierarchy[1:], rc, torch.zeros_like(rc), dx * 2.0, omega,
                 n_pre, n_post, n_coarsest, prolongation, lvl.mask, smooth_lag=smooth_lag,
                 level=level + 1)
    with span("mg.prolong", device=True, level=level + 1):
        p = (prolong_trilinear(lvl, ec, p) if prolongation == "trilinear"
             else p + prolong(lvl, ec))
    if lag.get("halo_lag") is not None:
        lag["halo_lag"] = n_post
    return prs.solve_pressure(topo, div, n_post, dx, omega, p0=p, mask=mask, refresh=refresh,
                              **lag)


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
    refresh=None,
    coarse_reduce=None,
) -> torch.Tensor:
    """Full-multigrid (nested-iteration) initial guess: restrict the RHS to
    every level, solve the coarsest, then per level prolong the solution up
    and refine it with one V-cycle at that level. Sharded, the level-0 to 1
    restriction goes through ``coarse_reduce`` and only the last (fine)
    V-cycle takes ``refresh``; the prolongation to level 0 needs no
    refresh (each device's parent map covers its ghost rows, and the
    coarse solution is replicated)."""
    divs = [div]
    for i, lvl in enumerate(hierarchy):
        reduce = coarse_reduce if i == 0 else None  # the mask after it, as in v_cycle
        with span("mg.restrict", device=True, level=i + 1):
            r = restrict(lvl, divs[-1], coarse_mask=lvl.mask if reduce is None else None)
        divs.append(r if reduce is None else reduce(r) * lvl.mask)
    last = hierarchy[-1]
    p = prs.solve_pressure(last.topo, divs[-1], n_coarsest, dx * (2.0 ** len(hierarchy)),
                           omega, mask=last.mask)
    for k in reversed(range(len(hierarchy))):
        lvl = hierarchy[k]
        t_k = topo if k == 0 else hierarchy[k - 1].topo
        m_k = None if k == 0 else hierarchy[k - 1].mask
        with span("mg.prolong", device=True, level=k + 1):
            if prolongation == "trilinear":
                p = prolong_trilinear(lvl, p, mask=m_k)
            else:
                p = prolong(lvl, p)
                if m_k is not None:
                    p = p * m_k
        p = v_cycle(t_k, hierarchy[k:], divs[k], p, dx * (2.0 ** k), omega,
                    n_pre, n_post, n_coarsest, prolongation, m_k,
                    refresh=refresh if k == 0 else None,
                    coarse_reduce=coarse_reduce if k == 0 else None,
                    smooth_lag=smooth_lag, level=k)
    return p


def solve_pressure_mg(
    topo: Topology,
    hierarchy: List[MGLevel],
    div: torch.Tensor,
    cycles: int,
    dx: float,
    omega: float = 1.0,
    tol: float | None = None,
    refresh=None,
    coarse_reduce=None,
    fmg: bool = False,
    tol_reduce=None,
    **kw,
) -> torch.Tensor:
    """``cycles`` V-cycles from a zero initial guess (or the FMG guess with
    ``fmg=True``). With ``tol`` set, cycling stops once ``max|r| <= tol *
    max|div|`` (``cycles`` is then the cap); the test reads one scalar back
    to the host per cycle. ``tol_reduce(field) -> scalar tensor`` replaces
    ``max|.|`` in that test (sharded: the mesh-wide max over owned rows,
    the same on every device); ``refresh`` runs before each residual."""
    kw["refresh"] = refresh
    kw["coarse_reduce"] = coarse_reduce
    if fmg and hierarchy:
        p = fmg_initial_guess(
            topo, hierarchy, div, dx, omega,
            n_pre=kw.get("n_pre", 2), n_post=kw.get("n_post", 2),
            n_coarsest=kw.get("n_coarsest", 24),
            prolongation=kw.get("prolongation", "trilinear"),
            smooth_lag=kw.get("smooth_lag", "pair"),
            refresh=refresh, coarse_reduce=coarse_reduce,
        )
    else:
        p = torch.zeros_like(div)
    if tol is None:
        for _ in range(cycles):
            p = v_cycle(topo, hierarchy, div, p, dx, omega, **kw)
        return p

    if tol_reduce is None:
        def tol_reduce(a):
            return a.abs().max()
    limit = tol * torch.clamp(tol_reduce(div), min=1e-30)

    def above_tol(p) -> bool:
        pr = refresh(p) if refresh is not None else p
        return bool(tol_reduce(prs.residual(topo, pr, div, dx)) > limit)

    i = 0
    while i < cycles and above_tol(p):
        p = v_cycle(topo, hierarchy, div, p, dx, omega, **kw)
        i += 1
    return p
