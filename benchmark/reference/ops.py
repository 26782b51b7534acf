"""The plain operators of one plume step on the tile layout, in any float
dtype: trilinear samples, the BFECC advection and its limiter, divergence,
u - grad p, the residual, red-black SOR (lagged-halo blocks, textbook
sweeps) and the pressure solve's choice between them, combustion and
buoyancy.

A field is ``[..., T, 512]`` over the rows of a :class:`topology.Topo`;
lane ``x*64 + y*8 + z`` is the voxel (x, y, z) of its tile. Reads through
an absent neighbour return the null row's zeros (Dirichlet 0 outside the
domain). The operators follow the solver's published numerics (HNanoSolver's
MacCormack/BFECC advection, ``reference/src``'s red-black SOR with the
truncated pi in omega, and the tile packages' lagged halo every
``halo_lag`` pairs); written for this benchmark from that description, in
the op order of the solver's plain versions. The samplers and the limiter
work on blocks of ``ROWS`` rows so that a 1024^3 domain fits the card in
float64.
"""

from __future__ import annotations

import torch

from .topology import TILE

ROWS = 16384  # tile rows a block of the samplers and the limiter
DISP_LIMIT = 7.0 - 1e-3  # largest displacement a trace takes, voxels an axis
MAX_SCALARS = 8  # scalars advected together (each batch traces again)
MAX_FUSED_ROWS = 2048  # at most this many rows, the textbook solve
FUEL_THRESHOLD = 0.001
# face direction -> (axis, boundary lane coordinate, in-tile roll, roll of
# the neighbour's row); torch.roll(f, s, -1)[lane] == f[lane - s]
DIRS = {
    (1, 0, 0): (0, 7, -64, 448), (-1, 0, 0): (0, 0, 64, -448),
    (0, 1, 0): (1, 7, -8, 56), (0, -1, 0): (1, 0, 8, -56),
    (0, 0, 1): (2, 7, -1, 7), (0, 0, -1): (2, 0, 1, -7),
}
AXES = (((1, 0, 0), (-1, 0, 0)), ((0, 1, 0), (0, -1, 0)), ((0, 0, 1), (0, 0, -1)))


def lanes(device):
    """(x, y, z) of each lane, three [512] int64 tensors."""
    c = torch.arange(TILE, device=device)
    return c // 64, (c // 8) % 8, c % 8


def nbr_col(off) -> int:
    return (off[0] + 1) * 9 + (off[1] + 1) * 3 + (off[2] + 1)


def blocks(T: int):
    for r0 in range(0, T, ROWS):
        yield slice(r0, min(T, r0 + ROWS))


def face(nbr, f, off, rows=slice(None)):
    """``f [..., T, 512]`` one voxel along ``off``, on ``rows``."""
    axis, at, s_in, s_fix = DIRS[off]
    n = f.index_select(-2, nbr[rows, nbr_col(off)])
    edge = lanes(f.device)[axis] == at
    return torch.where(edge, torch.roll(n, s_fix, -1), torch.roll(f[..., rows, :], s_in, -1))


def neighbor_sum(nbr, p):
    v = [face(nbr, p, off) for off in DIRS]
    return v[0] + v[1] + v[2] + v[3] + v[4] + v[5]


def sample(nbr_rows, fields, d):
    """Trilinear samples of ``fields [n, T, 512]`` at x + d for the rows of
    ``nbr_rows [B, 27]`` (``d [3, B, 512]``, within DISP_LIMIT): the
    corners' weights (wx*wy)*wz summed in (i, j, k) order."""
    n = fields.shape[0]
    flat = fields.reshape(n, -1)
    cx, cy, cz = lanes(d.device)
    lx, ly, lz = cx.to(d.dtype) + d[0], cy.to(d.dtype) + d[1], cz.to(d.dtype) + d[2]
    bx, by, bz = torch.floor(lx), torch.floor(ly), torch.floor(lz)
    fx, fy, fz = lx - bx, ly - by, lz - bz
    ix, iy, iz = 1.0 - fx, 1.0 - fy, 1.0 - fz
    bx, by, bz = bx.long(), by.long(), bz.long()
    acc = None
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                qx, qy, qz = bx + di, by + dj, bz + dk
                col = ((qx + 8) >> 3) * 9 + ((qy + 8) >> 3) * 3 + ((qz + 8) >> 3)
                row = torch.gather(nbr_rows, 1, col)
                idx = row * TILE + ((qx & 7) * 64 + (qy & 7) * 8 + (qz & 7))
                w = (fx if di else ix) * (fy if dj else iy) * (fz if dk else iz)
                v = flat[:, idx.reshape(-1)].reshape(n, *idx.shape) * w
                acc = v if acc is None else acc + v
    return acc


def bfecc(nbr, fields, sdt: float, f_lo: int):
    """BFECC of ``fields[f_lo:]`` (rows 0..2 of ``fields`` the tracing
    velocity): back-trace d = clamp(-u sdt), phiF = phi(x + d), re-trace d2
    = clamp(d + u(x + d) sdt), phiB = phi(x + d2), then clip(phiF + (phi -
    phiB) / 2) to the min/max over phi, its six faces and phiF."""
    phi0 = fields[f_lo:]
    out = torch.empty_like(phi0)
    for rows in blocks(fields.shape[1]):
        nb = nbr[rows]
        d = torch.clamp(-fields[:3, rows] * sdt, -DISP_LIMIT, DISP_LIMIT)
        back = sample(nb, fields, d)
        d2 = torch.clamp(d + back[:3] * sdt, -DISP_LIMIT, DISP_LIMIT)
        pf, pb = back[f_lo:], sample(nb, phi0, d2)
        views = torch.stack([face(nbr, phi0, off, rows) for off in DIRS])
        p0 = phi0[:, rows]
        lo = torch.minimum(torch.minimum(p0, pf), views.amin(0))
        hi = torch.maximum(torch.maximum(p0, pf), views.amax(0))
        out[:, rows] = torch.clamp(pf + 0.5 * (p0 - pb), lo, hi)
    return out


def advect_velocity(nbr, vel, dt: float, inv_dx: float):
    return bfecc(nbr, vel, dt * inv_dx, 0)


def advect_scalars(nbr, vel, scalars: dict, dt: float, inv_dx: float) -> dict:
    """Every scalar by ``vel``, in sorted-name batches of MAX_SCALARS."""
    names = sorted(scalars)
    phi = torch.stack([scalars[k] for k in names])
    outs = [bfecc(nbr, torch.cat([vel, phi[i:i + MAX_SCALARS]]), dt * inv_dx, 3)
            for i in range(0, len(names), MAX_SCALARS)]
    out = torch.cat(outs)
    return {k: out[i] for i, k in enumerate(names)}


def divergence(nbr, vel, inv_dx: float):
    acc = None
    for a, (op, om) in enumerate(AXES):
        term = face(nbr, vel[a], op) - face(nbr, vel[a], om)
        acc = term if acc is None else acc + term
    return acc * (0.5 * inv_dx)


def subtract_gradient(nbr, vel, p, inv_dx: float):
    grad = torch.stack([face(nbr, p, op) - face(nbr, p, om) for op, om in AXES])
    return vel - grad * (0.5 * inv_dx)


def residual(nbr, p, div, dx: float):
    return div - (neighbor_sum(nbr, p) - 6.0 * p) / (dx * dx)


def _updates(colour: int, mask, device):
    cx, cy, cz = lanes(device)
    upd = ((cx + cy + cz) & 1) == colour
    return upd if mask is None else upd & (mask > 0)


def sor_sweep(nbr, p, div, colour: int, omega: float, dx2: float, mask=None):
    """One textbook half-sweep of ``colour``, every face from the current p."""
    pgs = (neighbor_sum(nbr, p) - div * dx2) * (1.0 / 6.0)
    return torch.where(_updates(colour, mask, p.device), p + omega * (pgs - p), p)


def sor_lagged(nbr, p, div, pairs: int, omega: float, dx2: float, mask=None):
    """``pairs`` red+black pairs whose cross-tile faces stay those of the
    input p (the lagged halo); in-tile faces are current."""
    fixes = [torch.roll(p.index_select(0, nbr[:, nbr_col(off)]), DIRS[off][3], -1)
             for off in DIRS]
    edges = [lanes(p.device)[DIRS[off][0]] == DIRS[off][1] for off in DIRS]
    upd = [_updates(c, mask, p.device) for c in (0, 1)]
    rhs = div * dx2
    for _ in range(pairs):
        for c in (0, 1):
            v = [torch.where(e, fx, torch.roll(p, DIRS[off][2], -1))
                 for off, e, fx in zip(DIRS, edges, fixes)]
            pgs = (v[0] + v[1] + v[2] + v[3] + v[4] + v[5] - rhs) * (1.0 / 6.0)
            p = torch.where(upd[c], p + omega * (pgs - p), p)
    return p


def solve_pressure(nbr, div, iterations: int, dx: float, omega: float, p0=None, mask=None,
                   halo_lag: int = 1, pair_blocks: bool = False):
    """``iterations`` red+black pairs from p0 (zeros). At most
    MAX_FUSED_ROWS rows: textbook sweeps; above: ``iterations // halo_lag``
    lagged blocks (of one pair each with ``pair_blocks``), then the
    remainder as textbook sweeps."""
    dx2 = dx * dx
    p = torch.zeros_like(div) if p0 is None else p0
    if div.shape[0] <= MAX_FUSED_ROWS:
        if mask is not None:
            p = torch.where(mask > 0, p, 0.0)
        for _ in range(iterations):
            for c in (0, 1):
                p = sor_sweep(nbr, p, div, c, omega, dx2, mask)
        return p
    if mask is not None:
        p = p * mask
    blocks_ = iterations // halo_lag if (halo_lag > 1 or pair_blocks) else 0
    for _ in range(blocks_):
        p = sor_lagged(nbr, p, div, halo_lag, omega, dx2, mask)
    for _ in range(iterations - blocks_ * halo_lag):
        for c in (0, 1):
            p = sor_sweep(nbr, p, div, c, omega, dx2, mask)
    return p


def combustion(fuel, waste, temperature, flame, div, temp_gain: float, expansion: float):
    """Oxygen-limited burn: (fuel, waste, temperature, flame, div) after it."""
    zero = torch.zeros((), dtype=fuel.dtype, device=fuel.device)
    fuel = torch.where(fuel < FUEL_THRESHOLD, zero, fuel)
    oxygen = 1.0 - fuel - waste
    valid = oxygen >= 0.0
    burn = torch.where(valid, torch.minimum(oxygen, fuel), zero)
    flame = torch.where(valid, torch.maximum(flame, torch.clamp(burn * 10.0, max=1.0)), flame)
    return (fuel - burn, waste + burn * 2.0, temperature + burn * temp_gain, flame,
            div + burn * expansion)


def buoyancy(vel, temperature, dt: float, ambient: float, strength: float):
    out = vel.clone()
    out[1] += torch.clamp(temperature - ambient, min=0.0) * strength * dt
    return out
