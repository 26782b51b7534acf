"""Dense-grid reference implementation of the solver physics, in plain torch.

The independent oracle for the sparse tile path: the same physics written
directly on ``[Nx, Ny, Nz]`` / ``[Nx, Ny, Nz, 3]`` tensors with a zero
(background) boundary, the JAX package's ``dense/ops.py`` function for
function and in its op order. Values outside the box read as exact 0, as the
sparse null tile does, so a sparse topology covering exactly this box must
reproduce these results to float tolerance.

It is deliberately simple, not fast, and it runs no kernel: every op is a
pad, a slice, a gather or elementwise arithmetic, on whatever device the
inputs live on. ``advect_bfecc`` traces without the sparse path's
``DISP_LIMIT`` clamp, so the two agree only where ``cfl_clamped_count`` is 0.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _shifted(f: torch.Tensor, dx: int, dy: int, dz: int) -> torch.Tensor:
    """f sampled at (i+dx, j+dy, k+dz) with zero outside the box."""
    pad = [(max(-dx, 0), max(dx, 0)), (max(-dy, 0), max(dy, 0)), (max(-dz, 0), max(dz, 0))]
    if f.ndim == 4:
        pad = pad + [(0, 0)]
    g = F.pad(f, [v for lo_hi in reversed(pad) for v in lo_hi])  # last axis first
    N = f.shape[0], f.shape[1], f.shape[2]
    return g[pad[0][0] + dx:pad[0][0] + dx + N[0],
             pad[1][0] + dy:pad[1][0] + dy + N[1],
             pad[2][0] + dz:pad[2][0] + dz + N[2]]


def sample_nearest(f: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Integer-coordinate gather with zero outside; coords [..., 3] int32."""
    N = torch.tensor(f.shape[:3], dtype=torch.int32, device=coords.device)
    inside = ((coords >= 0) & (coords < N)).all(dim=-1)
    c = torch.clamp(coords, torch.zeros_like(N), N - 1).long()
    vals = f[c[..., 0], c[..., 1], c[..., 2]]
    mask = inside if f.ndim == 3 else inside[..., None]
    return torch.where(mask, vals, torch.zeros((), dtype=f.dtype, device=f.device))


def sample_trilinear(f: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Trilinear interpolation at float positions, zero background."""
    fl = torch.floor(pos)
    base = fl.to(torch.int32)
    frac = pos - fl
    tx, ty, tz = frac[..., 0], frac[..., 1], frac[..., 2]
    itx, ity, itz = 1 - tx, 1 - ty, 1 - tz
    acc = None
    for di in (0, 1):
        for dj in (0, 1):
            for dk in (0, 1):
                w = (tx if di else itx) * (ty if dj else ity) * (tz if dk else itz)
                off = torch.tensor([di, dj, dk], dtype=torch.int32, device=pos.device)
                v = sample_nearest(f, base + off)
                v = v * (w[..., None] if f.ndim == 4 else w)
                acc = v if acc is None else acc + v
    return acc


def positions(shape, device=None) -> torch.Tensor:
    """The (i, j, k) index of every voxel of a box, [*shape, 3] int32."""
    axes = [torch.arange(int(n), dtype=torch.int32, device=device) for n in shape[:3]]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)


def divergence(vel: torch.Tensor, inv_dx: float) -> torch.Tensor:
    xp = 0.5 * (vel[..., 0] + _shifted(vel, 1, 0, 0)[..., 0])
    xm = 0.5 * (vel[..., 0] + _shifted(vel, -1, 0, 0)[..., 0])
    yp = 0.5 * (vel[..., 1] + _shifted(vel, 0, 1, 0)[..., 1])
    ym = 0.5 * (vel[..., 1] + _shifted(vel, 0, -1, 0)[..., 1])
    zp = 0.5 * (vel[..., 2] + _shifted(vel, 0, 0, 1)[..., 2])
    zm = 0.5 * (vel[..., 2] + _shifted(vel, 0, 0, -1)[..., 2])
    return (xp - xm + yp - ym + zp - zm) * inv_dx


def neighbor_sum(p: torch.Tensor) -> torch.Tensor:
    return (
        _shifted(p, 1, 0, 0)
        + _shifted(p, -1, 0, 0)
        + _shifted(p, 0, 1, 0)
        + _shifted(p, 0, -1, 0)
        + _shifted(p, 0, 0, 1)
        + _shifted(p, 0, 0, -1)
    )


def solve_pressure(div: torch.Tensor, iterations: int, dx: float, omega: float) -> torch.Tensor:
    """Textbook red-black SOR from p = 0: ``iterations`` red then black
    sweeps, each voxel of the colour set to p + omega * (pGS - p) with
    pGS = (sum of the 6 neighbours - div dx^2) / 6."""
    pos = positions(div.shape, div.device)
    parity = (pos[..., 0] + pos[..., 1] + pos[..., 2]) & 1
    dx2 = dx * dx

    def sweep(p, mask):
        pgs = (neighbor_sum(p) - div * dx2) / 6.0
        return torch.where(mask, p + omega * (pgs - p), p)

    p = torch.zeros_like(div)
    for _ in range(iterations):
        p = sweep(p, parity == 0)
        p = sweep(p, parity == 1)
    return p


def subtract_pressure_gradient(vel: torch.Tensor, p: torch.Tensor, inv_dx: float) -> torch.Tensor:
    g = torch.stack(
        [
            (_shifted(p, 1, 0, 0) - _shifted(p, -1, 0, 0)),
            (_shifted(p, 0, 1, 0) - _shifted(p, 0, -1, 0)),
            (_shifted(p, 0, 0, 1) - _shifted(p, 0, 0, -1)),
        ],
        dim=-1,
    ) * (0.5 * inv_dx)
    return vel - g


def vorticity_confinement(vel: torch.Tensor, dt: float, inv_dx: float, scale: float,
                          factor_scale: float) -> torch.Tensor:
    """u + scale * (N x omega) * dt, N = grad|omega| / (|grad|omega|| +
    1e-5), the gradient taken at offset ``s = int(factor_scale)`` (0: no
    gradient, so no force)."""
    s = int(factor_scale)
    factor = 0.5 * inv_dx
    pos = positions(vel.shape[:3], vel.device)

    def curl_at(off):
        def v(o):
            d = torch.tensor([off[i] + o[i] for i in range(3)], dtype=torch.int32,
                             device=vel.device)
            return sample_nearest(vel, pos + d)

        upx, umx = v((1, 0, 0)), v((-1, 0, 0))
        upy, umy = v((0, 1, 0)), v((0, -1, 0))
        upz, umz = v((0, 0, 1)), v((0, 0, -1))
        wx = ((upy[..., 2] - umy[..., 2]) - (upz[..., 1] - umz[..., 1])) * factor
        wy = ((upz[..., 0] - umz[..., 0]) - (upx[..., 2] - umx[..., 2])) * factor
        wz = ((upx[..., 1] - umx[..., 1]) - (upy[..., 0] - umy[..., 0])) * factor
        return torch.stack([wx, wy, wz], dim=-1)

    omega = curl_at((0, 0, 0))
    if s == 0:
        grad = torch.zeros_like(omega)
    else:
        def mag(off):
            w = curl_at(off)
            return torch.sqrt(torch.sum(w * w, dim=-1))

        grad = torch.stack(
            [
                (mag((s, 0, 0)) - mag((-s, 0, 0))) * factor,
                (mag((0, s, 0)) - mag((0, -s, 0))) * factor,
                (mag((0, 0, s)) - mag((0, 0, -s))) * factor,
            ],
            dim=-1,
        )
    glen = torch.sqrt(torch.sum(grad * grad, dim=-1, keepdim=True)) + 1e-5
    return vel + scale * torch.linalg.cross(grad / glen, omega, dim=-1) * dt


def advect_bfecc(vel: torch.Tensor, field: torch.Tensor, dt: float, inv_dx: float) -> torch.Tensor:
    """BFECC advection of a scalar or vector field (no collisions, no trace
    clamp)."""
    scaled_dt = dt * inv_dx
    pos = positions(vel.shape[:3], vel.device).to(vel.dtype)
    back = pos - vel * scaled_dt
    vel_f = sample_trilinear(vel, back)
    fwd2 = back + vel_f * scaled_dt
    phi_f = sample_trilinear(field, back)
    phi_b = sample_trilinear(field, fwd2)
    corr = phi_f + 0.5 * (field - phi_b)
    lo = torch.minimum(field, phi_f)
    hi = torch.maximum(field, phi_f)
    for off in [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)]:
        n = _shifted(field, *off)
        lo = torch.minimum(lo, n)
        hi = torch.maximum(hi, n)
    return torch.clamp(corr, lo, hi)
