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

The table sampler (``ops/advection.py`` with ``INTERP = "vmem"``) also
needs the chunk plans of the JAX package's topology (``chunk_uniq``,
``chunk_lnbr``, ``chunk_dsrc``, ``chunk_ldual`` and ``chunk_dloc``, kernel
B11's indirection). They are built together in host numpy, equal to the JAX
package's arrays, only when asked: ``build_topology(..., plans=True)`` or
:func:`ensure_chunk_plans`. A topology grown from a planned one
(``core/activation.py``) is planned too.
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
    # Chunk plans (None until asked for). Tiles run in chunks of
    # SAMPLE_CHUNK rows; chunk_uniq[c] lists the sorted unique rows of
    # chunk c's 27-neighbourhoods (null row first, zero-padded) and
    # chunk_lnbr maps nbr into positions in it. chunk_dsrc[c, u] lists the 8
    # source rows (d - 1 + b, b in {0,1}^3, 0 where absent) of chunk c's
    # u-th dual tile d, whose half-shifted row is S[d][l] = f[d*8 + l - 4];
    # row 0 of every chunk is the all-null dual row. chunk_ldual[t, j] is
    # the chunk-local dual row of t + (j>>2, (j>>1)&1, j&1). chunk_dloc
    # maps chunk_dsrc's rows into positions in chunk_uniq[c]. All five or
    # none.
    chunk_uniq: Optional[torch.Tensor] = None  # [nc, U] int32
    chunk_lnbr: Optional[torch.Tensor] = None  # [T, 27] int32
    chunk_dsrc: Optional[torch.Tensor] = None  # [nc, Ud, 8] int32
    chunk_ldual: Optional[torch.Tensor] = None  # [T, 8] int32
    chunk_dloc: Optional[torch.Tensor] = None  # [nc, Ud, 8] int32

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
    plans: bool = False,
) -> Topology:
    """Build a Topology on ``device`` (default: the CUDA card) from an
    ``[M, 3]`` array of (possibly duplicated) tile coordinates; the tables
    are computed in host numpy. ``plans``: also the chunk plans of the
    table sampler."""
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
    extra = {}
    if plans:
        extra = _plans_np(full_keys, origins, nbr, n)
    return Topology(
        keys=torch.from_numpy(full_keys).to(device),
        origins=torch.from_numpy(origins).to(device),
        nbr=torch.from_numpy(nbr).to(device),
        n_active=n,
        **{k: torch.from_numpy(v).to(device) for k, v in extra.items()},
    )


SAMPLE_CHUNK = 512  # tiles per sampling chunk

_DUAL_OFFSETS = np.array(
    [(bx, by, bz) for bx in (0, 1) for by in (0, 1) for bz in (0, 1)],
    dtype=np.int32,
)  # [8, 3]; index j = bx*4 + by*2 + bz


def _chunk_plan(nbr: np.ndarray, capacity: int):
    """(chunk_uniq [nc, U], chunk_lnbr [T, 27]); U is the largest unique
    count over the chunks rounded up to a multiple of 8, padding entries
    point at the null row 0."""
    C_ = min(SAMPLE_CHUNK, capacity)
    if capacity % C_:
        raise ValueError(f"capacity {capacity} is not a multiple of {C_}")
    nc = capacity // C_
    uniqs = [np.unique(np.concatenate([[0], nbr[c * C_:(c + 1) * C_].ravel()]))
             for c in range(nc)]
    U = ((max(len(u) for u in uniqs) + 7) // 8) * 8
    uq = np.zeros((nc, U), np.int32)
    ln = np.zeros((capacity, 27), np.int32)
    for c, u in enumerate(uniqs):
        uq[c, :len(u)] = u
        ln[c * C_:(c + 1) * C_] = np.searchsorted(u, nbr[c * C_:(c + 1) * C_])
    return uq, ln


def _dual_plan(origins: np.ndarray, keys_np: np.ndarray, capacity: int):
    """(chunk_dsrc [nc, Ud, 8], chunk_ldual [T, 8]); dual keys are packed
    int64 with a wide offset (tile + 1 can sit one past the packable int32
    key range)."""
    C_ = min(SAMPLE_CHUNK, capacity)
    nc = capacity // C_
    n = int(keys_np.shape[0])

    def pack64(t):
        t = t.astype(np.int64) + 1024
        return (t[..., 0] * 4096 + t[..., 1]) * 4096 + t[..., 2]

    def src_rows(dcoords):
        """[m, 3] dual coords -> [m, 8] source tile rows (0 where absent)."""
        cand = dcoords[:, None, :] - 1 + _DUAL_OFFSETS[None]
        ck = C.pack_keys_np(np.clip(cand, -C.TILE_OFFSET, C.TILE_OFFSET - 1))
        pos_c = np.minimum(np.searchsorted(keys_np, ck), n - 1)
        ok = (keys_np[pos_c] == ck) & np.all(
            (cand >= -C.TILE_OFFSET) & (cand < C.TILE_OFFSET), axis=-1)
        return np.where(ok, pos_c + 1, 0).astype(np.int32)

    per_chunk, Ud = [], 1
    for c in range(nc):
        rows = np.arange(c * C_, (c + 1) * C_)
        org = origins[rows][(rows >= 1) & (rows <= n)]
        dc = (org[:, None, :] + _DUAL_OFFSETS[None]).reshape(-1, 3)
        dk, idx = np.unique(pack64(dc), return_index=True)
        per_chunk.append((dc[idx], dk))
        Ud = max(Ud, len(dk) + 1)
    Ud = ((Ud + 7) // 8) * 8
    dsrc = np.zeros((nc, Ud, 8), np.int32)
    ldual = np.zeros((capacity, 8), np.int32)
    for c, (dc, dk) in enumerate(per_chunk):
        if not len(dc):
            continue
        dsrc[c, 1:len(dc) + 1] = src_rows(dc)
        rows = np.arange(c * C_, (c + 1) * C_)
        act = rows[(rows >= 1) & (rows <= n)]
        qc = origins[act][:, None, :] + _DUAL_OFFSETS[None]
        ldual[act] = np.searchsorted(dk, pack64(qc)) + 1
    return dsrc, ldual


def _dual_local(uq: np.ndarray, dsrc: np.ndarray) -> np.ndarray:
    """chunk_dloc: chunk_dsrc's rows as positions in chunk_uniq[c] (every
    dual source of chunk c is a 27-neighbour of one of its tiles)."""
    dloc = np.zeros(dsrc.shape, np.int32)
    for c in range(dsrc.shape[0]):
        u = uq[c, :1 + int(np.count_nonzero(uq[c]))]
        pos = np.searchsorted(u, dsrc[c])
        if not np.array_equal(u[np.minimum(pos, len(u) - 1)], dsrc[c]):
            raise AssertionError("dual source missing from chunk unique set")
        dloc[c] = pos
    return dloc


def _plans_np(full_keys, origins, nbr, n) -> dict:
    cap = full_keys.shape[0]
    uq, ln = _chunk_plan(nbr, cap)
    dsrc, ldual = _dual_plan(origins, full_keys[1:n + 1], cap)
    return dict(chunk_uniq=uq, chunk_lnbr=ln, chunk_dsrc=dsrc, chunk_ldual=ldual,
                chunk_dloc=_dual_local(uq, dsrc))


def ensure_chunk_plans(topo: Topology) -> Topology:
    """``topo`` carrying the table sampler's chunk plans, built on the host
    if it lacks them (one device-to-host copy of its tables)."""
    if topo.chunk_dsrc is not None:
        return topo
    extra = _plans_np(topo.keys.cpu().numpy(), topo.origins.cpu().numpy(),
                      topo.nbr.cpu().numpy(), topo.n_active)
    return dataclasses.replace(
        topo, **{k: torch.from_numpy(v).to(topo.device) for k, v in extra.items()})


def active_mask(topo: Topology) -> torch.Tensor:
    """[T] float32: 1.0 for active tile rows, 0.0 for null/padding rows."""
    ids = torch.arange(topo.capacity, device=topo.device)
    return ((ids >= 1) & (ids <= topo.n_active)).to(torch.float32)
