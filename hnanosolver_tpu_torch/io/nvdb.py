"""NanoVDB (.nvdb) file I/O — standalone, dependency-free.

Writes and reads the NanoVDB uncompressed file format (ABI version 32.7,
GridType Float / Vec3f) so simulation output interoperates with the OpenVDB
ecosystem (Houdini 19.5+, Blender, nanovdb_print/viewer, and the reference's
own NanoVDB-based tooling) — the "VDB I/O without Houdini" requirement of
SURVEY §7.4 hard-part 7. `.nvdb` converts losslessly to `.vdb` offline with
standard OpenVDB tools (``nanovdb_convert``).

The binary layout follows the public NanoVDB format specification: a 5-4-3
tree (root -> 32^3 upper -> 16^3 lower -> 8^3 leaf), 32-byte aligned POD
structs, breadth-first node order, single-segment files with
FileHeader(16B) + FileMetaData(176B) + name + grid buffer. All struct
sizes/offsets below were generated and verified against the NanoVDB headers
by ``native/nvdb_layout_dump.cpp``; ``tests/test_nvdb.py`` additionally
round-trips files through the real NanoVDB C++ reader when the headers are
available on the machine.

This writer emits "dense-per-leaf" grids (every voxel of an active tile is
active), matching the framework's tile layout and the reference's
``numLeaves * 512`` flattening (`reference/src/Utils/GridBuilder.hpp:221-239`).
"""

from __future__ import annotations

import struct
from typing import Dict, Optional, Tuple

import numpy as np

# ---- format constants (verified by native/nvdb_layout_dump.cpp) ----------
MAGIC_NUMB = 0x304244566F6E614E  # "NanoVDB0"
MAGIC_GRID = 0x314244566F6E614E  # "NanoVDB1"
VERSION = (32 << 21) | (7 << 10) | 0
CHECKSUM_DISABLED = 0xFFFFFFFFFFFFFFFF

GRIDTYPE_FLOAT = 1
GRIDTYPE_VEC3F = 6
GRIDCLASS = {
    "unknown": 0, "level_set": 1, "fog": 2, "staggered": 3, "topology": 6,
}
# GridFlags: HasBBox|HasMinMax|HasAverage|HasStdDeviation|IsBreadthFirst
GRID_FLAGS = 2 | 4 | 8 | 16 | 32

GRIDDATA_SIZE = 672
TREEDATA_SIZE = 64
ROOT_TILE_SIZE = 32

_SZ = {  # per value type: root size, upper size, lower size, leaf size,
    # leaf values offset, upper/lower table offset, value bytes, tile entry
    "float": dict(root=64, upper=270400, lower=33856, leaf=2144,
                  leaf_vals=96, utab=8256, ltab=1088, vbytes=4, tentry=8),
    "vec3f": dict(root=96, upper=532544, lower=66624, leaf=6272,
                  leaf_vals=128, utab=8256, ltab=1088, vbytes=12, tentry=16),
}
_MIN_OFF = {  # offsets of mMinimum within internal node structs
    "float": dict(upper=8224, lower=1056),
    "vec3f": dict(upper=8224, lower=1056),
}


def _root_key(tile_coords: np.ndarray) -> np.ndarray:
    """NanoVDB single-root-key for upper-node origins: 21 bits per axis of
    (uint32 coord) >> 12, packed x high, z low."""
    u = tile_coords.astype(np.int64) & 0xFFFFFFFF  # uint32 view of int coords
    return (
        ((u[:, 0] >> 12) << 42) | ((u[:, 1] >> 12) << 21) | (u[:, 2] >> 12)
    ).astype(np.uint64)


def _mask_words(bits: np.ndarray, nbits: int) -> np.ndarray:
    """Bit indices -> little-endian uint64 mask words."""
    words = np.zeros(nbits // 64, np.uint64)
    if len(bits):
        np.bitwise_or.at(words, bits // 64, np.uint64(1) << (bits % 64).astype(np.uint64))
    return words


def _stats(vals: np.ndarray, vec: bool):
    """(min, max, avg, stddev) with NanoVDB conventions (vector stats use
    per-component min/max and magnitude-based avg/dev)."""
    if not vec:
        return (
            float(vals.min()), float(vals.max()),
            float(vals.mean()), float(vals.std()),
        )
    mn = vals.reshape(-1, 3).min(0)
    mx = vals.reshape(-1, 3).max(0)
    mag = np.linalg.norm(vals.reshape(-1, 3), axis=1)
    return mn, mx, float(mag.mean()), float(mag.std())


def write_nvdb(
    path: str,
    leaf_origins: np.ndarray,
    values: np.ndarray,
    name: str = "density",
    voxel_size: float = 1.0,
    grid_class: str = "fog",
    background: float | Tuple[float, float, float] = 0.0,
) -> None:
    """Write one grid. ``leaf_origins`` [n,3] int tile coords (voxel origin =
    8*origin); ``values`` [n,8,8,8] float32 or [n,8,8,8,3] for Vec3f."""
    leaf_origins = np.asarray(leaf_origins, np.int32).reshape(-1, 3)
    values = np.ascontiguousarray(values, np.float32)
    vec = values.ndim == 5
    kind = "vec3f" if vec else "float"
    S = _SZ[kind]
    n_leaf = len(leaf_origins)
    if n_leaf == 0:
        raise ValueError("cannot write an empty grid")
    vox_origin = leaf_origins * 8

    # --- group leaves under lower (128^3) and upper (4096^3) nodes --------
    lower_of_leaf = vox_origin >> 7  # lower node coord (units of 128)
    lower_keys, lower_inv = np.unique(
        _pack3(lower_of_leaf), return_inverse=True
    )
    n_lower = len(lower_keys)
    lower_origin = _unpack3(lower_keys) << 7

    upper_of_lower = lower_origin >> 12
    upper_keys, upper_inv = np.unique(
        _pack3(upper_of_lower), return_inverse=True
    )
    n_upper = len(upper_keys)
    upper_origin = _unpack3(upper_keys) << 12

    root_keys = _root_key(upper_origin)
    order = np.argsort(root_keys)  # root tiles sorted by key
    upper_rank = np.empty(n_upper, np.int64)
    upper_rank[order] = np.arange(n_upper)

    # --- section offsets (breadth-first: root, uppers, lowers, leaves) ----
    tree_off = GRIDDATA_SIZE
    root_off = tree_off + TREEDATA_SIZE
    upper_sec = root_off + S["root"] + n_upper * ROOT_TILE_SIZE
    lower_sec = upper_sec + n_upper * S["upper"]
    leaf_sec = lower_sec + n_lower * S["lower"]
    grid_size = leaf_sec + n_leaf * S["leaf"]
    # 32B alignment is preserved automatically: all section sizes are 32k.

    buf = bytearray(grid_size)

    # --- leaves (vectorized record assembly: one numpy pass, not a Python
    # loop — a 33.7k-leaf grid packs in milliseconds) ------------------------
    bbox_min = vox_origin.min(0)
    bbox_max = (vox_origin + 7).max(0)
    rec = np.zeros((n_leaf, S["leaf"]), np.uint8)
    rec[:, 0:12] = (
        np.ascontiguousarray(vox_origin, "<i4").view(np.uint8).reshape(n_leaf, 12)
    )
    # mBBoxDif (7,7,7) + mFlags (bit1 hasBBox | bit4 hasStats)
    rec[:, 12:15] = 7
    rec[:, 15] = 2 | 16
    rec[:, 16:80] = 0xFF  # full value mask (dense-per-leaf layout)
    if vec:
        v3 = values.reshape(n_leaf, 512, 3)
        mag = np.linalg.norm(v3, axis=2)
        stats = np.concatenate(
            [v3.min(1), v3.max(1), mag.mean(1)[:, None], mag.std(1)[:, None]],
            axis=1,
        ).astype("<f4")
    else:
        flat = values.reshape(n_leaf, 512)
        stats = np.stack(
            [flat.min(1), flat.max(1), flat.mean(1), flat.std(1)], axis=1
        ).astype("<f4")
    rec[:, 80 : 80 + stats.shape[1] * 4] = stats.view(np.uint8)
    vb = np.ascontiguousarray(values.reshape(n_leaf, -1), "<f4").view(np.uint8)
    rec[:, S["leaf_vals"] : S["leaf_vals"] + vb.shape[1]] = vb
    buf[leaf_sec : leaf_sec + n_leaf * S["leaf"]] = rec.tobytes()

    # --- lower internal nodes ----------------------------------------------
    leaf_local = (
        (((vox_origin[:, 0] & 127) >> 3) << 8)
        | (((vox_origin[:, 1] & 127) >> 3) << 4)
        | ((vox_origin[:, 2] & 127) >> 3)
    )
    for j in range(n_lower):
        off = lower_sec + j * S["lower"]
        sel = np.flatnonzero(lower_inv == j)
        lo = vox_origin[sel].min(0)
        hi = (vox_origin[sel] + 7).max(0)
        struct.pack_into("<6iQ", buf, off, *lo, *hi, 0)  # bbox + mFlags
        cm = _mask_words(leaf_local[sel], 4096)
        buf[off + 32 : off + 544] = np.zeros(64, np.uint64).tobytes()  # vmask
        buf[off + 544 : off + 1056] = cm.tobytes()
        mn, mx, avg, dev = _stats(values[sel], vec)
        if vec:
            struct.pack_into("<3f3f2f", buf, off + _MIN_OFF[kind]["lower"], *mn, *mx, avg, dev)
        else:
            struct.pack_into("<4f", buf, off + _MIN_OFF[kind]["lower"], mn, mx, avg, dev)
        for k in sel:
            child_off = (leaf_sec + int(k) * S["leaf"]) - off
            struct.pack_into(
                "<q", buf, off + S["ltab"] + int(leaf_local[k]) * S["tentry"], child_off
            )

    # --- upper internal nodes ----------------------------------------------
    lower_local = (
        (((lower_origin[:, 0] & 4095) >> 7) << 10)
        | (((lower_origin[:, 1] & 4095) >> 7) << 5)
        | ((lower_origin[:, 2] & 4095) >> 7)
    )
    for u in range(n_upper):
        pos = upper_rank[u]  # this node is written at its sorted position
        off = upper_sec + int(pos) * S["upper"]
        lsel = np.flatnonzero(upper_inv == u)
        leafsel = np.flatnonzero(np.isin(lower_inv, lsel))
        lo = vox_origin[leafsel].min(0)
        hi = (vox_origin[leafsel] + 7).max(0)
        struct.pack_into("<6iQ", buf, off, *lo, *hi, 0)
        cm = _mask_words(lower_local[lsel], 32768)
        buf[off + 32 : off + 4128] = np.zeros(512, np.uint64).tobytes()
        buf[off + 4128 : off + 8224] = cm.tobytes()
        mn, mx, avg, dev = _stats(values[leafsel], vec)
        if vec:
            struct.pack_into("<3f3f2f", buf, off + _MIN_OFF[kind]["upper"], *mn, *mx, avg, dev)
        else:
            struct.pack_into("<4f", buf, off + _MIN_OFF[kind]["upper"], mn, mx, avg, dev)
        for j in lsel:
            child_off = (lower_sec + int(j) * S["lower"]) - off
            struct.pack_into(
                "<q", buf, off + S["utab"] + int(lower_local[j]) * S["tentry"], child_off
            )

    # --- root + tiles --------------------------------------------------------
    mn, mx, avg, dev = _stats(values, vec)
    struct.pack_into("<6iI", buf, root_off, *bbox_min, *bbox_max, n_upper)
    bg = background if vec else (background,)
    if vec:
        bgt = tuple(background) if hasattr(background, "__len__") else (background,) * 3
        struct.pack_into("<3f3f3f2f", buf, root_off + 28, *bgt, *mn, *mx, avg, dev)
    else:
        struct.pack_into("<5f", buf, root_off + 28, float(background), mn, mx, avg, dev)
    tiles_off = root_off + S["root"]
    for rank, u in enumerate(order):
        toff = tiles_off + rank * ROOT_TILE_SIZE
        child_off = (upper_sec + rank * S["upper"]) - root_off
        struct.pack_into("<QqI", buf, toff, int(root_keys[u]), child_off, 0)

    # --- tree ---------------------------------------------------------------
    t = tree_off
    struct.pack_into(
        "<4q3I3IQ", buf, t,
        leaf_sec - t, lower_sec - t, upper_sec - t, root_off - t,
        n_leaf, n_lower, n_upper,
        0, 0, 0,
        n_leaf * 512,
    )

    # --- grid ---------------------------------------------------------------
    _pack_griddata(
        buf, name, grid_size,
        GRIDTYPE_VEC3F if vec else GRIDTYPE_FLOAT,
        GRIDCLASS[grid_class], voxel_size, bbox_min, bbox_max,
    )

    # --- file: header + metadata + name + grid ------------------------------
    name_b = name.encode() + b"\0"
    meta = struct.pack(
        "<4Q2I", grid_size, grid_size, _string_hash(name), n_leaf * 512,
        GRIDTYPE_VEC3F if vec else GRIDTYPE_FLOAT, GRIDCLASS[grid_class],
    )
    wmin = bbox_min.astype(np.float64) * voxel_size
    wmax = (bbox_max.astype(np.float64) + 1.0) * voxel_size
    meta += struct.pack("<6d", *wmin, *wmax)
    meta += struct.pack("<6i", *bbox_min, *bbox_max)
    meta += struct.pack("<3d", voxel_size, voxel_size, voxel_size)
    meta += struct.pack("<I", len(name_b))
    meta += struct.pack("<4I", n_leaf, n_lower, n_upper, 1)
    meta += struct.pack("<3I", 0, 0, 0)
    meta += struct.pack("<HHI", 0, 0, VERSION)  # codec NONE, pad, version
    assert len(meta) == 176, len(meta)
    header = struct.pack("<QIHH", MAGIC_NUMB, VERSION, 1, 0)
    with open(path, "wb") as f:
        f.write(header)
        f.write(meta)
        f.write(name_b)
        f.write(bytes(buf))


def _pack3(t: np.ndarray) -> np.ndarray:
    u = t.astype(np.int64)
    return ((u[:, 0] + (1 << 20)) << 42) | ((u[:, 1] + (1 << 20)) << 21) | (
        u[:, 2] + (1 << 20)
    )


def _unpack3(k: np.ndarray) -> np.ndarray:
    return np.stack(
        [
            ((k >> 42) & 0x1FFFFF) - (1 << 20),
            ((k >> 21) & 0x1FFFFF) - (1 << 20),
            (k & 0x1FFFFF) - (1 << 20),
        ],
        axis=-1,
    ).astype(np.int32)


def _string_hash(name: str) -> int:
    """NanoVDB io::stringHash (used for FileMetaData.nameKey)."""
    h = 0
    for ch in name.encode():
        overflow = h >> (64 - 8)
        h = (h * 67 + ch + overflow) & 0xFFFFFFFFFFFFFFFF
    return h


def _pack_griddata(buf, name, grid_size, grid_type, grid_class, voxel_size,
                   bbox_min, bbox_max):
    struct.pack_into("<QQ", buf, 0, MAGIC_NUMB, CHECKSUM_DISABLED)
    struct.pack_into("<2I", buf, 16, VERSION, GRID_FLAGS)
    struct.pack_into("<2IQ", buf, 24, 0, 1, grid_size)
    nb = name.encode()[:255]
    buf[40 : 40 + len(nb)] = nb
    # Map @296: float mat/inv/vec/taper then double mat/inv/vec/taper
    s = float(voxel_size)
    matf = [s, 0, 0, 0, s, 0, 0, 0, s]
    invf = [1 / s, 0, 0, 0, 1 / s, 0, 0, 0, 1 / s]
    struct.pack_into("<9f9f3ff", buf, 296, *matf, *invf, 0.0, 0.0, 0.0, 1.0)
    matd = [s, 0, 0, 0, s, 0, 0, 0, s]
    invd = [1 / s, 0, 0, 0, 1 / s, 0, 0, 0, 1 / s]
    struct.pack_into("<9d9d3dd", buf, 296 + 88, *matd, *invd, 0.0, 0.0, 0.0, 1.0)
    wmin = bbox_min.astype(np.float64) * s
    wmax = (bbox_max.astype(np.float64) + 1.0) * s
    struct.pack_into("<6d", buf, 560, *wmin, *wmax)
    struct.pack_into("<3d", buf, 608, s, s, s)
    struct.pack_into("<2I", buf, 632, grid_class, grid_type)
    struct.pack_into("<qIIQQ", buf, 640, grid_size, 0, 0, 0, MAGIC_GRID)


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------


def read_nvdb(path: str):
    """Read a single-grid .nvdb file written by this module (or by NanoVDB
    itself, uncompressed). Returns (name, voxel_size, leaf_origins [n,3] tile
    coords, values [n,8,8,8(,3)], leaf value masks [n,512] bool)."""
    with open(path, "rb") as f:
        data = f.read()
    magic, version, grid_count, codec = struct.unpack_from("<QIHH", data, 0)
    if magic not in (MAGIC_NUMB, 0x324244566F6E614E):
        raise ValueError("not a NanoVDB file")
    if codec != 0:
        raise ValueError("compressed .nvdb not supported (codec != NONE)")
    # FileMetaData field offsets: 32B of uint64s, 8B types, 48B worldBBox,
    # 24B indexBBox, 24B voxelSize -> nameSize at 136.
    name_size = struct.unpack_from("<I", data, 16 + 136)[0]
    grid_off = 16 + 176 + name_size
    g = memoryview(data)[grid_off:]

    grid_type = struct.unpack_from("<I", g, 636)[0]
    vec = grid_type == GRIDTYPE_VEC3F
    if grid_type not in (GRIDTYPE_FLOAT, GRIDTYPE_VEC3F):
        raise ValueError(f"unsupported grid type {grid_type}")
    kind = "vec3f" if vec else "float"
    S = _SZ[kind]
    name = bytes(g[40 : 40 + 256]).split(b"\0")[0].decode()
    voxel_size = struct.unpack_from("<d", g, 608)[0]

    t = GRIDDATA_SIZE
    offs = struct.unpack_from("<4q", g, t)
    counts = struct.unpack_from("<3I", g, t + 32)
    n_leaf = counts[0]
    leaf_sec = t + offs[0]

    vshape = (n_leaf, 8, 8, 8, 3) if vec else (n_leaf, 8, 8, 8)
    nvals = 512 * (3 if vec else 1)
    rec = np.frombuffer(
        g, np.uint8, n_leaf * S["leaf"], leaf_sec
    ).reshape(n_leaf, S["leaf"])
    origins = rec[:, 0:12].copy().view("<i4").reshape(n_leaf, 3)
    masks = np.unpackbits(rec[:, 16:80], axis=1, bitorder="little").astype(bool)
    values = (
        rec[:, S["leaf_vals"] : S["leaf_vals"] + nvals * 4]
        .copy().view("<f4").reshape(vshape)
    )
    assert np.all(origins % 8 == 0)
    return name, voxel_size, origins // 8, values, masks


# ---------------------------------------------------------------------------
# FieldState integration
# ---------------------------------------------------------------------------


def write_state_nvdb(out_dir: str, topo, state, voxel_size: float = 1.0,
                     frame: Optional[int] = None, fields=None):
    """Export every field of a FieldState as .nvdb grids (velocity as Vec3f
    with GridClass Staggered — mirroring the reference's GRID_STAGGERED
    metadata quirk, SURVEY §7.5 — scalars as FogVolume). Returns the list of
    written paths."""
    import os

    n = int(topo.n_active)
    origins = topo.origins[1 : n + 1].cpu().numpy()
    suffix = f"_{frame:04d}" if frame is not None else ""
    paths = []
    os.makedirs(out_dir, exist_ok=True)

    vel = state.velocity_blocks()[1 : n + 1].cpu().numpy()
    p = os.path.join(out_dir, f"velocity{suffix}.nvdb")
    write_nvdb(p, origins, vel, name="velocity", voxel_size=voxel_size,
               grid_class="staggered")
    paths.append(p)
    for name, f in state.scalars.items():
        if fields is not None and name not in fields:
            continue
        arr = state.scalar_blocks(name)[1 : n + 1].cpu().numpy()
        p = os.path.join(out_dir, f"{name}{suffix}.nvdb")
        write_nvdb(p, origins, arr, name=name, voxel_size=voxel_size,
                   grid_class="level_set" if name == "collision_sdf" else "fog")
        paths.append(p)
    return paths


def read_nvdb_to_state(paths, device=None):
    """Read a set of .nvdb grids (same topology) into the port's (Topology,
    FieldState, voxel_size) on ``device`` (default: the CUDA card). The
    inverse of write_state_nvdb for round-trip pipelines."""
    import torch

    from hnanosolver_tpu_torch.core.topology import build_topology, lookup_tiles
    from hnanosolver_tpu_torch.fields import FieldState

    grids = {}
    origins0 = None
    voxel_size = None
    for p in paths:
        name, vs, origins, values, _ = read_nvdb(p)
        grids[name] = (origins, values)
        voxel_size = vs
        if origins0 is None or len(origins) > len(origins0):
            origins0 = origins
    topo = build_topology(origins0, device=device)

    def to_rows(origins, values):
        rows = lookup_tiles(topo, origins).cpu().numpy()
        shape = (topo.capacity,) + values.shape[1:]
        out = np.zeros(shape, np.float32)
        out[rows] = values
        out[0] = 0
        return torch.from_numpy(out).to(topo.device)

    velocity_blocks = None
    scalar_blocks = {}
    for name, (o, v) in grids.items():
        arr = to_rows(o, v)
        if v.ndim == 5:
            velocity_blocks = arr
        else:
            scalar_blocks[name] = arr
    if velocity_blocks is None:
        T = topo.capacity
        velocity_blocks = torch.zeros((T, 8, 8, 8, 3), dtype=torch.float32,
                                      device=topo.device)
    return (
        topo,
        FieldState.from_blocks(velocity_blocks, scalar_blocks),
        voxel_size,
    )
