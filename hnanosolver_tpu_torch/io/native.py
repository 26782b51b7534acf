"""ctypes binding for the native C++ tile builder (native/tilebuilder.cpp),
with a pure-numpy path when the shared library cannot be built (no g++).

The native path is the IndexGridBuilder analog
(`reference/src/Utils/GridBuilder.hpp:21-250`): OpenMP-parallel encode
of coordinate-list sparse data into the [rows, 8,8,8] tile layout and back.
It is host code, not a device kernel. The library is compiled with g++ from
the source in ``native/`` into ``build/hnanosolver_tpu_torch/native/`` on
first use (``python -m hnanosolver_tpu_torch.io.native`` builds it now); the
``native/`` directory is only read.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from typing import Optional, Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "tilebuilder.cpp")
_LIB = os.path.join(_REPO_ROOT, "build", "hnanosolver_tpu_torch", "native", "libtilebuilder.so")

_lib: Optional[ctypes.CDLL] = None


def build_library(force: bool = False) -> Optional[str]:
    """Compile the shared library with g++ -O3 -fopenmp into the build
    directory (written under a temporary name, then renamed, so concurrent
    builds never load a half-written file). Returns its path, or None when
    g++ is absent or fails."""
    if (not force and os.path.exists(_LIB)
            and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC)):
        return _LIB
    os.makedirs(os.path.dirname(_LIB), exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-fopenmp", "-std=c++17", _SRC, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _LIB)
        return _LIB
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        print(f"[hnanosolver_tpu_torch.io.native] build failed: {e}", file=sys.stderr)
        return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    path = build_library()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.hns_count_tiles.restype = ctypes.c_int64
    lib.hns_count_tiles.argtypes = [i32p, ctypes.c_int64]
    lib.hns_build_index.restype = ctypes.c_int32
    lib.hns_build_index.argtypes = [
        i32p, ctypes.c_int64, i32p, i32p, ctypes.c_int64, i32p, i32p,
    ]
    lib.hns_scatter.restype = None
    lib.hns_scatter.argtypes = [i32p, i32p, f32p, ctypes.c_int64, ctypes.c_int32, f32p]
    lib.hns_gather.restype = None
    lib.hns_gather.argtypes = [i32p, i32p, f32p, ctypes.c_int64, ctypes.c_int32, f32p]
    lib.hns_tile_coords.restype = None
    lib.hns_tile_coords.argtypes = [i32p, ctypes.c_int64, i32p]
    _lib = lib
    return lib


def _ptr(a: np.ndarray, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def have_native() -> bool:
    return _load() is not None


def build_index(coords: np.ndarray):
    """coords int32 [N,3] -> (keys [M], origins [M,3], row [N], local [N]).
    Uses the native library when available, numpy otherwise; identical
    output either way (tested)."""
    coords = np.ascontiguousarray(coords, np.int32)
    n = coords.shape[0]
    lib = _load()
    if lib is not None:
        m = lib.hns_count_tiles(_ptr(coords, ctypes.c_int32), n)
        if m < 0:
            raise ValueError("tile coords out of packable range [-512, 512)")
        keys = np.empty(m, np.int32)
        origins = np.empty((m, 3), np.int32)
        row = np.empty(n, np.int32)
        local = np.empty(n, np.int32)
        rc = lib.hns_build_index(
            _ptr(coords, ctypes.c_int32), n,
            _ptr(keys, ctypes.c_int32), _ptr(origins, ctypes.c_int32), m,
            _ptr(row, ctypes.c_int32), _ptr(local, ctypes.c_int32),
        )
        if rc != 0:
            raise RuntimeError("hns_build_index failed")
        return keys, origins, row, local
    # numpy path
    from hnanosolver_tpu_torch.core import coords as C

    tiles = coords >> 3
    k = C.pack_keys_np(tiles)
    keys = np.unique(k)
    row = (np.searchsorted(keys, k) + 1).astype(np.int32)
    local = (
        (coords[:, 0] & 7) * 8 + (coords[:, 1] & 7)
    ) * 8 + (coords[:, 2] & 7)
    origins = np.stack(
        [(keys >> 20) & 0x3FF, (keys >> 10) & 0x3FF, keys & 0x3FF], -1
    ).astype(np.int32) - 512
    return keys, origins.reshape(-1, 3), row.astype(np.int32), local.astype(np.int32)


def scatter(row, local, values, num_rows: int, channels: int = 1) -> np.ndarray:
    """Per-coordinate values -> tiles [num_rows, 512*channels] (row 0 null)."""
    row = np.ascontiguousarray(row, np.int32)
    local = np.ascontiguousarray(local, np.int32)
    values = np.ascontiguousarray(values, np.float32).reshape(-1, channels)
    n = row.shape[0]
    out = np.zeros((num_rows, 512, channels), np.float32)
    lib = _load()
    if lib is not None:
        lib.hns_scatter(
            _ptr(row, ctypes.c_int32), _ptr(local, ctypes.c_int32),
            _ptr(values, ctypes.c_float), n, channels,
            _ptr(out, ctypes.c_float),
        )
    else:
        out[row, local] = values
    return out if channels > 1 else out[..., 0]


def gather(row, local, tiles, channels: int = 1) -> np.ndarray:
    """Tiles -> per-coordinate values (decode; writeIndexGrid analog)."""
    row = np.ascontiguousarray(row, np.int32)
    local = np.ascontiguousarray(local, np.int32)
    tiles = np.ascontiguousarray(tiles, np.float32).reshape(-1, 512, channels)
    n = row.shape[0]
    out = np.empty((n, channels), np.float32)
    lib = _load()
    if lib is not None:
        lib.hns_gather(
            _ptr(row, ctypes.c_int32), _ptr(local, ctypes.c_int32),
            _ptr(tiles, ctypes.c_float), n, channels,
            _ptr(out, ctypes.c_float),
        )
    else:
        out[:] = tiles[row, local]
    return out if channels > 1 else out[:, 0]


def tile_coords(origins: np.ndarray) -> np.ndarray:
    """Origins [M,3] -> dense-per-leaf voxel coordinate list [M*512, 3]."""
    origins = np.ascontiguousarray(origins, np.int32)
    m = origins.shape[0]
    out = np.empty((m * 512, 3), np.int32)
    lib = _load()
    if lib is not None:
        lib.hns_tile_coords(_ptr(origins, ctypes.c_int32), m, _ptr(out, ctypes.c_int32))
    else:
        l = np.arange(8, dtype=np.int32)
        gx, gy, gz = np.meshgrid(l, l, l, indexing="ij")
        locals_ = np.stack([gx, gy, gz], -1).reshape(1, 512, 3)
        out[:] = (origins[:, None, :] * 8 + locals_).reshape(-1, 3)
    return out


if __name__ == "__main__":
    p = build_library(force=True)
    print(f"built: {p}" if p else "build FAILED")
