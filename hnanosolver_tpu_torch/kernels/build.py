"""Build and load the hand-written CUDA kernels of ``hnanosolver_tpu_torch/csrc``.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``),
one ``nvcc`` process per source, all started together, and the objects
are linked into ONE shared library with a plain C interface, loaded with
``ctypes``. No relocatable device code (``-rdc``) is needed: the grid
barrier of kernel B5 links without it. The build runs at the first kernel
launch of a process, from the sources in the checkout only, into
``build/hnanosolver_tpu_torch/`` at the repo root. The library's file name
carries a hash of the sources and the flags, so an edit to any source
rebuilds; ``nvcc.log`` beside it keeps the compiler's output (``-Xptxas
-v``: registers, shared memory, spills).

Each C entry takes device pointers, ints and floats plus the CUDA stream,
launches on that stream and returns ``cudaGetLastError()``; the Python
wrappers raise on a non-zero code.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "hnanosolver_tpu_torch"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry -> argument types (pointers and the stream as c_void_p, so
# ctypes does not cut them to 32 bits)
SIGNATURES = {
    "hn_bfecc_sample": (_P, _P, _P, _P, _I, _I, _I, _F, _F, _P),
    "hn_bfecc_sample_dual": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _P),
    "hn_sample_dual": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P),
    "hn_combine_dual": (_P, _P, _P, _I, _I, _I, _I, _P),
    "hn_bfecc_tail": (_P, _P, _P, _P, _P, _I, _I, _P),
    "hn_divergence": (_P, _P, _P, _I, _F, _P),
    "hn_subtract_gradient": (_P, _P, _P, _P, _I, _F, _P),
    "hn_sample_at": (_P, _P, _P, _P, _I, _I, _P),
    "hn_rbsor_lagged": (_P, _P, _P, _P, _P, _I, _I, _F, _F, _P),
    "hn_rbsor_color": (_P, _P, _P, _P, _I, _I, _F, _F, _P),
    "hn_rbsor_fused": (_P, _P, _P, _P, _P, _I, _I, _F, _F, _P),
    "hn_residual": (_P, _P, _P, _P, _I, _F, _P),
}


@dataclasses.dataclass
class LaunchCount:
    """Kernel launches made by one wrapper (only where it launches)."""

    name: str
    n: int = 0


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found (no nvcc): cannot build kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build() -> BuildInfo:
    """Compile the kernels unless a library for these sources exists."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"libhnanosolver_kernels_{source_hash()}.so"
    log_path = BUILD_DIR / "nvcc.log"
    if lib.exists():
        return BuildInfo(lib, 0.0, log_path.read_text() if log_path.exists() else "")
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for cu in sorted(CSRC.glob("*.cu")):
        obj = tmp.with_name(f"{tmp.name}.{cu.stem}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(obj), str(cu)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        out = proc.communicate()[0]
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(proc.returncode)
    if not failed:
        cmd = [nvcc, *ARCH, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append(res.returncode)
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    log = "\n".join(log)
    log_path.write_text(log)
    if failed:
        raise RuntimeError(f"nvcc failed ({failed}):\n{log}")
    os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    return BuildInfo(lib, seconds, log)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use in this process)."""
    lib = ctypes.CDLL(str(build().path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")


def stream_ptr(device) -> int:
    """The current CUDA stream of ``device`` as a raw handle (launch on the
    device's current stream, as PyTorch's own ops do)."""
    return torch.cuda.current_stream(device).cuda_stream


def require(t, name: str, shape: tuple, dtype, device) -> None:
    """Raise unless ``t`` has exactly this shape, dtype and device and is
    contiguous (what a kernel's raw pointer arithmetic assumes)."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def on_cpu(device) -> bool:
    """True for a CPU tensor (plain version); False for a CUDA tensor
    (kernel); raises for any other device."""
    if device.type == "cpu":
        return True
    if device.type == "cuda":
        return False
    raise ValueError(f"no kernel or plain version for device {device}")
