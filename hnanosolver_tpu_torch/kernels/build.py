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
-v``: registers, shared memory, spills), which :func:`parse_ptxas` reads
back per kernel instance with the warps each leaves resident on an SM.

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
import re
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import torch

from hnanosolver_tpu_torch.utils import profiling

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
    "hn_rbsor_fused": (_P, _P, _P, _P, _P, _I, _I, _F, _F, _I, _I, _I, _I, _P),
    "hn_residual": (_P, _P, _P, _P, _I, _F, _P),
    "hn_take_along_rows": (_P, _P, _P, _I, _I, _I, _P),
    "hn_take_rows": (_P, _P, _P, _I, _I, _P),
    "hn_take_chain": (_P, _P, _P, _I, _I, _P),
    "hn_grid_sync_loop": (_I, _I, _I, _P),
    "hn_cluster_sync_loop": (_I, _I, _I, _P),
    "hn_row_copy": (_P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    "hn_row_copy_parts": (_P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _I, _P, _P, _I, _P),
    "hn_mg_restrict": (_P, _P, _P, _P, _P, _I, _P),
    "hn_mg_prolong": (_P, _P, _P, _P, _P, _P, _P, _I, _P),
    "hn_enforce_collision": (_P, _P, _P, _P, _I, _F, _F, _F, _P),
    "hn_emit": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _F, _F, _F, _F, _F, _P),
    "hn_vorticity_confinement": (_P, _P, _P, _I, _I, _F, _F, _F, _P),
}


# H100 SM limits for the resident-warp count (CUDA occupancy rules for
# sm_90): registers are allocated per warp in units of 256, shared memory per
# block plus 1 KB the runtime reserves, out of 228 KB an SM
SM_REGISTERS = 65_536
SM_WARPS = 64
SM_BLOCKS = 32
SM_SHARED = 228 * 1024
BLOCK_SHARED_RESERVED = 1024
REG_ALLOC_UNIT = 256
# threads a block of each kernel, as its launch in csrc/ sets them
# (bfecc_sample.cu's kernels: block_threads)
BLOCK_THREADS = {
    "bfecc_tail_kernel": 512,
    "combine_dual_kernel": 512,
    "rbsor_lagged_kernel": 128,  # rbsor_lagged.cu: G * 32
    "rbsor_color_kernel": 256,
    "rbsor_fused_kernel": 256,
    # rbsor_fused.cu's cluster form: a warp a tile, one block an SM;
    # ops/cuda_pressure.py's fused_shape sets 32-512 threads by T (at most)
    "rbsor_cluster_kernel": 512,
    "residual_kernel": 128,  # residual.cu: G * 32
    "sample_at_kernel": 512,
    "divergence_kernel": 512,
    "subtract_gradient_kernel": 512,
    # the probe kernels PG (probe_gather.cu) and PC (probe_copy.cu)
    "take_along_rows_kernel": 256,
    "take_slab_kernel": 1024,
    "take_rows_kernel": 256,
    "take_chain_kernel": 192,  # CHAIN_ROWS * 32
    "row_copy_kernel": 256,
    # multigrid's transfers MR and MP (mg_transfer.cu)
    "mg_restrict_kernel": 256,  # MR_THREADS: a block a coarse tile
    "mg_prolong_kernel": 128,  # MP_WARPS * 32: a warp a fine tile
    # the collision's enforce pass CE (collision.cu): a block a tile
    "enforce_collision_kernel": 512,
    # the plume's emit EM (emit.cu): a block a tile, four voxels a thread
    "emit_kernel": 128,
    # the vorticity confinement VC (vorticity.cu): a block a tile, two voxels a thread
    "vorticity_kernel": 256,
}


def block_threads(instance: str) -> Optional[int]:
    """Threads a block of a kernel instance (``name<args>``), None if not
    listed. bfecc_sample.cu's NbrShape (bfecc_sample_kernel and
    bfecc_dual_kernel): 512 with the SDF probes (the last template
    argument), else 256; its PassShape (sample_dual_kernel<N, ...>): 128 for
    N <= 3 fields, else 256."""
    kernel, _, args = instance.partition("<")
    if kernel in ("bfecc_sample_kernel", "bfecc_dual_kernel"):
        return 512 if args.rstrip(">").endswith("true") else 256
    if kernel == "sample_dual_kernel":
        return 128 if int(args.split(",")[0]) <= 3 else 256
    return BLOCK_THREADS.get(kernel)


@dataclasses.dataclass(eq=False)
class LaunchCount(profiling.Count):
    """Kernel launches made by one wrapper (only where it launches), counted
    around each ctypes call by :meth:`launch`."""

    def __post_init__(self):
        self._span = "launch." + self.name
        self._quiet = _Quiet(self)

    def launch(self):
        """A context around one ctypes launch: it counts the launch on
        leaving without an error and, while spans record (see
        ``utils/profiling.span``), is the host span ``launch.<name>``."""
        if not profiling.tracing():
            return self._quiet
        return _Spanned(self, profiling.Span(self._span, {}))


class _Quiet:
    __slots__ = ("count",)

    def __init__(self, count: LaunchCount):
        self.count = count

    def __enter__(self):
        return None

    def __exit__(self, kind, value, tb):
        if kind is None:
            self.count.add()


class _Spanned(_Quiet):
    __slots__ = ("span",)

    def __init__(self, count: LaunchCount, span):
        self.count, self.span = count, span

    def __enter__(self):
        self.span.__enter__()

    def __exit__(self, kind, value, tb):
        self.span.__exit__(kind, value, tb)
        super().__exit__(kind, value, tb)


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float  # 0.0 when the library was already built
    log: str


@dataclasses.dataclass(frozen=True)
class KernelResources:
    """One kernel instance's resources as ``ptxas -v`` reports them."""

    name: str  # the kernel with its template arguments, e.g. rbsor_lagged_kernel<false>
    registers: int
    shared: int  # static shared memory, bytes
    spill_stores: int
    spill_loads: int
    threads: Optional[int]  # threads a block (block_threads), None if not listed

    def resident_warps(self, dynamic: int = 0) -> Optional[int]:
        """Warps of whole blocks an SM holds at once, the least of the
        register, shared-memory, warp and block limits, with ``dynamic``
        bytes of dynamic shared memory a block beside the static."""
        if self.threads is None:
            return None
        warps = -(-self.threads // 32)
        per_warp = -(-self.registers * 32 // REG_ALLOC_UNIT) * REG_ALLOC_UNIT
        blocks = min(SM_WARPS // warps, SM_BLOCKS,
                     (SM_REGISTERS // per_warp) // warps if per_warp else SM_BLOCKS,
                     SM_SHARED // (self.shared + dynamic + BLOCK_SHARED_RESERVED))
        return blocks * warps

    def line(self, dynamic: int = 0) -> str:
        warps = self.resident_warps(dynamic)
        resident = "?" if warps is None else f"{warps}/{SM_WARPS}"
        smem = f"{self.shared} B smem" + (f" + {dynamic} B dynamic" if dynamic else "")
        return (f"{self.name}: {self.registers} regs, {smem}, spills "
                f"{self.spill_stores}/{self.spill_loads} B (store/load), {self.threads} threads "
                f"a block -> {resident} resident warps an SM")


_TEMPLATE_ARG = re.compile(r"L([bij])(n?)(\d+)E")


def demangle(symbol: str) -> str:
    """``_ZN2hn19rbsor_lagged_kernelILb0EEEv...`` -> ``rbsor_lagged_kernel<false>``:
    the name after the namespace and its bool/int template arguments (enough
    for this library's kernels; another symbol comes back as it is)."""
    m = re.match(r"_Z(?:N2hn)?(\d+)", symbol)
    if not m:
        return symbol
    start = m.end()
    name = symbol[start:start + int(m.group(1))]
    rest = symbol[start + len(name):]
    if not rest.startswith("I"):
        return name
    args = []
    for kind, neg, val in _TEMPLATE_ARG.findall(rest[1:rest.index("EE") + 2]):
        v = int(val) * (-1 if neg else 1)
        args.append(("false", "true")[v] if kind == "b" else str(v))
    return f"{name}<{', '.join(args)}>"


def parse_ptxas(log: str) -> list[KernelResources]:
    """Every kernel instance of a ``-Xptxas -v`` log: registers, static
    shared memory and spill bytes, and its block size (:func:`block_threads`)."""
    out, name, spills = [], None, (0, 0)
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name, spills = demangle(m.group(1)), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name is not None:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and name is not None:
            smem = re.search(r"(\d+) bytes smem", ln)
            out.append(KernelResources(
                name, int(m.group(1)), int(smem.group(1)) if smem else 0, *spills,
                block_threads(name)))
            name = None
    return out


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


_LIBRARY_LOCK = threading.Lock()


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use in this process; the
    sharded step's threads build and load it once)."""
    with _LIBRARY_LOCK:
        return _load()


@functools.cache
def _load() -> ctypes.CDLL:
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


def require_aligned(tensors, name: str, align: int) -> None:
    """Raise unless every tensor (None skipped) starts on an ``align``-byte
    boundary (a kernel's vector loads assume it)."""
    for t in tensors:
        if t is not None and t.data_ptr() % align:
            raise ValueError(f"{name}: a tensor starts at {t.data_ptr():#x}, not on a "
                             f"{align}-byte boundary")


def on_cpu(device) -> bool:
    """True for a CPU tensor (plain version); False for a CUDA tensor
    (kernel); raises for any other device."""
    if device.type == "cpu":
        return True
    if device.type == "cuda":
        return False
    raise ValueError(f"no kernel or plain version for device {device}")


if __name__ == "__main__":
    # python -m hnanosolver_tpu_torch.kernels.build [NVCC_LOG]: the resource
    # report of a build log (default: this checkout's, building it first)
    import sys

    text = Path(sys.argv[1]).read_text() if len(sys.argv) > 1 else build().log
    for r in parse_ptxas(text):
        print(r.line())
