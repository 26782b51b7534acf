"""Kernel B11: the dual chunk table built from the 27-table (CUDA source
``csrc/combine_dual.cu``), and its plain PyTorch version.

Counterpart of ``hnanosolver_tpu/ops/pallas_bfecc.py::
build_table_dual_combine``: the half-shifted dual table of
``ops/tables.build_table_dual`` derived from a ``tables.build_table``
result through ``topo.chunk_dloc``, bitwise equal to ``build_table_dual``
(a copy, no arithmetic). ``COMBINE_TBL`` selects it in the table sampler,
as the JAX package's switch of that name does. On a CPU tensor the wrapper
runs the plain version; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from hnanosolver_tpu_torch.core.layout import TILE
from hnanosolver_tpu_torch.kernels import build
from hnanosolver_tpu_torch.ops.tables import dual_source

# Build the sampler's dual tables with B11 from the 27-table: True = yes,
# False/None = no (ops/tables.build_table_dual), the JAX package's default.
COMBINE_TBL: Optional[bool] = None

launches = build.LaunchCount("combine_dual")


def _check(tbl27, dloc, nf):
    if tbl27.dim() != 4 or dloc.dim() != 3 or nf < 1 or tbl27.shape[1] % nf:
        raise ValueError(f"tbl27 {tuple(tbl27.shape)}, dloc {tuple(dloc.shape)}, nf {nf}: "
                         "expected [nc, U*nf, 8, 64] and [nc, Ud, 8]")
    nc = tbl27.shape[0]
    build.require(tbl27, "tbl27", (nc, tbl27.shape[1], 8, 64), torch.float32, tbl27.device)
    build.require(dloc, "dloc", (nc, dloc.shape[1], 8), torch.int32, tbl27.device)


def build_table_dual_combine(tbl27: torch.Tensor, dloc: torch.Tensor, nf: int) -> torch.Tensor:
    """[nc, Ud*nf, 8, 64]: row u*nf + f, column l, is row
    ``dloc[c, u, j(l)]*nf + f`` of ``tbl27 [nc, U*nf, 8, 64]`` at column
    ``l ^ 292``. One launch."""
    _check(tbl27, dloc, nf)
    if build.on_cpu(tbl27.device):
        return build_table_dual_combine_plain(tbl27, dloc, nf)
    nc, Unf = tbl27.shape[:2]
    Ud = dloc.shape[1]
    out = torch.empty((nc, Ud * nf, 8, 64), dtype=torch.float32, device=tbl27.device)
    with torch.cuda.device(tbl27.device):
        code = build.library().hn_combine_dual(
            tbl27.data_ptr(), dloc.data_ptr(), out.data_ptr(), nc, Unf // nf, Ud, nf,
            build.stream_ptr(tbl27.device))
    build.check(code, "combine_dual")
    launches.n += 1
    return out


def build_table_dual_combine_plain(tbl27: torch.Tensor, dloc: torch.Tensor,
                                   nf: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`build_table_dual_combine`."""
    nc, Unf = tbl27.shape[:2]
    Ud = dloc.shape[1]
    j, src = dual_source(tbl27.device)
    rows = dloc.long()[:, :, j]  # [nc, Ud, 512]
    f = torch.arange(nf, device=tbl27.device)
    idx = (rows[:, :, None, :] * nf + f[None, None, :, None]) * TILE + src  # [nc, Ud, nf, 512]
    out = torch.gather(tbl27.reshape(nc, Unf * TILE), 1, idx.reshape(nc, -1))
    return out.reshape(nc, Ud * nf, 8, 64)
