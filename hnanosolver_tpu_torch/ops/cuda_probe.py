"""Kernels PG (``csrc/probe_gather.cu``) and PC (``csrc/probe_copy.cu``):
the counterparts of the JAX package's TPU probe kernels in ``tools/``.

PG computes the cross-row gathers of ``tools/probe_dgather.py`` (P4-P6),
PC the asynchronous row copies of ``probe_dmabisect.py``,
``probe_dmabisect2.py`` and ``probe_dmacost.py`` (P7-P16), as
``ops/probe.py`` defines them; each is bitwise equal to its plain version
there. On a CPU tensor a wrapper runs the plain version; on a CUDA tensor
it launches the kernel or raises.

Shapes (``csrc/probe_gather.cu``, ``csrc/probe_copy.cu``):

- P4, :func:`take_along_rows`, in one of two forms chosen by the source's
  rows alone (:func:`along_rows_form`, not a fallback): "slab" (a block
  stages 8 columns of every source row in shared memory, 32 bytes a row)
  up to ``probe.SLAB_MAX_ROWS`` = 7,264 rows, which one block's 227 KB
  hold; "direct" (scalar loads from the L2) above it.
- P6, :func:`take_chain`: ``CHAIN_ROWS`` output rows a block, their six
  neighbour rows staged in shared memory (:func:`chain_smem_bytes`).
- PC, :func:`row_copy`: one warp of each block issues the copies, or one
  lane where a copy holds 8 rows or more (:func:`copy_issue_lanes`, chosen
  by span alone); with ``ctas`` > 1 each block writes its share of the
  stage by one bulk copy, a single block all of it by its threads; a plain
  launch for the device-memory source, a cluster of one for the on-chip
  source.
"""

from __future__ import annotations

from typing import Optional

import torch

from hnanosolver_tpu_torch.core.layout import TILE
from hnanosolver_tpu_torch.kernels import build
from hnanosolver_tpu_torch.ops import probe
from hnanosolver_tpu_torch.ops.probe import row_copy as row_copy_plain
from hnanosolver_tpu_torch.ops.probe import take_along_rows as take_along_rows_plain
from hnanosolver_tpu_torch.ops.probe import take_chain as take_chain_plain
from hnanosolver_tpu_torch.ops.probe import take_rows as take_rows_plain

launches_gather = build.LaunchCount("probe_gather")  # PG, all three forms
launches_copy = build.LaunchCount("probe_copy")  # PC

# hn_take_along_rows' form argument (csrc/probe_gather.cu AlongRowsForm)
ALONG_ROWS_FORMS = {"direct": 0, "slab": 1}
CHAIN_ROWS = 6  # P6's output rows a block (csrc/probe_gather.cu)
SERIAL_SPAN = 8  # PC: copies of this many rows or more go from one lane (csrc/probe_copy.cu)


def along_rows_form(Rx: int) -> str:
    """P4's form for a source of ``Rx`` rows: "slab" where one block's
    shared memory holds 8 columns of every row (``Rx <=
    probe.SLAB_MAX_ROWS``), else "direct"."""
    return "slab" if Rx <= probe.SLAB_MAX_ROWS else "direct"


def copy_issue_lanes(span: int) -> int:
    """The lanes of warp 0 that issue PC's copies of ``span`` rows, as
    ``csrc/probe_copy.cu`` chooses them: 32, or 1 for copies of SERIAL_SPAN
    rows (16 KB) or more, whose batches are at most 8 copies."""
    return 32 if span < SERIAL_SPAN else 1


def slab_smem_bytes(Rx: int) -> int:
    """Dynamic shared memory a block of P4's slab form takes."""
    return Rx * probe.SLAB_COLS * 4


def chain_smem_bytes() -> int:
    """Dynamic shared memory a block of P6 takes: the six neighbour rows of
    each of its ``CHAIN_ROWS`` output rows."""
    return CHAIN_ROWS * 6 * probe.ROW_BYTES


def _rows(x: torch.Tensor) -> int:
    if x.dim() != 2 or x.shape[0] < 1:
        raise ValueError(f"x: expected [R >= 1, {TILE}], got {tuple(x.shape)}")
    build.require(x, "x", (x.shape[0], TILE), torch.float32, x.device)
    return x.shape[0]


def _launch(entry: str, counter: build.LaunchCount, device, *args) -> None:
    with torch.cuda.device(device), counter.launch():
        code = getattr(build.library(), entry)(*args, build.stream_ptr(device))
        build.check(code, entry)


def take_along_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """PG, per-element form (P4): ``out[i, c] = x[idx[i, c], c]``. One launch,
    in the form :func:`along_rows_form` picks from x's rows."""
    Rx = _rows(x)
    if idx.dim() != 2 or idx.shape[0] < 1:
        raise ValueError(f"idx: expected [R >= 1, {TILE}], got {tuple(idx.shape)}")
    R = idx.shape[0]
    build.require(idx, "idx", (R, TILE), torch.int32, x.device)
    if build.on_cpu(x.device):
        return take_along_rows_plain(x, idx)
    build.require_aligned((x, idx), "take_along_rows", 16)
    out = torch.empty((R, TILE), dtype=torch.float32, device=x.device)
    _launch("hn_take_along_rows", launches_gather, x.device,
            x.data_ptr(), idx.data_ptr(), out.data_ptr(), R, Rx,
            ALONG_ROWS_FORMS[along_rows_form(Rx)])
    return out


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """PG, row form (P5): ``out[i, :] = x[idx[i], :]``. One launch."""
    Rx = _rows(x)
    if idx.dim() != 1 or idx.shape[0] < 1:
        raise ValueError(f"idx: expected [R >= 1], got {tuple(idx.shape)}")
    R = idx.shape[0]
    build.require(idx, "idx", (R,), torch.int32, x.device)
    if build.on_cpu(x.device):
        return take_rows_plain(x, idx)
    out = torch.empty((R, TILE), dtype=torch.float32, device=x.device)
    _launch("hn_take_rows", launches_gather, x.device,
            x.data_ptr(), idx.data_ptr(), out.data_ptr(), R, Rx)
    return out


def take_chain(x: torch.Tensor, nbr6: torch.Tensor, reps: int) -> torch.Tensor:
    """PG, chain form (P6): ``reps`` rounds of six face gathers added with
    weight 1e-30, all inside one launch."""
    T = _rows(x)
    build.require(nbr6, "nbr6", (6, T), torch.int32, x.device)
    if reps < 0:
        raise ValueError(f"reps {reps} < 0")
    if build.on_cpu(x.device):
        return take_chain_plain(x, nbr6, reps)
    build.require_aligned((x,), "take_chain", 16)
    out = torch.empty_like(x)
    _launch("hn_take_chain", launches_gather, x.device,
            x.data_ptr(), nbr6.data_ptr(), out.data_ptr(), T, reps)
    return out


def row_copy(src: torch.Tensor, rows: torch.Tensor, n: int, span: int = 1, reps: int = 1,
             step: int = 1, onchip_rows: int = 0, count: Optional[torch.Tensor] = None,
             ctas: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """PC (P7-P16): :func:`ops.probe.row_copy`, each copy one bulk
    asynchronous copy into shared memory issued by a lane of one warp of
    each of ``ctas`` blocks. One launch."""
    probe.check_copy_args(src, rows, n, span, reps, step, onchip_rows, count, ctas)
    for name, t in (("src", src), ("rows", rows), ("count", count)):
        if t is not None:
            build.require(t, name, tuple(t.shape), t.dtype, src.device)
    if build.on_cpu(src.device):
        return row_copy_plain(src, rows, n, span, reps, step, onchip_rows, count, ctas)
    stage = torch.empty((probe.STAGE_ROWS, TILE), dtype=torch.float32, device=src.device)
    acc = torch.empty(ctas, dtype=torch.float32, device=src.device)
    _launch("hn_row_copy", launches_copy, src.device,
            src.data_ptr(), src.shape[0], rows.data_ptr(), rows.numel(),
            0 if count is None else count.data_ptr(), n, span, step, reps, onchip_rows, ctas,
            stage.data_ptr(), acc.data_ptr())
    return stage, acc
