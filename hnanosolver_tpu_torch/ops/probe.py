"""Plain PyTorch versions of the probe kernels PG and PC.

The JAX package's TPU probes (``tools/probe_dgather.py``,
``probe_dmabisect.py``, ``probe_dmabisect2.py``, ``probe_dmacost.py``)
asked whether a pressure solve could build its cross-tile halo on chip: by
an in-kernel cross-row gather, or by asynchronous row copies into a stage.
Their kernels compute the functions below; ``ops/cuda_probe.py`` launches
the hand-written kernels (``csrc/probe_gather.cu``, ``csrc/probe_copy.cu``)
and these are the plain versions they are held to. They run on any device
and launch no kernel of the port.

PG, cross-row gathers on ``[R, 512]`` float32 rows:

- :func:`take_along_rows` (``probe_dgather.py`` ``k_small``):
  ``out[i, c] = x[idx[i, c], c]``;
- :func:`take_rows` (``k_full``): ``out[i, :] = x[idx[i], :]``;
- :func:`take_chain` (``k_time``): ``s = x``, then ``reps`` times, for
  ``d = 0..5`` in that order, ``s = s + x[nbr6[d]] * 1e-30`` (gathered
  from ``x``, not from ``s``). A separate multiply and add, as the JAX
  kernel writes them: the kernel rounds both (no FMA).

Indices must lie in ``[0, rows of x)``: the kernels clamp them into that
range so that no address outside ``x`` is formed; these versions raise.

PC, :func:`row_copy`: ``n`` copies of ``span`` rows into a stage of
``STAGE_ROWS`` (64) rows, ``reps`` times, and one value read back per rep. The
TPU kernels issue their DMAs onto one semaphore and then drain them, so
where two copies write the same stage rows the result is unordered there.
This function fixes the order: within each rep the copies are issued in
batches of at most ``STAGE_ROWS // span``, and a batch completes before
the next one is issued, so every stage row ends with its last writer's
row.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from hnanosolver_tpu_torch.core.layout import TILE
from hnanosolver_tpu_torch.ops.shifts import FACE_DIRS, d_of

CHAIN_SCALE = 1e-30  # k_time's weight of each gathered face
STAGE_ROWS = 64  # the bisect probes' stage; probe_dmacost's 2056 rows are cut to it
ROW_BYTES = TILE * 4
# dynamic shared memory one H100 block may use (232,448 bytes)
SMEM_BYTES = 227 * 1024
# PG's per-element slab form stages SLAB_COLS columns of every source row
# (32 bytes: one sector) in one block's shared memory: it holds at most
# SLAB_MAX_ROWS (7,264) rows, and the direct form takes larger sources
SLAB_COLS = 8
SLAB_MAX_ROWS = SMEM_BYTES // (SLAB_COLS * 4)


def face_rows(nbr: torch.Tensor) -> torch.Tensor:
    """``[6, T]`` int32: the face-neighbour rows of every tile in the order
    +x -x +y -y +z -z (``probe_dgather.py:50``'s ``nbr6``)."""
    return torch.stack([nbr[:, d_of(off)] for off in FACE_DIRS]).contiguous()


def take_along_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[i, c] = x[idx[i, c], c]`` for ``idx`` int32 ``[R, 512]``."""
    return torch.gather(x, 0, idx.long())


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[i, :] = x[idx[i], :]`` for ``idx`` int32 ``[R]``."""
    return x[idx.long()]


def take_chain(x: torch.Tensor, nbr6: torch.Tensor, reps: int) -> torch.Tensor:
    """``reps`` rounds of ``s = s + x[nbr6[d]] * 1e-30`` for d = 0..5, from
    ``s = x``."""
    scale = torch.tensor(CHAIN_SCALE, dtype=x.dtype, device=x.device)
    s = x
    for _ in range(reps):
        for d in range(nbr6.shape[0]):
            s = s + x[nbr6[d].long()] * scale
    return s


def copy_smem_bytes(onchip_rows: int, n_rows: int) -> int:
    """Dynamic shared memory a block of PC takes: the stage, the on-chip
    source's rows, a table of ``n_rows`` row starts and the barrier."""
    return (STAGE_ROWS + onchip_rows) * ROW_BYTES + 16 * math.ceil(n_rows / 4) + 16


def max_onchip_rows(n_rows: int) -> int:
    """The most source rows one block can hold in shared memory beside the
    stage, a table of ``n_rows`` row starts and the barrier:
    :func:`row_copy`'s largest ``onchip_rows``."""
    return (SMEM_BYTES - copy_smem_bytes(0, n_rows)) // ROW_BYTES


def first_batch_covers(n: int, span: int, reps: int = 1) -> bool:
    """True when the first batch of :func:`row_copy`'s copies writes every
    stage row: its ``min(n, 64 // span)`` copies land in distinct slots
    (``step`` is prime to ``64 // span``), so it covers the stage exactly
    when ``n * span >= 64``. PC then skips zeroing the stage."""
    return reps > 0 and n * span >= STAGE_ROWS


def check_copy_args(src: torch.Tensor, rows: torch.Tensor, n: int, span: int, reps: int,
                    step: int, onchip_rows: int, count: Optional[torch.Tensor],
                    ctas: int) -> None:
    """Raise unless the arguments describe copies the kernel makes as
    :func:`row_copy` defines them (shapes, dtypes and the shared memory
    one block has)."""
    if src.dim() != 2 or src.shape[1] != TILE or src.dtype != torch.float32:
        raise ValueError(f"src: expected float32 [R, {TILE}], got {src.dtype} {tuple(src.shape)}")
    if rows.dim() != 1 or rows.dtype != torch.int32 or rows.numel() < 1:
        raise ValueError(f"rows: expected int32 [n_rows >= 1], got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    if count is not None and (count.dtype != torch.int32 or count.numel() != 1):
        raise ValueError("count: expected one int32 value")
    if span < 1 or STAGE_ROWS % span or not 0 <= n <= rows.numel() or reps < 0 or ctas < 1:
        raise ValueError(f"span {span}, n {n} of {rows.numel()} rows, reps {reps}, ctas {ctas}")
    if math.gcd(step, STAGE_ROWS // span) != 1:
        # the slots of one batch must be distinct for "last writer" to hold
        raise ValueError(f"step {step} is not prime to {STAGE_ROWS // span} slots")
    if src.shape[0] < max(span, onchip_rows) or 0 < onchip_rows < span:
        raise ValueError(f"src rows {src.shape[0]}, span {span}, onchip_rows {onchip_rows}")
    if onchip_rows > max_onchip_rows(rows.numel()):
        raise ValueError(f"stage {STAGE_ROWS} + on-chip {onchip_rows} rows exceed "
                         f"{SMEM_BYTES} bytes of shared memory")


def source_rows(src_rows: int, rows: torch.Tensor, span: int, onchip_rows: int) -> torch.Tensor:
    """The first source row of each copy: a row start taken mod
    ``onchip_rows - span + 1`` for the on-chip source (rows
    ``[0, onchip_rows)`` of ``src``), else clamped into ``[0, src_rows - span]``."""
    r = rows.long()
    if onchip_rows:
        return torch.remainder(r, onchip_rows - span + 1)
    return r.clamp(0, src_rows - span)


def row_copy(src: torch.Tensor, rows: torch.Tensor, n: int, span: int = 1, reps: int = 1,
             step: int = 1, onchip_rows: int = 0, count: Optional[torch.Tensor] = None,
             ctas: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """The stage ``[64, 512]`` and ``acc`` (float32 ``[ctas]``) of
    ``reps`` rounds of copies from ``src [R, 512]``.

    Copy ``i`` (``0 <= i < n``; ``n = count[0]`` clamped into
    ``[0, len(rows)]`` when a device-side ``count`` is given) writes source
    rows ``[s_i, s_i + span)`` (:func:`source_rows` of ``rows[i]``) into
    stage rows ``[(i * step * span) mod 64, ... + span)``. The stage
    starts at zero; after each rep ``r``, ``acc += stage[r mod 64,
    r mod 512]``. Every rep repeats the same copies, so the stage is the
    same after each. ``ctas`` blocks each compute the whole function: acc
    holds one value per block.
    """
    check_copy_args(src, rows, n, span, reps, step, onchip_rows, count, ctas)
    if count is not None:
        n = min(max(int(count[0]), 0), rows.numel())
    dev = src.device
    stage = torch.zeros(STAGE_ROWS, TILE, dtype=torch.float32, device=dev)
    if n and reps:
        i = torch.arange(n, device=dev)
        k = torch.arange(span, device=dev)
        dst = (((i * step * span) % STAGE_ROWS)[:, None] + k).reshape(-1)
        srow = (source_rows(src.shape[0], rows[:n], span, onchip_rows)[:, None] + k).reshape(-1)
        # copies later in the order overwrite earlier ones: the last writer wins
        last = torch.full((STAGE_ROWS,), -1, dtype=torch.long, device=dev).scatter_reduce(
            0, dst, torch.arange(n * span, device=dev), "amax")
        hit = last >= 0
        stage[hit] = src[srow[last[hit]]]
    acc = torch.zeros((), dtype=torch.float32, device=dev)
    for r in range(reps):
        acc = acc + stage[r % STAGE_ROWS, r % TILE]
    return stage, acc.repeat(ctas)
