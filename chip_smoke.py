#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (hnanosolver_tpu_torch) on one NVIDIA GPU and
check it end to end. Run from the repository root:

    python3 chip_smoke.py

It needs one CUDA card and the CUDA toolkit (nvcc); it builds the
hand-written kernels from ``hnanosolver_tpu_torch/csrc`` on first use. It
runs in 22 phases, one line per check, and any failing check raises (non-zero
exit). Each phase prints the seconds it took.

Each phase is one function, ``phase_<n>_<name>``, whose docstring says what
it checks. Its parameters are what it reads from earlier phases and it
returns what later phases read, so :func:`main`, which runs them in order,
is the map of which phase feeds which. Every phase shares one :class:`Card`:
the card's name and power limit, the kernels table and the phase clock. The
launches a step of each main path that the phases hold exactly are module
data (``RBGS50_STEP`` and the rest below).

Launch counts come only from the main-path runs (phases 4, 7-14, 16-22), each
with the counters set to 0 just before and read just after; launches made
to compare or time a kernel are not counted. A kernel's times in the JSON
line are per step of the path it serves (B1-B3, B7a, B7b, EM the bench
RBGS step, B4 the parity step, B5-B6 the bench MG step, B8 one RK4
advection with the SDF of the config-4 state, CE the config-4 step's four
enforce passes, B1d and B11 one table-path bench step in the narrow band with
COMBINE_TBL on, PG one row gather at the bench, PC one launch of
probe_dmacost's L = 8, n = 512, 8 reps on one block per SM; VC one fire512
frame's confinement, phase 3): per-launch
medians over runs of 10 back-to-back calls at the inputs recorded from one
such step, times that step's launches, beside the plain version's, a
library call's where there is one, and ``bound_ms`` (the H100 SXM data
sheet's 3.35 TB/s and 67 TFLOP/s). On the bench domain a launch's operands
fit the 50 MB L2 and stay there between back-to-back calls, as they largely
do in the step, so its HBM bound is not a floor on its time; only the
config-5 levels (551 MB a field at the fine one) and the bench's chunk
tables (133-353 MB a launch) are held to a true HBM bound. Phases 6, 7, 9,
14 and 15 print kernels' times beside their records from before their
redesign (``BEFORE_REDESIGN``). The cells come from
``hnanosolver_tpu_torch/cells.py``.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import os
import re
import shutil
import statistics
import struct
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import zlib
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from hnanosolver_tpu_torch import cli, solver
from hnanosolver_tpu_torch.cells import CELLS
from hnanosolver_tpu_torch.config import CombustionParams, SolverParams
from hnanosolver_tpu_torch.core import activation
from hnanosolver_tpu_torch.core import topology as topology_mod
from hnanosolver_tpu_torch.core.convert import tiles_to_dense
from hnanosolver_tpu_torch.core.layout import positions_flat
from hnanosolver_tpu_torch.core.topology import (active_mask, build_topology,
                                                 build_topology_dense, lookup_tiles)
from hnanosolver_tpu_torch.dense.solver import step_dense
from hnanosolver_tpu_torch.examples import fireball, smoke_to_nvdb, view_and_export
from hnanosolver_tpu_torch.fields import COLLISION_FIELD, FieldState, zeros_state
from hnanosolver_tpu_torch.io import vdb as vdb_io
from hnanosolver_tpu_torch.io.nvdb import read_nvdb
from hnanosolver_tpu_torch.io.state import load_npz
from hnanosolver_tpu_torch.kernels import build
from hnanosolver_tpu_torch.models import collider, fire, plume, solve
from hnanosolver_tpu_torch.ops import (advection, collision, combustion, cuda_bfecc,
                                       cuda_collision, cuda_emit, cuda_pressure, cuda_probe,
                                       cuda_sample, cuda_stencil, cuda_tables, cuda_tail,
                                       cuda_transfer, cuda_vorticity, multigrid, probe, stencil,
                                       tables)
from hnanosolver_tpu_torch.ops import pressure as prs
from hnanosolver_tpu_torch.parallel import boxes as pboxes
from hnanosolver_tpu_torch.parallel import slab as pslab
from hnanosolver_tpu_torch.parallel.mesh import make_mesh
from hnanosolver_tpu_torch.timing import median_ms, paired_ms, time_ms
from hnanosolver_tpu_torch.tools import (b1d_cost, b5_cost, ctas_all, pc_cost, probe_dgather,
                                         probe_dmabisect, probe_dmabisect2, probe_dmacost,
                                         repeat_check)
from hnanosolver_tpu_torch.tools import dense_spread as spread
from hnanosolver_tpu_torch.utils import phase_profile, profiling, timers
from hnanosolver_tpu_torch.utils.interrupt import Interrupter
from hnanosolver_tpu_torch.viewer import render, webapp

DEV = torch.device("cuda")
OUT = Path(__file__).resolve().parent / "build" / "chip_smoke"  # phases 16, 17 and 20 write here
MG_STEPS = 3  # multigrid steps on the bench domain
C2_FRAMES = 48  # config-2 plume frames from rest (growth every frame)
C3_FRAMES = 48  # config-3 fire frames from rest
BANDS = (("narrow", 1.5), ("mixed", 3.0), ("wide", 5.0))  # phase 14: CFL per band
C5_MG_STEPS = 2  # counted multigrid steps at config 5
SEED = 0
# phase 16, the cook on user files: frames (a checkpoint at half of them),
# the passthrough Vec3 grid of the feedback and its leaves, the collision
# SDF's grid name and its narrow band (voxels; the file's background)
COOK_FRAMES = 6
COOK_EXTRA, COOK_EXTRA_LEAVES = "vel_extra", 512
COOK_SDF, COOK_BAND = "collider", 3.0
# Tolerances, kernel vs its plain version on the card. The kernels use
# round-to-nearest intrinsics in the plain version's op order, so bitwise
# agreement is the expected outcome; the allowances below cover ulp-level
# drift (e.g. a different floor/convert path) and its amplification:
# B1's forward sample sits at a re-traced position whose ulp error is
# multiplied by the field's gradient.
TOL_B1 = 1e-5  # max abs err / max |ref|
TOL_B3 = 1e-5  # max abs err / max |ref|, 10 launches of 5 pairs (also B4; B2, B5, B6: 0)
TOL_STEP = 1e-4  # per field, one full step from the developed state
C5_RMAX_OVER_DIV0 = 0.1  # SCALE_r05.md's convergence criterion
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, HBM3
F32_OPS_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores
L2_BYTES = 50e6  # H100 SXM L2 cache
C4_SHELL_VDOTN = 0.35  # median |u.n|/|u| on the shell (tests/test_collision.py)
KEYS = ("B1", "B2", "B3", "B4", "B5", "B6", "B7a", "B7b", "B8", "B1d", "B11", "PG", "PC", "MR",
        "MP", "CE", "EM", "VC")
# kernels held to torch.equal with their plain versions
BITWISE = ("B5", "B6", "MR", "MP", "CE", "EM", "VC")
PROBE_ROUNDS = 2  # timing rounds of each probe script in phase 15
# Records from before kernels were redesigned (PERF.md §5-6, NVIDIA H100 80GB
# HBM3 at 700 W), printed beside this run's: ms a step of the bench and
# config-5 RBGS-50 steps and B1's and B3's ms a step of each (config 5:
# device time from torch.profiler); B5's and B6's ms a step of the bench and
# config-5 MG steps and the config-5 MG step's ms, as chip_smoke measured
# them before B5 and B6 were redesigned
BEFORE_REDESIGN = {"bench step": 1.723, "c5 RBGS-50 step": "74.3-74.9",
                   "bench": {"B1": 0.1861, "B3": 0.4094}, "c5": {"B1": 10.3766, "B3": 20.4623},
                   "bench MG": {"B5": 0.6590, "B6": 0.0684},
                   "c5 MG": {"B5": 1.731, "B6": 4.767}, "c5 MG step": 155.1,
                   # B1d's launches alone (tools/b1d_cost.py on the design before, ms):
                   # the narrow step's two, the mixed band's back and fwd
                   "table": {"narrow B1d": 0.1809, "mixed back nb=3": 0.0426,
                             "mixed fwd nb=3": 0.0416, "mixed back nb=8": 0.0826,
                             "mixed fwd nb=8": 0.0559},
                   # the probe kernels PG and PC, chip_smoke phase 15 (ms a call)
                   "probes": {"P4 8 rows": 0.0038, "P4 4608 rows": 0.0231,
                              "P6 reps 4, normal": 0.0490, "P6 reps 24, normal": 0.2648,
                              "P6 reps 4, mixed scales": 0.0482,
                              "P6 reps 24, mixed scales": 0.2605,
                              "PC JSON launch": 0.6306, "PC v5": 0.0058}}
B5_LEVELS = (32, 128, 1024)  # the rows of every level B5 solves on the main paths
# phase 3, CE at the benchmark's collider1024 (benchmark/configs/collider1024.json):
# the sphere, the frames of a cook its shell is kept for, (tiles, capacity)
COL1024 = dict(center0=(416.0, 384.0, 512.0), velocity=(192.0, 0.0, 0.0), radius=48.0)
COL1024_FRAMES = 48
COL1024_ROWS = (273_289, 273_408)
# phase 3, VC at the benchmark's fire512 (benchmark/configs/fire512.json): the
# envelope (radius, height, centre x and z, voxels), its (tiles, capacity),
# and the offsets VC is held to its plain version at
FIRE512 = (128, 512, 256, 256)
FIRE512_ROWS = (33_656, 33_792)
VC_OFFSETS = (1, 2, 7, -1)
# phase 19: slabs on one card, the mg_tol run's tolerance and V-cycle cap,
# and the one-device config-5 RBGS-50 step's peak (PERF.md section 5,
# phase 18, NVIDIA H100 80GB HBM3 at 700 W)
SLABS, MG_TOL, MG_TOL_CAP = 4, 1e-3, 8
SLAB_SWEEP = (1, 2, 4)  # slabs on one card of phase 19's sweep
C5_STEP_PEAK_GIB = 27.16
CHAIN_STEPS = 5  # phase 19: consecutive sharded MG + FMG + mg_tol steps
# phase 20, the dense oracle: the boxes (voxels an edge), the traces' max CFL
# (max|u| dt/dx: past a tile seam, below the clamp's 3.5), the JAX parity
# test's absolute tolerance at its parameters and, at the bench's, a
# tolerance relative to each field's max|.| (set in PERF.md section 6 before
# the phase first ran on a card)
DENSE_BOXES = (128, 256)
DENSE_SEEDS = (SEED, 1, 2, 3, 4)  # the first runs every case, the rest the vorticity test case
DENSE_CFL = 2.0
TOL_DENSE_ABS = 2e-4
TOL_DENSE_REL = 1e-4
# phase 21, the repeat check: tools/repeat_check's box and the repeats of
# its first offset magnitude
REPEAT_N = 128
NARROW_REPEATS = 8
# phase 22: plume steps that develop the bench state from rest, and the chains
# captured as CUDA graphs (bench.py's chain lengths)
GRAPH_DEVELOP = 2
CHAINS = (2, 12)

# Launches a step of each main path that the phases hold exactly
# (tests/test_torch_chip_smoke.py holds them to the program's dispatch on
# the CPU). Each plume step emits once (EM, models/plume.emit). RBGS-50 at
# halo_lag 5 above MAX_FUSED_ROWS rows: 50 // 5 B3 blocks (the bench,
# config 5; phases 4, 9, 18 and 22).
RBGS50_STEP = {"B1": 2, "B2": 2, "B3": 10, "B7a": 1, "B7b": 1, "EM": 1}
# halo_lag 1, the "parity" tier (phase 8): two B4 colour sweeps an iteration
PARITY_STEP = {"B1": 2, "B2": 2, "B4": 100, "B7a": 1, "B7b": 1, "EM": 1}
# Config 4 (phase 10): with the SDF, four CE (collide.enforces)
C4_STEP = {**RBGS50_STEP, "CE": 4}
# The bench MG step (phase 7; mg_levels 2, iterations = 2 V-cycles, FMG,
# n_pre = n_post = 2, n_coarsest 24, smooth_lag "pair"): the fine level
# (4608 rows) is above MAX_FUSED_ROWS, so each smoothing call is n_pre = 2
# one-pair B3 blocks; level 1 (1024 rows) and level 2 (128) take one B5 per
# solve. A V-cycle from the fine level: B3 2 + 2, B6 at fine and level 1, B5
# at level 1 pre and post and the level-2 solve: B3 4, B5 3, B6 2. A V-cycle
# from level 1: B5 3, B6 1. FMG: the level-2 solve (B5 1), the level-1
# V-cycle, the fine V-cycle: B3 4, B5 7, B6 3. Then 2 V-cycles: B3 8, B5 6,
# B6 4. Per step: B1 2, B2 2, B3 12, B5 13, B6 7. The transfers: a V-cycle
# from level k restricts and prolongs once a level below k, FMG restricts to
# each level once more and prolongs each solution up once: MR and MP 2 + (1
# + 2) + 2 * 2 = 9 each.
BENCH_MG_STEP = {"B1": 2, "B2": 2, "B3": 12, "B5": 13, "B6": 7, "B7a": 1, "B7b": 1, "MR": 9,
                 "MP": 9, "EM": 1}
# The config-5 MG step (phase 9; mg_levels 5): fine 269,312, L1 45,056 and
# L2 6,144 rows smooth with one-pair B3 blocks (L1, L2 masked); L3 1,024, L4
# 128, L5 32 rows with one B5 per solve. A V-cycle from level k visits
# levels k..4 (pre + post smoothing and one B6 each) and solves level 5 (B5
# 1): from the fine level B3 12, B5 5, B6 5. FMG: the level-5 solve, then
# one V-cycle from each level 4..0: B3 0+0+4+8+12, B5 1+3+5+5+5+5, B6
# 1+2+3+4+5. With 2 V-cycles: B3 48, B5 34, B6 25 (B1 2, B2 2). MR and MP:
# FMG 5 + (1+2+3+4+5), the V-cycles 2 x 5: 30 each (level k k + 3).
C5_MG_STEP = {"B1": 2, "B2": 2, "B3": 48, "B5": 34, "B6": 25, "B7a": 1, "B7b": 1, "MR": 30,
              "MP": 30, "EM": 1}


def rel_err(got, want) -> tuple[float, float]:
    """(max abs err, max abs err / max |want|)."""
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    return err, err / scale if scale else err


def nbytes(x) -> int:
    if isinstance(x, (tuple, list)):
        return sum(nbytes(v) for v in x)
    return x.numel() * x.element_size() if hasattr(x, "numel") else 0


def ops_per_voxel(key: str, args: tuple, kwargs: dict) -> float:
    """f32 operations per voxel of one launch, counted from the kernel's
    source: trilinear sample of n fields 15 + 8 * (2 + 2n); SOR update 11;
    residual 9; BFECC tail 19 per field; divergence 6; u - grad p 9; an SDF
    probe one sample of one field and a compare."""
    def sample(n):
        return 15 + 8 * (2 + 2 * n)

    if key == "B11":
        return 0.0  # a copy
    if key == "B1d":
        nb, f_lo, mode, sdf = b1d_mode(args, kwargs)
        if mode == "fwd":
            return float(sample(nb - f_lo))
        if mode == "back":
            return 6 + float(sample(nb - f_lo))
        return 18 + sample(nb) + sample(nb - f_lo) + (2 * (sample(1) + 1) if sdf else 0)
    if key == "B1":
        nb, f_lo = args[1].shape[0], args[3]
        sdf = args[4] if len(args) > 4 else kwargs.get("sdf")
        probes = 0 if sdf is None else 2 * (sample(1) + 1)
        return 18 + sample(nb) + sample(nb - f_lo) + probes
    if key == "B7a":
        return 6.0
    if key == "B7b":
        return 9.0
    if key == "B8":
        return float(sample(args[1].shape[0]))
    if key == "B2":
        return 19.0 * args[1].shape[0]
    if key == "B3":
        return 11.0 * args[3] + 1
    if key == "B4":
        return 5.5  # half the voxels update
    if key == "B5":
        return 11.0 * args[2]
    if key == "MR":  # a coarse voxel: 7 adds, the 1/8, 8 + 1 mask products
        return 8.0 + 8 * (args[2] is not None) + (args[3] is not None)
    if key == "MP":  # a fine voxel: 7 blends of 3 operations, the add, the mask
        return 21.0 + (args[4] is not None) + (args[5] is not None)
    if key == "CE":  # the SDF's gradient, its length and normal, the blend, the projection
        return 40.0
    if key == "EM":  # the squared distance 8, its compare, density 2, fuel 3, temperature 1
        return 15.0
    if key == "VC":  # benchmark/metrics/vorticity_roofline.py's count
        return 154.0
    return 9.0  # B6


def b1d_mode(args: tuple, kwargs: dict) -> tuple:
    """(nb, f_lo, mode, has_sdf) of a recorded B1d call."""
    mode = args[6] if len(args) > 6 else kwargs.get("mode", "both")
    sdf = args[7] if len(args) > 7 else kwargs.get("has_sdf", False)
    return args[4], args[5], mode, sdf


def call_label(key: str, args: tuple) -> str:
    if key == "B1d":
        nb, f_lo, mode, sdf = b1d_mode(args, {})
        return f"T={rows(key, args)} {mode} nb={nb} f_lo={f_lo}{' + SDF' if sdf else ''}"
    return f"nc={args[0].shape[0]} nf={args[2]}" if key == "B11" else f"T={rows(key, args)}"


def rows(key: str, args: tuple) -> int:
    """The tile rows one launch works on (the table kernels' first argument
    is a chunk table: B1d's rows are those of its ldual)."""
    return args[1].shape[0] if key == "B1d" else args[0].shape[0]


def b11_read_bytes(dloc, nf: int) -> int:
    """The 27-table bytes B11 must read: dest octant j of dual row u copies
    one octant (64 values) of row dloc[c, u, j] of each field, and no two
    entries of a chunk pick the same octant of a non-null row (tile s is
    source j of dual tile s + 1 - b_j alone); zero entries (absent sources,
    padding dual rows) all read the chunk's null row, counted once."""
    octant = 64 * 4
    return int((dloc != 0).sum()) * nf * octant + dloc.shape[0] * nf * 8 * octant


def bound_ms(key: str, args: tuple, kwargs: dict, out_bytes: int) -> tuple[float, str, int]:
    """The least time the card could take for one launch: (ms, bound by,
    bytes moved). Each input is read once and each output (``out_bytes``)
    written once; B11's reads are the table values its dloc picks (the data
    decides them): :func:`b11_read_bytes`; VC's the velocity alone (its nbr
    left out, as ``benchmark/metrics/vorticity_roofline.py`` counts)."""
    seen, moved = set(), 0
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, torch.Tensor) and a.data_ptr() not in seen:
            seen.add(a.data_ptr())
            moved += nbytes(a)
    if key == "B11":  # it reads each distinct 27-table value it copies once
        moved = nbytes(args[1]) + b11_read_bytes(args[1], args[2])
    if key == "B1d":  # the dual rows its ldual names, the fields its mode samples
        moved += b1d_cost.read_bytes(args[0], args[1], *b1d_mode(args, kwargs)) - nbytes(args[0])
    if key == "VC":  # the velocity alone, as vorticity_roofline.py counts it
        moved = nbytes(args[1])
    moved += out_bytes
    ops = ops_per_voxel(key, args, kwargs) * rows(key, args) * 512
    t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes", moved) if t_bytes >= t_ops else (t_ops, "operations", moved)


def kernel_table() -> dict:
    """The hand-written kernels by key: what the JSON line prints of each,
    its launch counter, its wrapper and its plain version."""
    jax, xla = "hnanosolver_tpu/ops/", "none (XLA computed the "
    rows_ = (  # key, name, source in csrc/, what it replaces, counter, wrapper
        ("B1", "bfecc_sample", "bfecc_sample.cu", jax + "pallas_bfecc.py:303",
         cuda_bfecc.launches, cuda_bfecc, "bfecc_sample"),
        ("B2", "bfecc_tail", "bfecc_tail.cu", jax + "pallas_tail.py:85", cuda_tail.launches,
         cuda_tail, "bfecc_tail"),
        ("B3", "rbsor_lagged", "rbsor_lagged.cu", jax + "pallas_pressure.py:199",
         cuda_pressure.launches_lagged, cuda_pressure, "rbsor_lagged"),
        ("B4", "rbsor_color", "rbsor_color.cu", jax + "pallas_pressure.py:290",
         cuda_pressure.launches_color, cuda_pressure, "rbsor_color"),
        ("B5", "rbsor_fused", "rbsor_fused.cu", jax + "pallas_pressure.py:356",
         cuda_pressure.launches_fused, cuda_pressure, "rbsor_fused"),
        ("B6", "residual", "residual.cu", jax + "pallas_stencil.py:184",
         cuda_stencil.launches_residual, cuda_stencil, "residual"),
        ("B7a", "divergence", "stencil.cu", jax + "pallas_stencil.py:89",
         cuda_stencil.launches_div, cuda_stencil, "divergence"),
        ("B7b", "subtract_gradient", "stencil.cu", jax + "pallas_stencil.py:151",
         cuda_stencil.launches_subgrad, cuda_stencil, "subtract_gradient"),
        ("B8", "sample_at", "sample_at.cu", f"{jax}pallas_interp2.py:54, {jax}pallas_interp.py:51",
         cuda_sample.launches, cuda_sample, "sample_at"),
        ("B1d", "bfecc_sample_dual", "bfecc_sample.cu",
         jax + "pallas_bfecc.py:303 (use_dual, :899-913, :974-984)", cuda_bfecc.launches_dual,
         cuda_bfecc, "bfecc_sample_dual"),
        ("B11", "combine_dual", "combine_dual.cu", jax + "pallas_bfecc.py:676",
         cuda_tables.launches, cuda_tables, "build_table_dual_combine"),
        ("PG", "probe_gather", "probe_gather.cu", "tools/probe_dgather.py:59, :79, :109",
         cuda_probe.launches_gather, cuda_probe, "take_rows"),
        ("PC", "probe_copy", "probe_copy.cu", "tools/probe_dmabisect.py:39, :164; "
         "tools/probe_dmabisect2.py:59, :81, :113, :149, :184, :222; tools/probe_dmacost.py:89, "
         ":134", cuda_probe.launches_copy, cuda_probe, "row_copy"),
        ("MR", "mg_restrict", "mg_transfer.cu", xla + f"transfers: {jax}multigrid.py restrict)",
         cuda_transfer.launches_restrict, cuda_transfer, "restrict"),
        ("MP", "mg_prolong", "mg_transfer.cu",
         xla + f"transfers: {jax}multigrid.py prolong_trilinear)", cuda_transfer.launches_prolong,
         cuda_transfer, "prolong_trilinear"),
        ("CE", "enforce_collision", "collision.cu",
         xla + f"collision: {jax}collision.py enforce_collision)", cuda_collision.launches,
         cuda_collision, "enforce_collision"),
        ("EM", "emit", "emit.cu", xla + "emit, hnanosolver_tpu/models/plume.py:72)",
         cuda_emit.launches, cuda_emit, "emit"),
        ("VC", "vorticity_confinement", "vorticity.cu",
         xla + "confinement, hnanosolver_tpu/ops/stencil.py:153)", cuda_vorticity.launches,
         cuda_vorticity, "vorticity_confinement"),
    )
    kernels = {key: dict(name=name, source="hnanosolver_tpu_torch/csrc/" + src, replaces=rep,
                         counter=counter, wrap=(mod, attr), route="cuda", launches=0,
                         max_abs_err=0.0, library_ms=None, kernel_fn=getattr(mod, attr),
                         plain_fn=getattr(mod, attr + "_plain"))
               for key, name, src, rep, counter, mod, attr in rows_}
    # B1d's wrapper checks the window on the host (one sync) before it
    # launches: its time is the launch alone (b1d_cost.kernel_call), the
    # wrapper's printed beside it. B11's library call: one torch.gather of
    # the 27-table over the index its plain version builds, built beforehand.
    kernels["B1d"]["launch"] = lambda a, kw: b1d_cost.kernel_call(*a, **kw)
    kernels["B11"]["library"] = b11_gather
    return kernels


def b11_gather(a, kw):
    idx = cuda_tables.combine_index(a[1], a[2])
    flat = a[0].reshape(a[0].shape[0], -1)
    out = torch.empty(idx.shape, device=flat.device)
    return lambda: torch.gather(flat, 1, idx, out=out)


class Card:
    """What every phase shares: the card's name and power limit as
    nvidia-smi gives them (``str(card)``, printed beside every time), the
    kernels table (:func:`kernel_table`) and the phase clock."""

    def __init__(self, label: str, start: float):
        self.label, self.kernels, self.start = label, kernel_table(), start

    def __str__(self) -> str:
        return self.label

    def done(self, phase: str) -> None:
        """Print the seconds since the previous phase ended."""
        now = time.perf_counter()
        print(f"[{phase}] phase took {now - self.start:.1f} s", flush=True)
        self.start = now

    def counts(self) -> dict:
        """Every kernel's launch counter, now."""
        return {key: k["counter"].n for key, k in self.kernels.items()}


def check(card, key, label, got, want, tol=TOL_B3, phase="3"):
    torch.cuda.synchronize()
    err, rel = rel_err(got, want)
    bitwise = bool(torch.equal(got, want))
    card.kernels[key]["max_abs_err"] = max(card.kernels[key]["max_abs_err"], err)
    print(f"[{phase}] {key} {label}: max abs err {err:.3e}, rel {rel:.3e} (tol {tol:g}),"
          f" bitwise {bitwise}", flush=True)
    if not rel <= tol:
        raise AssertionError(f"phase {phase}: {key} {label} rel err {rel} > {tol}")
    if key in ("MR", "MP", "CE", "EM", "VC") and not bitwise:
        raise AssertionError(f"phase {phase}: {key} {label} is not bitwise its plain version")


@contextlib.contextmanager
def main_path(card, label: str, per_step, steps: int = 1):
    """Counters to 0 just before the run, read just after; the counts
    must be exactly ``per_step`` times ``steps`` (``per_step`` a
    callable: the run's total counts, asked after the run)."""
    for k in card.kernels.values():
        k["counter"].n = 0
    torch.cuda.synchronize()
    yield
    torch.cuda.synchronize()
    counts = card.counts()
    if callable(per_step):
        per_step, steps = per_step(), 1
    want = {key: per_step.get(key, 0) * steps for key in KEYS}
    for key, k in card.kernels.items():
        k["launches"] += counts[key]
    print(f"[{label}] launches {counts} (expected {want})", flush=True)
    if counts != want:
        raise AssertionError(f"phase {label}: launch counts {counts} != {want}")


def check_state(label, topo_, state):
    fields = {"velocity": state.velocity, **state.scalars}
    bad = [name for name, f in fields.items()
           if not bool(torch.isfinite(f).all())
           or bool(f[..., 0, :].any()) or bool(f[..., topo_.n_active + 1:, :].any())]
    if bad:
        raise AssertionError(f"phase {label}: non-finite or non-zero background in {bad}")
    if not float(state.scalars["density"].max()) > 0:
        raise AssertionError(f"phase {label}: the emitter sourced no density")


def plain_versions(card):
    """Every kernel wrapper replaced by its plain version."""
    stack = contextlib.ExitStack()
    for k in card.kernels.values():
        mod, attr = k["wrap"]
        stack.enter_context(mock.patch.object(mod, attr, k["plain_fn"]))
    return stack


def field_errors(got, want, bitwise: bool = False) -> tuple[float, list]:
    """(the largest, one "name err" a field) of state ``got``'s relative
    errors against ``want``, marked bitwise where ``bitwise`` asks and holds."""
    worst, parts = 0.0, []
    for name in ["velocity"] + sorted(got.scalars):
        g = got.velocity if name == "velocity" else got.scalars[name]
        w = want.velocity if name == "velocity" else want.scalars[name]
        _, rel = rel_err(g, w)
        worst = max(worst, rel)
        parts.append(f"{name} {rel:.2e}"
                     + (" (bitwise)" if bitwise and torch.equal(g, w) else ""))
    return worst, parts


def step_vs_plain(card, label, run, out_k=None):
    """``run`` again with every wrapper replaced by its plain version (the
    patches are module-global, so the sharded step's threads see them
    too): no kernel may launch, every field within TOL_STEP of ``out_k``
    (``run``'s own output through the kernels where not given). Returns
    the plain run's output."""
    if out_k is None:
        out_k = run()
    before = card.counts()
    with plain_versions(card):
        out_p = run()
    torch.cuda.synchronize()
    if card.counts() != before:
        raise AssertionError(f"phase {label}: the plain step launched a kernel")
    worst, parts = field_errors(out_k, out_p)
    print(f"[{label}] one step, kernels vs plain on the card, max rel err per field: "
          f"{', '.join(parts)} (tol {TOL_STEP:g})", flush=True)
    if not worst <= TOL_STEP:
        raise AssertionError(f"phase {label}: step rel err {worst} > {TOL_STEP}")
    return out_p


def record(card, run, keys) -> list:
    """Run ``run`` once with the wrappers of ``keys`` recording their
    calls: [key, args, kwargs, output bytes, count] per distinct call
    (the first one's inputs are kept)."""
    def sig(key, args, kwargs):
        def one(a):
            return (tuple(a.shape), a.dtype) if isinstance(a, torch.Tensor) else a
        return (key, tuple(one(a) for a in args),
                tuple(sorted((n, one(v)) for n, v in kwargs.items())))

    groups = {}
    with contextlib.ExitStack() as stack:
        for key in keys:
            def rec(*a, _fn=card.kernels[key]["kernel_fn"], _key=key, **kw):
                out = _fn(*a, **kw)
                groups.setdefault(sig(_key, a, kw), [_key, a, kw, nbytes(out), 0])[4] += 1
                return out
            stack.enter_context(mock.patch.object(*card.kernels[key]["wrap"], rec))
        run()
    torch.cuda.synchronize()
    return list(groups.values())


def vs_plain(card, label, key, a, kw):
    """One recorded call through the kernel and through its plain
    version (B4, which updates p in place, each on its own copy)."""
    def inputs():
        if key != "B4":
            return a
        return [x.clone() if isinstance(x, torch.Tensor) else x for x in a]

    k = card.kernels[key]
    got, want = k["kernel_fn"](*inputs(), **kw), k["plain_fn"](*inputs(), **kw)
    if not isinstance(got, tuple):
        got, want = (got,), (want,)
    tol = TOL_B1 if key in ("B1", "B8", "B1d") else 0.0 if key in BITWISE else TOL_B3
    for g, w in zip(got, want):
        check(card, key, f"main-path call {call_label(key, a)}", g, w, tol, label)
    if key in ("MR", "MP"):
        transfer_forms(card, label, key, a)


def transfer_forms(card, label, key, a, name=""):
    """MR or MP on the operands ``a`` in each of its forms: each of its
    two optional operands (MR's fine and coarse masks, MP's p and mask)
    given or left out, bitwise the plain version."""
    k, head, opt = card.kernels[key], a[:-2], a[-2:]
    for use in ((0, 0), (1, 0), (0, 1), (1, 1)):
        if any(u and o is None for u, o in zip(use, opt)):
            continue
        ops = [o if u else None for u, o in zip(use, opt)]
        form = ", ".join(f"{n} {'given' if u else 'none'}" for n, u in
                         zip(("fine mask", "coarse mask") if key == "MR" else ("p", "mask"),
                             use))
        check(card, key, f"{name}{call_label(key, a)}: {form}", k["kernel_fn"](*head, *ops),
              k["plain_fn"](*head, *ops), 0.0, label)


def time_calls(card, label: str, groups: list, plain: bool = True) -> dict:
    """Each recorded call against its plain version on the same inputs,
    then per-step kernel, plain and bound ms: one timed launch per
    distinct call, times its count. ``plain=False`` times the kernels
    alone."""
    res = {}
    for key, a, kw, out_bytes, count in groups:
        k = card.kernels[key]
        vs_plain(card, label, key, a, kw)
        launch = k["launch"](a, kw) if "launch" in k else lambda: k["kernel_fn"](*a, **kw)
        if plain:
            k_ms, p_ms = paired_ms(launch, lambda: k["plain_fn"](*a, **kw))
        else:
            k_ms = median_ms(launch, 5, 10)  # behind the spin
            p_ms = float("nan")
        b_ms, by, moved = bound_ms(key, a, kw, out_bytes)
        r = res.setdefault(key, dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bound_by={}))
        r["ms"] += k_ms * count
        r["plain_ms"] += p_ms * count
        r["bound_ms"] += b_ms * count
        r["bound_by"][by] = r["bound_by"].get(by, 0.0) + b_ms * count
        extra = ""
        if "launch" in k:  # the wrapper with its host work, as the path calls it
            w_ms = median_ms(lambda: k["kernel_fn"](*a, **kw), 10, 10)
            r["wrapper_ms"] = r.get("wrapper_ms", 0.0) + w_ms * count
            extra += f", {w_ms:.4f} ms through the wrapper"
        if "library" in k:
            l_ms = median_ms(k["library"](a, kw), 10, 10)
            r["library_ms"] = r.get("library_ms", 0.0) + l_ms * count
            extra += f", {l_ms:.4f} ms library"
        in_l2 = " (operands fit the L2: HBM bound)" if moved <= L2_BYTES else ""
        print(f"[{label}] {key} {call_label(key, a)} x{count}/step: {k_ms:.4f} ms kernel,"
              f" {p_ms:.4f} ms plain{extra}, bound {b_ms:.4f} ms ({by}, {moved / 1e6:.1f} "
              f"MB){in_l2} per launch | {card}", flush=True)
    for key, r in res.items():
        r["bound_by"] = max(r["bound_by"], key=r["bound_by"].get) if r["bound_by"] else "bytes"
        extra = "".join(f", {r[x]:.4f} {x[:-3]}" for x in ("wrapper_ms", "library_ms")
                        if x in r)
        print(f"[{label}] {key} {card.kernels[key]['name']}: {r['ms']:.4f} ms/step kernel vs "
              f"{r['plain_ms']:.4f} plain{extra}, bound {r['bound_ms']:.4f} "
              f"({r['bound_by']}, {r['bound_ms'] / r['ms']:.1%} of the kernel's time) | "
              f"{card}", flush=True)
    return res


def path_timed(card, label: str, step, runs: int, keys: tuple) -> tuple[float, list, dict]:
    """A path's ms a step (median of ``runs`` after a warm-up), then each
    call of ``keys`` in one step vs plain and timed (:func:`time_calls`).
    Returns (ms a step, the recorded calls, time_calls' results)."""
    step()
    ms = statistics.median(time_ms(step, runs))
    groups = record(card, step, keys)
    return ms, groups, time_calls(card, label, groups)


def fit_b5(card, label: str, groups: list):
    """B5's us a half-sweep and a launch, fitted from 2 and 24 iterations
    (tools/b5_cost.fit), in each form that holds T, at each T of a path's
    recorded calls, on their inputs."""
    seen = set()
    for key, a, kw, _, _ in groups:
        T_ = a[0].shape[0]
        if key != "B5" or T_ in seen:
            continue
        seen.add(T_)
        parts = []
        for form in ("cluster", "grid"):
            if form == "cluster" and T_ > cuda_pressure.CLUSTER_CAPACITY:
                continue
            half, launch = b5_cost.fit(b5_cost.form_solver(form, a[0], a[1], kw.get("mask"),
                                                           a[3], a[4]))
            parts.append(f"{form} form {half:.3f} us a half-sweep, {launch:.3f} us a launch")
        print(f"[{label}] B5 T={T_} ({cuda_pressure.fused_shape(T_).form} form on the path): "
              + "; ".join(parts) + f" (the grid form is the design before the redesign) | "
              f"{card}", flush=True)


def redesigned(card, label: str, path: str, res: dict):
    """B5's and B6's ms a step of a path beside their bound and their
    records from before the redesign."""
    for key in ("B5", "B6"):
        r = res[key]
        print(f"[{label}] {key} {card.kernels[key]['name']}, {path} step: {r['ms']:.4f} "
              f"ms/step, {r['bound_ms'] / r['ms']:.1%} of its bound {r['bound_ms']:.4f}; before "
              f"the redesign {BEFORE_REDESIGN[path][key]} | {card}", flush=True)


def field(rng, mask, *shape, scale=1.0):
    """Standard normal float32 values of ``shape`` from ``rng`` on the card,
    times ``scale`` and ``mask``."""
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(DEV)
    return x * scale * mask


def in_domain(rng, rows, mask):
    """A random in-domain mask of ``rows`` rows (70% ones), times ``mask``."""
    return (torch.from_numpy(rng.random((rows, 512))).to(DEV) > 0.3).float() * mask


def emits(model) -> int:
    """EM launches a step of ``model``: the plume's and the collider's
    steps emit through ``models/plume.emit``, the others have their own."""
    return 1 if model in (plume, collider) else 0


def confines(p_) -> int:
    """VC launches a step at ``p_``: one where the confinement acts, at an
    offset ``int(factor_scale)`` other than 0 (ops/stencil.py)."""
    return int(int(p_.combustion.factor_scale) != 0)


def step_counts(cap: int, p_, em: int = 0) -> dict:
    """Launches of one step at capacity ``cap`` on the nbr path with at
    most 8 scalars: the pressure solve as ops/pressure.solve_pressure
    dispatches it, with ``p_.has_collision`` four CE (the step's enforce
    passes), ``em`` EM (:func:`emits`) and one VC where the confinement acts
    (:func:`confines`)."""
    c = {"B1": 2, "B2": 2, "B7a": 1, "B7b": 1, "CE": 4 if p_.has_collision else 0, "EM": em,
         "VC": confines(p_)}
    if cap <= cuda_pressure.MAX_FUSED_ROWS:
        c["B5"] = 1
    else:
        lag_ = p_.effective_halo_lag
        blocks = p_.iterations // lag_ if lag_ > 1 else 0
        c["B3"], c["B4"] = blocks, 2 * (p_.iterations - blocks * lag_)
    return c


def totals(caps: list, p_, em: int = 0):
    """The launches of one step at each capacity of ``caps`` (filled while
    the run goes), summed: a callable for :func:`main_path`."""
    def want():
        out = {}
        for cap in caps:
            for key, n in step_counts(cap, p_, em).items():
                out[key] = out.get(key, 0) + n
        return out
    return want


def phase_1_device() -> Card | None:
    """The card's name and power limit, torch and CUDA versions. Returns the
    run's :class:`Card`, or None without a card."""
    start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    card = Card(smi.stdout.strip().splitlines()[0], start)
    print(f"[1] device: {card} | torch {torch.__version__} | CUDA {torch.version.cuda}"
          f" | {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)
    card.done("1")
    return card


def phase_2_build(card: Card) -> None:
    """Build the kernels; print ptxas's resources of every kernel instance
    with its resident warps (with the dynamic shared memory of the probe
    kernels at phase 15's shapes and of VC at each offset), and B5's launch
    shape at each T it solves."""
    info = build.build()
    build.library()
    res = build.parse_ptxas(info.log)
    print(f"[2] build: {info.seconds:.1f} s -> {info.path.name}"
          f" ({len(res)} kernel instances; one nvcc per source, no -rdc)", flush=True)
    # the probe kernels' dynamic shared memory at phase 15's bench shapes
    # (4608 source rows; PC's JSON launch: 4096 row starts)
    probe_smem = {"take_slab_kernel": cuda_probe.slab_smem_bytes(probe_dmacost.T),
                  "take_chain_kernel": cuda_probe.chain_smem_bytes(),
                  "row_copy_kernel": probe.copy_smem_bytes(0, probe_dmacost.N_ROWS)}
    # VC's at each offset it is built for (vorticity_kernel<|s|>)
    probe_smem.update({f"vorticity_kernel<{s_}>": cuda_vorticity.smem_bytes(s_)
                       for s_ in range(1, cuda_vorticity.MAX_OFFSET + 1)})
    for r in res:  # every kernel instance: its resources and resident warps
        if r.threads is not None:
            print(f"[2] {r.line(probe_smem.get(r.name, 0))}", flush=True)
    for T_ in sorted(set(B5_LEVELS) | {cuda_pressure.CLUSTER_ROWS,
                                       cuda_pressure.CLUSTER_ROWS + 1}):  # B5's launches
        sh_ = cuda_pressure.fused_shape(T_)
        if sh_.form == "cluster":
            print(f"[2] B5 at T={T_}: one cluster of {sh_.cluster} blocks x {sh_.threads} threads "
                  f"(rbsor_cluster_kernel: a thread a column, {sh_.tiles_per_block} tiles a "
                  f"block, {sh_.smem} B of dynamic shared memory a block, one block an SM)",
                  flush=True)
        else:
            print(f"[2] B5 at T={T_}: the grid form (rbsor_fused_kernel, {sh_.threads}-thread "
                  "blocks, at most 4 resident an SM, grid barriers)", flush=True)
    card.done("2")


def lagged_chain(nbr, div, launches: int, pairs: int, omega: float, dx2: float, mask=None):
    """``launches`` B3 launches of ``pairs`` pairs from p = 0, through the
    kernel and through its plain version: (kernel's p, plain version's p)."""
    p_k = p_p = torch.zeros_like(div)
    for _ in range(launches):
        p_k = cuda_pressure.rbsor_lagged(nbr, p_k, div, pairs, omega, dx2, mask)
        p_p = cuda_pressure.rbsor_lagged_plain(nbr, p_p, div, pairs, omega, dx2, mask)
    return p_k, p_p


def transfer_cases(card, rng, names: tuple, maps: tuple, nbr, Tf: int, Tc: int):
    """MR and MP in every form (:func:`transfer_forms`) on one level's
    maps (children, parent, octant; ``nbr`` the coarse level's), every
    operand random on every row, the null and padding rows too; ``names``
    label MR's lines and MP's."""
    children, parent, octant = maps
    transfer_forms(card, "3", "MR", (children, field(rng, 1.0, Tf, 512),
                                     in_domain(rng, Tf, 1.0), in_domain(rng, Tc, 1.0)), names[0])
    transfer_forms(card, "3", "MP", (parent, octant, nbr, field(rng, 1.0, Tc, 512),
                                     field(rng, 1.0, Tf, 512), in_domain(rng, Tf, 1.0)), names[1])


def emit_args(gen, topo, cfg, dt: float, origins=None) -> tuple:
    """EM's operands on ``topo`` (its origins, or ``origins``) with the
    emitter ``cfg``, every field random on every row from the device
    generator ``gen``: density in [0, 4), fuel in [0, 2) (above 1 outside
    the sphere too), temperature in [0, 300) (about the target), the
    velocity normal times 8."""
    T = topo.capacity

    def u(hi):
        return torch.rand((T, 512), generator=gen, device=DEV) * hi

    vel = torch.randn((3, T, 512), generator=gen, device=DEV) * 8.0
    return (topo.origins if origins is None else origins, topo.n_active, u(4.0), u(2.0),
            u(300.0), vel, cfg.center, cfg.radius, cfg.density_rate * dt, cfg.fuel_rate * dt,
            cfg.temperature_target, cfg.velocity_jet)


def emit_cases(card, c5) -> None:
    """EM bitwise its plain version (every output) with its inputs left as
    they were: at the bench (4196 tiles at capacity 4608) with its emitter
    and with a sphere off the lattice, whose surface cuts tiles, at config 5
    (269,104 tiles at capacity 269,312) with its emitter, and at the bench
    with the null and padding rows' origins planted inside the sphere (the
    row mask alone keeps them); fuel above 1 outside the sphere comes back
    1; NaNs in fuel and temperature come back as the plain version's, bit
    for bit. At config 5 its ms a launch beside its bound and the plain
    version's."""
    bench, dt = CELLS["bench"], CELLS["bench"].params.dt
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    tb = bench.topology(DEV)
    off = plume.PlumeConfig(center=(131.3, 27.7, 125.1), radius=13.7, temperature_target=95.5,
                            velocity_jet=-3.25)
    planted = tb.origins.clone()
    planted[0] = planted[tb.n_active + 1:] = torch.div(
        torch.tensor(bench.plume.center, device=DEV), 8, rounding_mode="floor").int()
    cases = (("bench", tb, bench.plume, None), ("bench, a sphere off the lattice", tb, off, None),
             ("bench, null and padding rows planted in the sphere", tb, bench.plume, planted),
             ("config 5", c5, CELLS["c5"].plume, None))
    for name, topo_, cfg, org in cases:
        a_ = emit_args(gen, topo_, cfg, dt, org)
        kept = [x.clone() for x in a_ if isinstance(x, torch.Tensor)]
        got, want = cuda_emit.emit(*a_), cuda_emit.emit_plain(*a_)
        hot = got[3][1] != a_[5][1]  # u_y set to the jet: inside the sphere
        rows_hot = hot.any(1)
        cut = int((rows_hot & ~hot.all(1)).sum())  # tiles the sphere's surface cuts
        over = (a_[3] > 1.0) & ~hot
        label = (f"{name} T={topo_.capacity}: {int(hot.sum())} voxels inside the sphere in "
                 f"{int(rows_hot.sum())} tiles, {cut} of them cut by its surface")
        for part, g, w in zip(("density", "fuel", "temperature", "velocity"), got, want):
            check(card, "EM", f"{label}; {part}", g, w, 0.0)
        if not (int(hot.sum()) > 0 and cut > 0):
            raise AssertionError(f"phase 3: EM at {name}: the sphere cuts no tile")
        if bool(hot[0].any()) or bool(hot[topo_.n_active + 1:].any()):
            raise AssertionError(f"phase 3: EM at {name} sourced the null or a padding row")
        if not (bool(over.any()) and bool((got[1][over] == 1.0).all())):
            raise AssertionError(f"phase 3: EM at {name}: fuel above 1 outside the sphere did "
                                 "not come back 1")
        if not all(torch.equal(x, y) for x, y in zip(kept, (x for x in a_ if
                                                              isinstance(x, torch.Tensor)))):
            raise AssertionError(f"phase 3: EM at {name} changed its inputs")
        del got, want, kept, hot, over
    # NaNs inside and outside the sphere, compared as bits (a NaN is not
    # equal to itself)
    a_ = emit_args(gen, tb, bench.plume, dt)
    nan = torch.rand((tb.capacity, 512), generator=gen, device=DEV) < 0.01
    for f in (a_[3], a_[4]):
        f[nan] = float("nan")
    got, want = cuda_emit.emit(*a_), cuda_emit.emit_plain(*a_)
    same = [torch.equal(g.view(torch.int32), w.view(torch.int32)) for g, w in zip(got, want)]
    inside_nan = int((nan & (got[3][1] != a_[5][1])).sum())
    print(f"[3] EM bench T={tb.capacity}, {int(nan.sum())} NaNs in fuel and temperature "
          f"({inside_nan} inside the sphere): bits equal (density, fuel, temperature, "
          f"velocity) {same}", flush=True)
    if not (all(same) and inside_nan > 0):
        raise AssertionError("phase 3: EM with NaNs is not bitwise its plain version")
    a_ = emit_args(gen, c5, CELLS["c5"].plume, dt)
    k_ms, p_ms = paired_ms(lambda: cuda_emit.emit(*a_), lambda: cuda_emit.emit_plain(*a_),
                           batch=4)
    b_ms, by, moved = bound_ms("EM", a_, {}, nbytes(a_[2:6]))
    print(f"[3] EM emit at config 5 (T={c5.capacity}): {k_ms:.4f} ms a launch, bound "
          f"{b_ms:.4f} ms ({by}, {moved / 1e6:.1f} MB; {b_ms / k_ms:.1%} of the kernel's "
          f"time), plain {p_ms:.4f} ms | {card}", flush=True)
    del a_, got, want
    torch.cuda.empty_cache()


def sparse_toy(gen) -> topology_mod.Topology:
    """A toy sparse topology: about half the tiles of a 6 x 5 x 6 block, so
    that face, edge and corner neighbours are absent here and there, at a
    capacity with 9 padding rows."""
    keep = torch.rand((6, 5, 6), generator=gen, device=DEV) < 0.5
    tiles = keep.nonzero().to(torch.int32).cpu().numpy()
    return build_topology(tiles, capacity=len(tiles) + 10, device=DEV)


def vorticity_cases(card) -> None:
    """VC bitwise its plain version on every row, with its input left as it
    was: at fire512 (33,656 tiles at capacity 33,792) and on a toy sparse
    topology (:func:`sparse_toy`), at each of VC_OFFSETS, the velocity
    random on every row (the null and padding rows too) and 0 on every
    seventh row (|grad|omega|| = 0 inside those tiles: N is 0 / 1e-5);
    s = 8, -8 and 0 raise.
    Then its ms a launch at fire512, s = 1, beside its bound and the plain
    version's: one fire512-rbgs50 frame's confinement."""
    p3 = fire.default_params()
    dt, inv_dx, scale = p3.dt, p3.inv_voxel_size, p3.combustion.vorticity_scale
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    tf = build_topology(plume.build_plume_envelope(*FIRE512), capacity=FIRE512_ROWS[1],
                        device=DEV)
    if (tf.n_active, tf.capacity) != FIRE512_ROWS:
        raise AssertionError(f"phase 3: fire512 has {tf.n_active} tiles at capacity "
                             f"{tf.capacity}, not {FIRE512_ROWS}")
    toy = sparse_toy(gen)
    absent = int((toy.nbr[1:toy.n_active + 1] == 0).sum())
    for name, topo_ in (("fire512", tf), (f"a toy of {toy.n_active} tiles ({absent} absent "
                                          "neighbours)", toy)):
        T_ = topo_.capacity
        vel = torch.randn((3, T_, 512), generator=gen, device=DEV) * 8.0
        vel[:, ::7] = 0.0
        kept = vel.clone()
        for s_ in VC_OFFSETS:
            a_ = (topo_.nbr, vel, dt, inv_dx, scale, s_)
            check(card, "VC", f"{name} T={T_}, s={s_}", cuda_vorticity.vorticity_confinement(*a_),
                  cuda_vorticity.vorticity_confinement_plain(*a_), 0.0)
            if not torch.equal(vel, kept):
                raise AssertionError(f"phase 3: VC at {name}, s={s_} changed its input")
        for s_ in (8, -8, 0):
            try:
                cuda_vorticity.vorticity_confinement(topo_.nbr, vel, dt, inv_dx, scale, s_)
            except ValueError:
                continue
            raise AssertionError(f"phase 3: VC at s={s_} did not raise")
    print("[3] VC at s = 8, -8 and 0 raised ValueError", flush=True)
    # the order in which the plain version's torch.sum adds its three squares
    sq = torch.randn((3, tf.capacity, 512), generator=gen, device=DEV) ** 2
    total = torch.sum(sq, dim=0)
    orders = {"(a + b) + c": (sq[0] + sq[1]) + sq[2], "a + (b + c)": sq[0] + (sq[1] + sq[2]),
              "(a + c) + b": (sq[0] + sq[2]) + sq[1]}
    print(f"[3] torch.sum over three stacked squares on the card adds as "
          f"{[k for k, v in orders.items() if torch.equal(total, v)]}", flush=True)
    vel = torch.randn((3, tf.capacity, 512), generator=gen, device=DEV) * 8.0
    a_ = (tf.nbr, vel, dt, inv_dx, scale, 1)
    k_ms, p_ms = paired_ms(lambda: cuda_vorticity.vorticity_confinement(*a_),
                           lambda: cuda_vorticity.vorticity_confinement_plain(*a_), batch=4)
    b_ms, by, moved = bound_ms("VC", a_, {}, nbytes(vel))
    card.kernels["VC"].update(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=by)
    print(f"[3] VC vorticity_confinement at fire512 (T={tf.capacity}, s=1): {k_ms:.4f} ms a "
          f"launch, bound {b_ms:.4f} ms ({by}, {moved / 1e6:.1f} MB; {b_ms / k_ms:.1%} of the "
          f"kernel's time), plain {p_ms:.4f} ms | {card}", flush=True)
    del tf, toy, vel, kept, sq, total, orders, a_
    torch.cuda.empty_cache()


def phase_3_kernels(card: Card, rng) -> tuple:
    """Each kernel against its plain version on inputs from ``rng``, at the
    bench shapes, at 7 mod 8 rows, on config 5's levels (B5 in both forms,
    MR and MP in every form, bitwise), at collider1024 (CE, timed), with
    the emitter (EM, :func:`emit_cases`) and at fire512 (VC,
    :func:`vorticity_cases`). Returns config 5's topology and
    multigrid hierarchy."""
    bench = CELLS["bench"]
    topo, params = bench.topology(DEV), bench.params
    T, sdt, lag = topo.capacity, params.dt * params.inv_voxel_size, params.effective_halo_lag
    omega, dx2, lim = params.omega, params.voxel_size ** 2, cuda_bfecc.DISP_LIMIT
    m = active_mask(topo)[:, None]
    vel = field(rng, m, 3, T, 512, scale=40.0)  # |u|*sdt reaches the 7-voxel clamp
    scal = field(rng, m, 5, T, 512)
    clamped = float(((vel * sdt).abs() > lim).float().mean())
    if clamped <= 0:
        raise AssertionError("phase 3: no displacement reaches the clamp")
    # B1 also with the config-4 sphere at frame 0 as the collision SDF
    # (masked, as mask_state leaves it)
    col4 = CELLS["c4"].collider
    sdf3 = collider.sphere_sdf(topo, collider.collider_center(col4, 0, params.dt, DEV),
                               col4.radius) * m
    d = torch.clamp(-vel * sdt, -lim, lim)
    hit = cuda_sample.sample_at_plain(topo.nbr, sdf3[None], d)[0] < 0
    d = torch.where(hit, 0.0, d)
    d2 = torch.clamp(d + cuda_sample.sample_at_plain(topo.nbr, vel, d) * sdt, -lim, lim)
    hit2 = cuda_sample.sample_at_plain(topo.nbr, sdf3[None], d2)[0] < 0
    share = (float(hit.sum()) / topo.num_voxels, float(hit2.sum()) / topo.num_voxels)
    if not min(share) > 0:
        raise AssertionError(f"phase 3: the SDF rejected no trace at a probe: {share}")
    del d, d2, hit, hit2
    for sdf_, note in ((None, f"({clamped:.1%} of traces clamped)"),
                       (sdf3, f"with SDF ({share[0]:.2%} of back traces, {share[1]:.2%} of "
                              "re-traces rejected)")):
        for mode, fields, f_lo in (("velocity", vel, 0),
                                   ("scalars", torch.cat([vel, scal]).contiguous(), 3)):
            got = cuda_bfecc.bfecc_sample(topo.nbr, fields, sdt, f_lo, sdf_)
            want = cuda_bfecc.bfecc_sample_plain(topo.nbr, fields, sdt, f_lo, sdf_)
            for part, g, w in zip(("phiF", "phiB"), got, want):
                check(card, "B1", f"{mode:8s} {part} {note}", g, w, TOL_B1)
    for F in (3, 5):
        phi0, pf, pb = (field(rng, m, F, T, 512) for _ in range(3))
        got = cuda_tail.bfecc_tail(topo.nbr, phi0, pf, pb)
        want = cuda_tail.bfecc_tail_plain(topo.nbr, phi0, pf, pb)
        check(card, "B2", f"F={F}", got, want, 0.0)
    div = field(rng, m, T, 512)
    launches = params.iterations // lag
    check(card, "B3", f"{launches} launches x {lag} pairs",
          *lagged_chain(topo.nbr, div, launches, lag, omega, dx2))
    # a capacity of 7 mod 8 rows: B3's last block is short, and the +-z
    # links of the bench tiles break at every place inside its blocks
    tiles = plume.build_plume_envelope(*bench.envelope)
    n_t = len(np.unique(tiles, axis=0))
    t_odd = build_topology(tiles, capacity=n_t + 1 + (6 - n_t) % 8, device=DEV)
    d_odd = field(rng, active_mask(t_odd)[:, None], t_odd.capacity, 512)
    p_k, p_p = lagged_chain(t_odd.nbr, d_odd, launches, lag, omega, dx2)
    check(card, "B3", f"T={t_odd.capacity} ({t_odd.capacity % 8} mod 8), "
          f"{launches} launches x {lag} pairs", p_k, p_p)
    # B6's tail block too: G = 4 tiles a block, so 7 mod 8 rows leave it 3
    check(card, "B6", f"T={t_odd.capacity} ({t_odd.capacity % 8} mod 8)",
          cuda_stencil.residual(t_odd.nbr, p_k, d_odd, 0.5),
          cuda_stencil.residual_plain(t_odd.nbr, p_k, d_odd, 0.5), 0.0)
    mask = in_domain(rng, T, m)
    p0 = field(rng, m, T, 512)
    for mk in (None, mask):
        for color in (0, 1):
            pk = p0.clone() if mk is None else p0 * mk
            want = cuda_pressure.rbsor_color_plain(topo.nbr, pk, div, color, omega, dx2, mk)
            cuda_pressure.rbsor_color(topo.nbr, pk, div, color, omega, dx2, mk)
            check(card, "B4", f"colour {color}, {'mask' if mk is not None else 'no mask'}", pk,
                  want)
    for dx_ in (0.5, 0.3):  # an exact and an inexact dx^2
        check(card, "B6", f"bench T={T}, dx {dx_}", cuda_stencil.residual(topo.nbr, p0, div, dx_),
              cuda_stencil.residual_plain(topo.nbr, p0, div, dx_), 0.0)
    for inv_dx in (params.inv_voxel_size, 1.0 / 0.3):  # an exact and an inexact scale
        check(card, "B7a", f"bench T={T}, inv_dx {inv_dx:.4f}",
              cuda_stencil.divergence(topo.nbr, vel, inv_dx),
              cuda_stencil.divergence_plain(topo.nbr, vel, inv_dx))
        check(card, "B7b", f"bench T={T}, inv_dx {inv_dx:.4f}",
              cuda_stencil.subtract_gradient(topo.nbr, vel, p0, inv_dx),
              cuda_stencil.subtract_gradient_plain(topo.nbr, vel, p0, inv_dx))
    # CE bitwise its plain version on the config-4 cell (4354 tiles at
    # capacity 4608) and on collider1024's topology (config 5's cone and the
    # radius-48 sphere's shell at each of a cook's 48 frames), the velocity
    # random on every row, the sphere's SDF masked as the step leaves it at a
    # centre on the lattice (frame 0) and one off it (frame 17.3), blended
    # with 1 - sdf/0.1 (the gate's) and 1 - sdf/1.5 (the velocity tail's), at
    # an exact and an inexact scale; at collider1024 its ms a launch beside
    # its bound and the plain pass's
    margin = collision.COLLISION_MARGIN
    col1024 = collider.ColliderConfig(**COL1024)
    tiles = np.concatenate([plume.build_plume_envelope(*CELLS["c5"].envelope)] + [
        collider.collider_tiles(col1024, f, params.dt) for f in range(COL1024_FRAMES)])
    n_t = len(np.unique(tiles, axis=0))
    t1024 = build_topology(tiles, capacity=((n_t + 1 + 511) // 512) * 512, device=DEV)
    if (t1024.n_active, t1024.capacity) != COL1024_ROWS:
        raise AssertionError(f"phase 3: collider1024 has {t1024.n_active} tiles at capacity "
                             f"{t1024.capacity}, not {COL1024_ROWS}")
    for name, topo_, col in (("config 4", CELLS["c4"].topology(DEV), col4),
                             ("collider1024", t1024, col1024)):
        T_ = topo_.capacity
        m_ = active_mask(topo_)[:, None]
        v_ = field(rng, 1.0, 3, T_, 512, scale=8.0)
        for f in (0, 17.3):
            sdf_ = collider.sphere_sdf(topo_, collider.collider_center(col, f, params.dt, DEV),
                                       col.radius) * m_
            inside = int(((sdf_ < 0) & (m_ > 0)).sum())
            shell = int(((sdf_ >= 0) & (sdf_ < margin) & (m_ > 0)).sum())
            if not (inside > 0 and shell > 0):
                raise AssertionError(f"phase 3: CE at {name}, frame {f}: {inside} voxels "
                                     f"inside, {shell} on the shell")
            for bd in (margin, 1.5):
                for inv_dx in (params.inv_voxel_size, 1.0 / 0.3):
                    a_ = (topo_.nbr, v_, sdf_, inv_dx, margin, bd)
                    check(card, "CE", f"{name} T={T_}, frame {f} ({inside} voxels inside, "
                          f"{shell} on the shell), 1 - sdf/{bd}, inv_dx {inv_dx:.4f}",
                          cuda_collision.enforce_collision(*a_),
                          cuda_collision.enforce_collision_plain(*a_), 0.0)
    a_ = (t1024.nbr, v_, sdf_, params.inv_voxel_size, margin, margin)
    k_ms, p_ms = paired_ms(lambda: cuda_collision.enforce_collision(*a_),
                           lambda: cuda_collision.enforce_collision_plain(*a_), batch=4)
    b_ms, by, moved = bound_ms("CE", a_, {}, nbytes(v_))
    print(f"[3] CE enforce_collision at collider1024 (T={t1024.capacity}): {k_ms:.4f} ms a "
          f"launch ({4 * k_ms:.4f} a frame's four), bound {b_ms:.4f} ms ({by}, "
          f"{moved / 1e6:.1f} MB; {b_ms / k_ms:.1%} of the kernel's time), plain pass "
          f"{p_ms:.4f} ms | {card}", flush=True)
    del tiles, t1024, v_, sdf_, m_, a_
    torch.cuda.empty_cache()
    # B8 at displacements past the clamp, n = 11 in two launches (8 + 3)
    dd = torch.from_numpy(rng.uniform(-9.0, 9.0, (3, T, 512)).astype(np.float32)).to(DEV)
    dd = torch.clamp(dd, -lim, lim)
    allf = torch.cat([vel, scal, field(rng, m, 3, T, 512)])
    for n in (1, 3, 8, 11):
        fn = allf[:n].contiguous()
        check(card, "B8", f"n={n} fields, {float((dd.abs() >= lim).float().mean()):.1%} of "
              f"displacements at the clamp", cuda_sample.sample_at(topo.nbr, fn, dd),
              cuda_sample.sample_at_plain(topo.nbr, fn, dd), TOL_B1)
    del dd, allf, fn
    # BASELINE config 5: the domain and its hierarchy (phase 9 steps on them)
    c5 = CELLS["c5"].topology(DEV)
    c5_hier = multigrid.hierarchy_for(c5, CELLS["c5-mg"].params)
    lv2 = c5_hier[1]

    # B5 in both forms at every level it solves on the main paths (config 5's
    # levels 3-5: 1024 rows in the grid form, 128 and 32 in the cluster form,
    # with their masks), at the cluster form's largest T (CLUSTER_ROWS), at
    # that T + 1 and at 2048 in the grid form; with and without a mask, from
    # a p0 that is non-zero outside it, 0, 2 and 24 iterations
    b5_cases = [(lv.topo, lv.mask, 4 ** k * dx2)
                for k, lv in enumerate(c5_hier, 1) if lv.topo.capacity in B5_LEVELS]
    tiles = np.unique(plume.build_plume_envelope(40, 256), axis=0)
    for cap in (cuda_pressure.CLUSTER_ROWS, cuda_pressure.CLUSTER_ROWS + 1, 2048):
        t5 = build_topology(tiles[:cap - 2], capacity=cap, device=DEV)
        b5_cases.append((t5, active_mask(t5)[:, None], dx2))
    for t5, m5, dx2_ in b5_cases:
        T5 = t5.capacity
        d5, k5, p05 = field(rng, m5, T5, 512), in_domain(rng, T5, m5), field(rng, m5, T5, 512)
        for mk in (None, k5):
            for it in (0, 2, 24):
                check(card, "B5", f"T={T5} ({cuda_pressure.fused_shape(T5).form} form), {it} "
                      f"iterations, {'mask' if mk is not None else 'no mask'}",
                      cuda_pressure.rbsor_fused(t5.nbr, d5, it, omega, dx2_, p0=p05, mask=mk),
                      cuda_pressure.rbsor_fused_plain(t5.nbr, d5, it, omega, dx2_, p0=p05,
                                                      mask=mk), 0.0)
    # the cluster form where the null row is not +0 (p0 and div random on
    # every row, the null and padding rows too): its reads of row 0 then go
    # to block 0's shared memory instead of a local zero tile
    t5 = next(lv.topo for lv in c5_hier if lv.topo.capacity <= cuda_pressure.CLUSTER_ROWS)
    d5, p05 = field(rng, 1.0, t5.capacity, 512), field(rng, 1.0, t5.capacity, 512)
    for mk in (None, in_domain(rng, t5.capacity, 1.0)):
        check(card, "B5", f"T={t5.capacity} (cluster form), a null row not 0, 24 iterations, "
              f"{'mask' if mk is not None else 'no mask'}",
              cuda_pressure.rbsor_fused(t5.nbr, d5, 24, omega, dx2, p0=p05, mask=mk),
              cuda_pressure.rbsor_fused_plain(t5.nbr, d5, 24, omega, dx2, p0=p05, mask=mk), 0.0)
    del b5_cases, tiles, t5, m5, d5, k5, p05
    d2 = field(rng, lv2.mask, lv2.topo.capacity, 512)
    p_k, p_p = lagged_chain(lv2.topo.nbr, d2, 2, 1, omega, 4 * dx2, lv2.mask)
    check(card, "B3", f"mask, config-5 level 2 T={lv2.topo.capacity}, 2 launches x 1 pair", p_k,
          p_p)
    check(card, "B6", f"config-5 level 2 T={lv2.topo.capacity}, masked p and div, dx 1.0",
          cuda_stencil.residual(lv2.topo.nbr, p_k, d2, 1.0),
          cuda_stencil.residual_plain(lv2.topo.nbr, p_k, d2, 1.0), 0.0)
    m_c5 = active_mask(c5)[:, None]
    pc, dc = field(rng, m_c5, c5.capacity, 512), field(rng, m_c5, c5.capacity, 512)
    check(card, "B3", f"config-5 fine T={c5.capacity}, 1 launch x {lag} pairs",
          cuda_pressure.rbsor_lagged(c5.nbr, pc, dc, lag, omega, dx2),
          cuda_pressure.rbsor_lagged_plain(c5.nbr, pc, dc, lag, omega, dx2))
    check(card, "B6", f"config-5 fine T={c5.capacity}",
          cuda_stencil.residual(c5.nbr, pc, dc, 0.5),
          cuda_stencil.residual_plain(c5.nbr, pc, dc, 0.5), 0.0)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    vc = torch.randn((3, c5.capacity, 512), generator=gen, device=DEV) * m_c5
    check(card, "B7a", f"config-5 fine T={c5.capacity}",
          cuda_stencil.divergence(c5.nbr, vc, 1 / 0.3),
          cuda_stencil.divergence_plain(c5.nbr, vc, 1 / 0.3))
    check(card, "B7b", f"config-5 fine T={c5.capacity}",
          cuda_stencil.subtract_gradient(c5.nbr, vc, pc, 1 / 0.3),
          cuda_stencil.subtract_gradient_plain(c5.nbr, vc, pc, 1 / 0.3))
    del d2, p_k, p_p, pc, dc, m_c5, vc
    # MR and MP in every form, every row random (the null and padding rows
    # too): a planted level 1 whose coarse tile A = (0,0,0) has its +y and +z
    # face tiles absent while the corner tile (0,1,1) beyond them exists (MP
    # reaches it only through the absent face tiles), the bench hierarchy's
    # levels, and each slab's maps of a 4-slab bench decomposition
    planted = build_topology(np.array([(x, y, z) for x in range(2) for y in range(2)
                                       for z in range(2)] + [(0, 2, 2), (1, 3, 3)]), device=DEV)
    plv = multigrid.build_hierarchy(planted, 1)[0]
    a_row = int((plv.topo.origins == 0).all(1).nonzero()[0])  # tile A
    nb_a = plv.topo.nbr[a_row].tolist()
    if not (nb_a[16] == 0 and nb_a[14] == 0 and nb_a[1 * 9 + 2 * 3 + 2] != 0):
        raise AssertionError(f"phase 3: the planted level's tile A has nbr {nb_a}")
    bench_h = multigrid.build_hierarchy(topo, 2)
    for name, lv, Tf in (("planted level 1", plv, planted.capacity),
                         ("bench level 1", bench_h[0], T),
                         ("bench level 2", bench_h[1], bench_h[0].topo.capacity)):
        transfer_cases(card, rng, (name + " ",) * 2, (lv.children, lv.parent, lv.octant),
                       lv.topo.nbr, Tf, lv.topo.capacity)
    sh3 = pslab.build_slab_hierarchy(topo, pslab.build_slabs(topo, SLABS), 2)
    lv = sh3.coarse_level
    for d in range(SLABS):
        maps = [x[d].to(DEV) for x in (sh3.children_local, sh3.parent_global, sh3.octant_local)]
        ghosts = int(((maps[1] > 0).sum() - (maps[0] > 0).sum()))
        transfer_cases(card, rng, (f"slab {d} ", f"slab {d} ({ghosts} ghost rows with a parent) "),
                       maps, lv.topo.nbr, sh3.parent_global.shape[1], lv.topo.capacity)
        if ghosts <= 0:
            raise AssertionError(f"phase 3: slab {d}'s maps cover no ghost row")
    emit_cases(card, c5)
    vorticity_cases(card)
    card.done("3")
    return c5, c5_hier


def phase_4_main_path(card: Card) -> tuple:
    """The main path: 20 bench steps from rest, exactly RBGS50_STEP's
    launches a step. Returns the developed bench (topology, state)."""
    bench = CELLS["bench"]
    params = bench.params
    topo = bench.topology(DEV)
    t0 = time.perf_counter()
    with main_path(card, "4", RBGS50_STEP, bench.develop):
        topo, state = plume.run_plume(bench.develop, params, bench.plume, topo=topo,
                                      state=zeros_state(topo), grow_every=0)
    wall = time.perf_counter() - t0
    print(f"[4] main path: {bench.develop} plume steps on {topo.n_active} tiles "
          f"({topo.num_voxels} active voxels, capacity {topo.capacity}), {params.iterations} "
          f"iterations at halo_lag {params.effective_halo_lag}: {wall:.2f} s wall; max density "
          f"{float(state.scalars['density'].max()):.4f}, max |u| "
          f"{float(state.velocity.abs().max()):.3f}", flush=True)
    check_state("4", topo, state)
    card.done("4")
    return topo, state


def phase_5_step_vs_plain(card: Card, topo, state) -> None:
    """One step from the developed bench state, kernels vs plain."""
    bench = CELLS["bench"]
    step_vs_plain(card, "5", lambda: plume.plume_step(topo, state, bench.params, bench.plume))
    card.done("5")


def phase_6_timing(card: Card, topo, state) -> float:
    """The bench step's ms and voxel-updates/s; each of its kernel calls vs
    plain, timed beside its bound. Returns the ms a step."""
    params, cfg = CELLS["bench"].params, CELLS["bench"].plume
    step_ms, _, res = path_timed(card, "6", lambda: plume.plume_step(topo, state, params, cfg),
                                 15, ("B1", "B2", "B3", "B7a", "B7b", "EM"))
    vups = topo.num_voxels / (step_ms * 1e-3)
    for key, r in res.items():
        card.kernels[key].update(r)
    for key in ("B1", "B3"):
        r = card.kernels[key]
        print(f"[6] {key} {r['name']}: {r['ms']:.4f} ms/step, {r['bound_ms'] / r['ms']:.1%} of "
              f"its bound {r['bound_ms']:.4f}; before the redesign "
              f"{BEFORE_REDESIGN['bench'][key]} | {card}", flush=True)
    print(f"[6] step: {step_ms:.3f} ms/step (median of 15, CUDA events; before the redesign of "
          f"B1 and B3 {BEFORE_REDESIGN['bench step']}), {vups:.4e} active voxel-updates/s, "
          f"{topo.num_voxels} voxels, {params.iterations} iterations | {card}", flush=True)
    card.done("6")
    return step_ms


def phase_7_multigrid(card: Card, topo, state, step_ms: float) -> None:
    """The bench under multigrid (mg_levels 2): MG_STEPS steps, exactly
    BENCH_MG_STEP's launches a step; one step and its kernel calls vs plain,
    timed; B5 fitted at each T of the step."""
    cfg, mg_params = CELLS["bench"].plume, CELLS["bench-mg"].params
    hier = multigrid.hierarchy_for(topo, mg_params)
    print(f"[7] bench hierarchy: tiles per level "
          f"{[topo.n_active] + [lv.topo.n_active for lv in hier]}, capacities "
          f"{[topo.capacity] + [lv.topo.capacity for lv in hier]}", flush=True)
    with main_path(card, "7", BENCH_MG_STEP, MG_STEPS):
        topo, mg_state = plume.run_plume(MG_STEPS, mg_params, cfg, topo=topo, state=state,
                                         grow_every=0)
    check_state("7", topo, mg_state)

    def mg_step():
        return plume.plume_step(topo, mg_state, mg_params, cfg, hier)

    step_vs_plain(card, "7", mg_step)
    mg_ms, groups, res7 = path_timed(card, "7", mg_step, 7, ("B3", "B5", "B6"))
    for key in ("B5", "B6"):  # B3's row stays the bench RBGS step's
        card.kernels[key].update(res7[key])
    redesigned(card, "7", "bench MG", res7)
    fit_b5(card, "7", groups)
    print(f"[7] bench MG step: {mg_ms:.3f} ms/step (median of 7, CUDA events) vs RBGS-50 "
          f"{step_ms:.3f} | {card}", flush=True)
    card.done("7")


def phase_8_parity(card: Card, topo, state) -> None:
    """One bench step in the "parity" tier (halo_lag 1: 100 B4 sweeps),
    kernels vs plain, each B4 call vs plain, timed."""
    cfg, par_params = CELLS["bench"].plume, CELLS["bench"].params.replace(precision="parity")
    assert par_params.effective_halo_lag == 1
    with main_path(card, "8", PARITY_STEP):
        topo, par_state = plume.run_plume(1, par_params, cfg, topo=topo, state=state,
                                          grow_every=0)
    check_state("8", topo, par_state)

    def par_step():
        return plume.plume_step(topo, state, par_params, cfg)

    step_vs_plain(card, "8", par_step)
    par_ms, _, res = path_timed(card, "8", par_step, 5, ("B4",))
    card.kernels["B4"].update(res["B4"])
    print(f"[8] bench parity-tier step: {par_ms:.3f} ms/step (median of 5) | {card}",
          flush=True)
    card.done("8")


def phase_9_config5(card: Card, c5, c5_hier) -> None:
    """BASELINE config 5 on phase 3's topology and hierarchy, kernels only:
    RBGS-50 and MG steps with exact launches (C5_MG_STEP), a project-only
    solve (MG max|r| <= 0.1 max|div|), ms a step, peak memory; each kernel
    call of an MG and an RBGS-50 step vs plain and its HBM bound."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    c5_rb, cfg5, c5_mg = CELLS["c5"].params, CELLS["c5"].plume, CELLS["c5-mg"].params
    print(f"[9] config 5: {c5.n_active} tiles = {c5.num_voxels} voxels (capacity "
          f"{c5.capacity}); hierarchy tiles per level "
          f"{[c5.n_active] + [lv.topo.n_active for lv in c5_hier]}, capacities "
          f"{[c5.capacity] + [lv.topo.capacity for lv in c5_hier]}", flush=True)
    with main_path(card, "9", RBGS50_STEP, CELLS["c5"].develop):
        c5, st5 = plume.run_plume(CELLS["c5"].develop, c5_rb, cfg5, topo=c5, grow_every=0)
    check_state("9", c5, st5)
    with main_path(card, "9", C5_MG_STEP, C5_MG_STEPS):
        c5, st5 = plume.run_plume(C5_MG_STEPS, c5_mg, cfg5, topo=c5, state=st5,
                                  grow_every=0)
    check_state("9", c5, st5)

    def c5_step(p_, h_):
        return lambda: plume.plume_step(c5, st5, p_, cfg5, h_)

    c5_ms = {}
    for name, p_, h_ in (("MG", c5_mg, c5_hier), ("RBGS-50", c5_rb, ())):
        c5_ms[name] = statistics.median(time_ms(c5_step(p_, h_), 3))
    # project-only solve on the developed velocity (tools/scale1024_r5.py)
    inv_dx, dx = c5_rb.inv_voxel_size, c5_rb.voxel_size
    div5 = stencil.divergence(c5, st5.velocity, inv_dx)
    div0 = float(div5.abs().max())
    rmax = {}
    for name in ("MG", "RBGS-50"):
        if name == "MG":
            p5 = multigrid.solve_pressure_mg(
                c5, list(c5_hier), div5, c5_mg.iterations, dx, c5_mg.omega,
                fmg=True, n_pre=c5_mg.mg_pre, n_post=c5_mg.mg_post,
                n_coarsest=c5_mg.mg_coarsest)
        else:
            p5 = prs.solve_pressure(c5, div5, c5_rb.iterations, dx, c5_rb.omega,
                                    halo_lag=c5_rb.effective_halo_lag)
        rmax[name] = float(prs.residual(c5, p5, div5, dx).abs().max())
        after = float(solver.divergence_only(
            c5, stencil.subtract_pressure_gradient(c5, st5.velocity, p5, inv_dx),
            dx).abs().max())
        print(f"[9] project-only {name}: div0 {div0:.3f} -> max|r| {rmax[name]:.3f}, "
              f"max|div| after {after:.3f} (the JAX package's record, SCALE_r05.md: a "
              f"developed field 128.727 -> MG 0.857, RBGS-50 30.008; a 4-step field "
              f"8.598 -> MG 0.792)", flush=True)
        del p5
    peak = torch.cuda.max_memory_allocated()
    print(f"[9] config 5 ms/step (median of 3, CUDA events): MG {c5_ms['MG']:.1f} (before the "
          f"redesign of B5 and B6 {BEFORE_REDESIGN['c5 MG step']}), "
          f"RBGS-50 {c5_ms['RBGS-50']:.1f} (before the redesign of B1 and B3 "
          f"{BEFORE_REDESIGN['c5 RBGS-50 step']}); {c5.num_voxels / (c5_ms['MG'] * 1e-3):.4e} "
          f"(MG) and {c5.num_voxels / (c5_ms['RBGS-50'] * 1e-3):.4e} (RBGS) active "
          f"voxel-updates/s; peak device memory {peak / 2**30:.2f} GiB | {card}", flush=True)
    if not rmax["MG"] <= C5_RMAX_OVER_DIV0 * div0:
        raise AssertionError(f"phase 9: MG max|r| {rmax['MG']} > {C5_RMAX_OVER_DIV0} * "
                             f"div0 {div0}")
    # after the peak is read: the plain versions' temporaries are not the step's
    groups = record(card, c5_step(c5_mg, c5_hier), ("B3", "B5", "B6", "B7a", "B7b"))
    redesigned(card, "9", "c5 MG", time_calls(card, "9", groups, plain=False))
    fit_b5(card, "9", groups)
    del groups
    # the transfers: each recorded call bitwise its plain version in every
    # form, kernel and plain chain timed, level 1's totals beside its bound
    torch.cuda.empty_cache()
    groups = record(card, c5_step(c5_mg, c5_hier), ("MR", "MP"))
    res9 = time_calls(card, "9", groups)
    l1 = {"MR": c5_hier[0].topo.capacity, "MP": c5.capacity}  # rows of level-1 calls
    for key in ("MR", "MP"):
        card.kernels[key].update(res9[key])
        one = [(a_, kw_, ob_, n_) for k_, a_, kw_, ob_, n_ in groups
               if k_ == key and a_[0].shape[0] == l1[key]]
        ms_ = sum(median_ms(lambda: card.kernels[key]["kernel_fn"](*a_, **kw_), 10, 5) * n_
                  for a_, kw_, _, n_ in one)
        pl_ = sum(median_ms(lambda: card.kernels[key]["plain_fn"](*a_, **kw_), 5, 1) * n_
                  for a_, kw_, _, n_ in one)
        b_ = sum(bound_ms(key, a_, kw_, ob_)[0] * n_ for a_, kw_, ob_, n_ in one)
        print(f"[9] {key} {card.kernels[key]['name']} at level 1, {sum(g[3] for g in one)} "
              f"calls a step: {ms_:.4f} ms, bound {b_:.4f} ms ({b_ / ms_:.1%} of the kernel's "
              f"time), plain chain {pl_:.4f} ms | {card}", flush=True)
    del groups, one
    # the RBGS-50 step's kernels at their true HBM bounds, a kernel at a time
    # (the recorded inputs of all five and a plain version's temporaries
    # would not fit the card together)
    rb5 = {}
    for key in ("B1", "B2", "B3", "B7a", "B7b", "EM"):
        torch.cuda.empty_cache()
        rb5.update(time_calls(card, "9 RBGS-50", record(card, c5_step(c5_rb, ()), (key,)),
                              plain=False))
    for key in ("B1", "B3"):
        print(f"[9] {key} at config 5, RBGS-50: {rb5[key]['ms']:.4f} ms/step, "
              f"{rb5[key]['bound_ms'] / rb5[key]['ms']:.1%} of its bound "
              f"{rb5[key]['bound_ms']:.4f}; before the redesign {BEFORE_REDESIGN['c5'][key]} | "
              f"{card}", flush=True)
    card.done("9")


def phase_10_collider(card: Card) -> tuple:
    """BASELINE config 4, the moving SDF sphere: 20 frames with exact launches
    (C4_STEP), each frame's solid, shell and SDF checked; one step and its
    kernel calls vs plain, timed. Returns the developed (topology, state)."""
    c4 = CELLS["c4"]
    p4, cfg4, col4 = c4.params, c4.plume, c4.collider
    t4 = c4.topology(DEV)
    inv4, act = p4.inv_voxel_size, slice(1, t4.n_active + 1)
    print(f"[10] config 4: {t4.n_active} tiles = {t4.num_voxels} voxels (capacity "
          f"{t4.capacity}), sphere radius {col4.radius} from {col4.center0} at "
          f"{col4.velocity} voxels/s, {p4.iterations} iterations", flush=True)

    def advection_input(st_in):
        """The scalars entering a frame's scalar advection: the frame's input
        after emit and combustion (both pointwise, as in the step), by the
        plain versions: no launch of this check is the path's."""
        with plain_versions(card):
            s_ = plume.emit(t4, st_in, cfg4, p4.dt).scalars
        cp = p4.combustion
        fuel, waste, temp, flame, _ = combustion.combustion_oxygen(
            s_["fuel"], s_["waste"], s_["temperature"], s_["flame"],
            torch.zeros_like(s_["fuel"]), cp.temperature_release, cp.expansion_rate)
        return {**s_, "fuel": fuel, "waste": waste, "temperature": temp, "flame": flame}

    prev = [zeros_state(t4)]

    def on_frame(f, topo_, st):
        sdf = st.scalars[COLLISION_FIELD]
        want = collider.sphere_sdf(topo_, collider.collider_center(col4, f, p4.dt, DEV),
                                   col4.radius)
        inside = sdf < 0
        n_in = int(inside.sum())
        vin = advection_input(prev[0])
        moved = [k for k, v in st.scalars.items()
                 if k != COLLISION_FIELD and not torch.equal(v[inside], vin[k][inside])]
        burnt = sum(int((vin[k][inside] != v[inside]).sum())
                    for k, v in prev[0].scalars.items() if k in vin)
        normal = collision.sdf_normal_field(topo_, sdf, inv4)
        # active rows only: the null and padding rows hold sdf 0
        shell = (sdf >= -0.5) & (sdf < 0.05) & (active_mask(topo_) > 0)[:, None]
        if n_in == 0 or int(shell.sum()) <= 10:
            raise AssertionError(f"phase 10 frame {f}: the collider is not in the domain")
        vdotn = (st.velocity * normal).sum(0)[shell].abs()
        ratio = float((vdotn / (st.velocity.norm(dim=0)[shell] + 1e-12)).median())
        deep = sdf < -1.5
        dens = float(st.scalars["density"][deep].max()) if bool(deep.any()) else 0.0
        print(f"[10] frame {f}: {n_in} voxels inside, max|u| there "
              f"{float(st.velocity[:, inside].abs().max()):.1f}, scalars changed there "
              f"{moved or 'none'} ({burnt} values moved by emit/combustion), shell "
              f"{int(shell.sum())} voxels median |u.n|/|u| {ratio:.4f}, max density "
              f"where sdf < -1.5 {dens:.4f}, max|u| {float(st.velocity.abs().max()):.2f}",
              flush=True)
        if not torch.equal(sdf[act], want[act]):
            raise AssertionError(f"phase 10 frame {f}: the SDF was not preserved")
        if bool(st.velocity[:, inside].any()):
            raise AssertionError(f"phase 10 frame {f}: velocity not 0 inside the solid")
        if moved:
            raise AssertionError(f"phase 10 frame {f}: {moved} changed inside the solid")
        if not ratio < C4_SHELL_VDOTN:
            raise AssertionError(f"phase 10 frame {f}: shell median |u.n|/|u| {ratio}")
        prev[0] = st

    t0 = time.perf_counter()
    # CE: the four enforce passes of a step with an SDF (collide.enforces)
    enforces0 = collision.enforces.n
    with main_path(card, "10", C4_STEP, c4.develop):
        t4, st4 = collider.run_collider(c4.develop, p4, cfg4, col4, topo=t4, state=prev[0],
                                        grow_every=0, on_frame=on_frame)
    print(f"[10] {c4.develop} collider frames: {time.perf_counter() - t0:.2f} s wall with "
          f"the per-frame checks", flush=True)
    check_state("10", t4, st4)
    if collision.enforces.n - enforces0 != card.kernels["CE"]["counter"].n:
        raise AssertionError(f"phase 10: {collision.enforces.n - enforces0} enforce_collision "
                             f"calls, {card.kernels['CE']['counter'].n} CE launches")
    travel = float((collider.collider_center(col4, c4.develop - 1, p4.dt)
                    - collider.collider_center(col4, 0, p4.dt)).norm())
    if not travel > 5.0:
        raise AssertionError(f"phase 10: the collider moved {travel} voxels")

    def c4_step():
        return collider.collider_step(t4, st4, p4, cfg4, col4, c4.develop)

    step_vs_plain(card, "10", c4_step)
    c4_ms, _, res10 = path_timed(card, "10", c4_step, 7, ("B1", "B2", "B3", "B7a", "B7b", "CE"))
    card.kernels["CE"].update(res10["CE"])
    print(f"[10] config-4 step: {c4_ms:.3f} ms/step (median of 7, CUDA events), "
          f"{t4.num_voxels / (c4_ms * 1e-3):.4e} active voxel-updates/s; the collider "
          f"travelled {travel:.1f} voxels | {card}", flush=True)
    card.done("10")
    return t4, st4


def phase_11_rk(card: Card, t4, st4) -> None:
    """RK2-4 advection on the developed config-4 state, with and without the
    SDF: each call's launches exact, kernels vs plain, timed."""
    p4 = CELLS["c4"].params
    inv4, vel4, sdf4 = p4.inv_voxel_size, st4.velocity, st4.scalars[COLLISION_FIELD]
    sc4 = {k: v for k, v in st4.scalars.items() if k != COLLISION_FIELD}
    for order in (2, 3, 4):
        for s_ in (None, sdf4):
            tag = f"RK{order}" + ("" if s_ is None else " + SDF")
            n8 = order - 1 + 2 + (0 if s_ is None else 2)

            def rk(order=order, s_=s_):
                return (advection.advect_velocity(t4, vel4, p4.dt, inv4, s_,
                                                  trace_order=order),
                        advection.advect_scalars_fused(t4, vel4, sc4, p4.dt, inv4, s_,
                                                       trace_order=order))

            with main_path(card, f"11 {tag} velocity",
                           {"B8": n8, "B2": 1, "CE": 0 if s_ is None else 1}, 1):
                advection.advect_velocity(t4, vel4, p4.dt, inv4, s_, trace_order=order)
            with main_path(card, f"11 {tag} scalars", {"B8": n8, "B2": 1}, 1):
                advection.advect_scalars_fused(t4, vel4, sc4, p4.dt, inv4, s_,
                                               trace_order=order)
            uk, sk = rk()
            with plain_versions(card):
                up, sp = rk()
            bad = [k for k, f in [("velocity", uk)] + sorted(sk.items())
                   if not bool(torch.isfinite(f).all())]
            if bad:
                raise AssertionError(f"phase 11 {tag}: {bad[0]} not finite")
            worst, parts = field_errors(FieldState(velocity=uk, scalars=sk),
                                        FieldState(velocity=up, scalars=sp))
            print(f"[11] {tag}: kernels vs plain, max rel err per field {', '.join(parts)} "
                  f"(tol {TOL_STEP:g})", flush=True)
            if not worst <= TOL_STEP:
                raise AssertionError(f"phase 11 {tag}: rel err {worst} > {TOL_STEP}")
            groups = record(card, rk, ("B8", "B2"))
            if order == 4 and s_ is not None:
                card.kernels["B8"].update(time_calls(card, "11", groups)["B8"])
            else:
                for key, a, kw, _, _ in groups:
                    vs_plain(card, "11", key, a, kw)
            rk()
            print(f"[11] {tag}: velocity + scalar advection "
                  f"{statistics.median(time_ms(rk, 5)):.3f} ms (median of 5) | {card}",
                  flush=True)
    card.done("11")


@contextlib.contextmanager
def growth_checked(label: str, model, caps: list, clock: dict):
    """``model.expand_for_state`` wrapped: records the capacity each
    frame's step ran at and the seconds of the step (from the frame's
    start) and of the growth pass, and holds every remap to the tile
    keys, found on the host: a tile in both topologies keeps its values
    exactly, a new tile and every padding row read 0."""
    real = activation.expand_for_state

    def wrapped(topo_, st, *a, **kw):
        caps.append(topo_.capacity)
        torch.cuda.synchronize()
        t_a = time.perf_counter()
        new_t, new_s = real(topo_, st, *a, **kw)
        torch.cuda.synchronize()
        t_b = time.perf_counter()
        clock["step"].append(t_a - clock["start"])
        clock["grow"].append(t_b - t_a)
        if new_t is topo_:
            return new_t, new_s
        ok_ = np.asarray(topo_.keys[1:topo_.n_active + 1].cpu())
        nk = np.asarray(new_t.keys[1:new_t.n_active + 1].cpu())
        _, io, in_ = np.intersect1d(ok_, nk, return_indices=True)
        io, in_ = torch.from_numpy(io + 1).to(DEV), torch.from_numpy(in_ + 1).to(DEV)
        fresh = torch.ones(new_t.capacity, dtype=torch.bool, device=DEV)
        fresh[in_] = False
        fresh[0] = True
        for name, old_f, new_f in [("velocity", st.velocity, new_s.velocity)] + [
                (k, st.scalars[k], new_s.scalars[k]) for k in sorted(st.scalars)]:
            if not torch.equal(new_f[..., in_, :], old_f[..., io, :]):
                raise AssertionError(f"phase {label}: the remap changed kept {name}")
            if bool(new_f[..., fresh, :].any()):
                raise AssertionError(f"phase {label}: a new or padding row of {name} != 0")
        return new_t, new_s

    with mock.patch.object(model, "expand_for_state", wrapped):
        yield


def grown(card, label: str, model, p_, run) -> tuple:
    """``run(on_frame)``, a growing cook of ``model`` at ``p_``, as a main
    path with every remap checked (:func:`growth_checked`) and each frame's
    state checked and printed. Returns (topology, state, wall seconds)."""
    caps, clock = [], {}
    t0 = time.perf_counter()
    clock.update(start=t0, step=[], grow=[])

    def on_frame(f, topo_, st):
        check_state(label, topo_, st)
        print(f"[{label}] frame {f}: step at capacity {caps[-1]} {clock['step'][-1]:.4f} s, "
              f"growth {clock['grow'][-1]:.4f} s -> {topo_.n_active} tiles at capacity "
              f"{topo_.capacity}; max|u| {float(st.velocity.abs().max()):.2f}", flush=True)
        torch.cuda.synchronize()
        clock["start"] = time.perf_counter()

    with growth_checked(label, model, caps, clock), main_path(card, label,
                                                              totals(caps, p_, emits(model))):
        topo, state = run(on_frame)
    st_, gr = clock["step"], clock["grow"]
    print(f"[{label}] seconds per frame, median (last 10 frames): step "
          f"{statistics.median(st_):.4f} ({statistics.median(st_[-10:]):.4f}), growth "
          f"{statistics.median(gr):.4f} ({statistics.median(gr[-10:]):.4f}); sums step "
          f"{sum(st_):.3f}, growth {sum(gr):.3f} | {card}", flush=True)
    return topo, state, time.perf_counter() - t0


def phase_12_config2(card: Card) -> None:
    """BASELINE config 2: C2_FRAMES growing plume frames with the JAX
    package's defaults (:func:`grown`); one step kernels vs plain."""
    p2, cfg2 = SolverParams(), plume.PlumeConfig()
    t2, st2, wall = grown(card, "12", plume, p2, lambda on_frame: plume.run_plume(
        C2_FRAMES, p2, cfg2, device=DEV, on_frame=on_frame))
    print(f"[12] config 2: {C2_FRAMES} frames in {wall:.2f} s wall "
          f"(growth and per-frame checks included): {t2.n_active} tiles, capacity "
          f"{t2.capacity}, max density {float(st2.scalars['density'].max()):.4f}", flush=True)
    check_state("12", t2, st2)
    if not t2.n_active > len(plume.emitter_tiles(cfg2)):
        raise AssertionError("phase 12: the topology did not grow")
    step_vs_plain(card, "12", lambda: plume.plume_step(t2, st2, p2, cfg2))
    card.done("12")


def phase_13_config3(card: Card) -> None:
    """BASELINE config 3: C3_FRAMES growing fire frames (:func:`grown`), one
    VC launch each (as many as ``vorticity.applies`` counts), and
    tests/test_fire.py's checks; one step kernels vs plain."""
    p3, cfg3 = fire.default_params(), fire.FireConfig()
    applied = stencil.applies.n
    t3, st3, wall = grown(card, "13", fire, p3, lambda on_frame: fire.run_fire(
        C3_FRAMES, p3, cfg3, device=DEV, on_frame=on_frame))
    applied = stencil.applies.n - applied
    vc = card.kernels["VC"]["counter"].n  # the grown run's, read after it
    print(f"[13] the confinement acted {applied} times, {vc} VC launches", flush=True)
    if not applied == vc == C3_FRAMES:
        raise AssertionError(f"phase 13: {applied} confinements, {vc} VC launches in "
                             f"{C3_FRAMES} frames")
    sc3 = st3.scalars
    hot = torch.where(sc3["temperature"] > 50.0, positions_flat(t3)[1].to(torch.float32), -1e9)
    facts = dict(flame=float(sc3["flame"].max()), waste=float(sc3["waste"].sum()),
                 temperature=float(sc3["temperature"].max()), hot_y=float(hot.max()))
    print(f"[13] config 3: {C3_FRAMES} frames in {wall:.2f} s wall: "
          f"{t3.n_active} tiles, capacity {t3.capacity}; max flame {facts['flame']:.4f} "
          f"(> 0.3), waste sum {facts['waste']:.3f} (> 0), max T {facts['temperature']:.2f} "
          f"(> 85), hot gas up to y {facts['hot_y']:.0f} (> 10)", flush=True)
    check_state("13", t3, st3)
    if not (facts["flame"] > 0.3 and facts["waste"] > 0 and facts["temperature"] > 85
            and facts["hot_y"] > 10):
        raise AssertionError(f"phase 13: the fireball checks failed: {facts}")
    step_vs_plain(card, "13", lambda: fire.fire_step(t3, st3, p3, cfg3))
    card.done("13")


def outside_cfl(topo, state, cfg, params) -> float:
    """The CFL number max|u| dt/dx of ``state`` outside the emitter: emit
    sets the jet inside it, so the bands scale the flow outside it, and the
    velocity pass sees the band's CFL."""
    inside = plume.emit(topo, zeros_state(topo), cfg, params.dt).velocity[1] != 0
    return float(state.velocity.abs().amax(0)[~inside].max()) * params.dt * params.inv_voxel_size


def table_counts(comb: bool, params):
    """The launches of one table-path step, from the branches it took
    (``advection.BANDS``, asked after the step)."""
    def want():
        b = advection.BANDS
        c = {"B2": 2, "B3": params.iterations // params.effective_halo_lag, "B7a": 1, "B7b": 1,
             "EM": 1, "B1": b["wide"], "B8": b["mixed fwd wide"],
             "B1d": b["narrow"] + b["mixed"] + b["mixed fwd narrow"]}
        if comb:
            c["B11"] = b["narrow"] + b["mixed"]
        return c
    return want


def vmem(comb):
    advection.INTERP, cuda_tables.COMBINE_TBL = "vmem", comb


def nbr_path():
    advection.INTERP, cuda_tables.COMBINE_TBL = None, None


def dual_both(card, lab, topo_, tb_, vb, fields, fl: int, sdf=None):
    """B1d in "both" mode at one pass (``fields`` from ``fl``), with the
    SDF where given: vs its plain version and bitwise vs the nbr B1."""
    sdt, nb_ = CELLS["bench"].params.dt * CELLS["bench"].params.inv_voxel_size, fields.shape[0]
    tv = tables.build_table_dual(tb_, fields if sdf is None else torch.cat([fields, sdf[None]]))
    args = (tv, tb_.chunk_ldual, vb, sdt, nb_, fl, "both", sdf is not None)
    got, want = cuda_bfecc.bfecc_sample_dual(*args), cuda_bfecc.bfecc_sample_dual_plain(*args)
    ref = cuda_bfecc.bfecc_sample(topo_.nbr, fields, sdt, fl, sdf)
    tag = f"both f_lo={fl}{' + SDF' if sdf is not None else ''}"
    for part, g, w, r in zip(("phiF", "phiB"), got, want, ref):
        check(card, "B1d", f"{tag} {part} vs plain", g, w, TOL_B1, lab)
        check(card, "B1d", f"{tag} {part} vs nbr B1", g, r, 0.0, lab)


def dual_checks(card, lab, topo_, tb_, vb, f8, sdf=None):
    """B1d's split modes at both passes ("back" of the velocity and of
    all eight fields, "fwd" of the velocity and of the five scalars)
    and, given an SDF, "both" at both passes with and without it: each
    vs its plain version and bitwise vs the nbr B1 / B8."""
    sdt = CELLS["bench"].params.dt * CELLS["bench"].params.inv_voxel_size
    lim, ld = cuda_bfecc.DISP_LIMIT, tb_.chunk_ldual
    d = torch.clamp(-vb * sdt, -lim, lim)
    for fields, fl in ((vb, 0), (f8, 3)):
        nb_ = fields.shape[0]
        tv = tables.build_table_dual(tb_, fields)
        got = cuda_bfecc.bfecc_sample_dual(tv, ld, vb, sdt, nb_, 0, "back")
        check(card, "B1d", f"back nb={nb_} vs plain", got, cuda_bfecc.bfecc_sample_dual_plain(
            tv, ld, vb, sdt, nb_, 0, "back"), TOL_B1, lab)
        check(card, "B1d", f"back nb={nb_} vs B8", got,
              cuda_sample.sample_at(topo_.nbr, fields, d), 0.0, lab)
        d2 = torch.clamp(d + got[:3] * sdt, -3.85, 3.85)
        got = cuda_bfecc.bfecc_sample_dual(tv, ld, d2, sdt, nb_, fl, "fwd")
        check(card, "B1d", f"fwd nb={nb_} f_lo={fl} vs plain", got,
              cuda_bfecc.bfecc_sample_dual_plain(tv, ld, d2, sdt, nb_, fl, "fwd"), TOL_B1, lab)
        check(card, "B1d", f"fwd nb={nb_} f_lo={fl} vs B8", got,
              cuda_sample.sample_at(topo_.nbr, fields[fl:].contiguous(), d2), 0.0, lab)
        if sdf is not None:
            for g_ in (None, sdf):
                dual_both(card, lab, topo_, tb_, vb, fields, fl, g_)


def phase_14_table_sampler(card: Card, rng, topo, state) -> dict:
    """The table sampler (``advection.INTERP = "vmem"``) on the developed
    bench state in each band, COMBINE_TBL off and on: B11 and B1d vs plain
    and bitwise vs the nbr path, each step as a main path, timed. Returns
    the bench and config-5 topologies built with their chunk plans."""
    bench = CELLS["bench"]
    params, cfg, T = bench.params, bench.plume, topo.capacity
    sdt = params.dt * params.inv_voxel_size
    planned = {}  # with their chunk plans, for phase 18
    for name, cell in (("bench", bench), ("config 5", CELLS["c5"])):
        tiles = plume.build_plume_envelope(*cell.envelope)
        n = len(np.unique(tiles, axis=0))
        cap = ((n + 1 + 511) // 512) * 512
        secs = {}
        for what, kw in (("plain", {}), ("plans", {"plans": True})):
            t0 = time.perf_counter()
            planned[name] = topology_mod.build_topology(tiles, capacity=cap, device=DEV, **kw)
            torch.cuda.synchronize()
            secs[what] = time.perf_counter() - t0
        print(f"[14] build_topology host seconds, {name} ({n} tiles, capacity {cap}): "
              + ", ".join(f"{k} {v:.3f}" for k, v in secs.items()), flush=True)
    torch.cuda.empty_cache()

    tb = topology_mod.ensure_chunk_plans(topo)
    nc, Ud = tb.chunk_dsrc.shape[:2]
    print(f"[14] bench chunk plans: {nc} chunks, U {tb.chunk_uniq.shape[1]}, Ud {Ud}",
          flush=True)
    vel0, sc0 = state.velocity, state.scalars
    cfl0 = outside_cfl(topo, state, cfg, params)
    print(f"[14] developed bench state: CFL max|u|*sdt = {float(vel0.abs().max()) * sdt:.3f}, "
          f"{cfl0:.3f} outside the emitter", flush=True)
    names = sorted(sc0)

    band_steps = {}
    for band, cfl in BANDS:
        vb = (vel0 * (cfl / cfl0)).contiguous()
        sb = FieldState(velocity=vb, scalars=sc0)
        f8 = torch.cat([vb, torch.stack([sc0[k] for k in names])]).contiguous()
        for comb in (False, True):
            vmem(comb)
            advection.BANDS.clear()
            label = f"14 {band} COMBINE_TBL={comb}"
            with main_path(card, label, table_counts(comb, params)):
                out_v = plume.plume_step(tb, sb, params, cfg)
            print(f"[{label}] branches taken {dict(advection.BANDS)}", flush=True)
            step_vs_plain(card, label, lambda: plume.plume_step(tb, sb, params, cfg))
            nbr_path()
            worst, parts = field_errors(out_v, plume.plume_step(topo, sb, params, cfg), True)
            print(f"[{label}] step vs the nbr-path step, max rel err per field: "
                  f"{', '.join(parts)} (tol {TOL_STEP:g})", flush=True)
            if not worst <= TOL_STEP:
                raise AssertionError(f"phase {label}: vs the nbr path {worst} > {TOL_STEP}")
            if band in ("narrow", "mixed") and comb:
                def band_step(tb=tb, sb=sb):
                    vmem(True)
                    plume.plume_step(tb, sb, params, cfg)
                band_steps[band] = band_step
        # the kernels at this band's inputs (scalar pass: velocity + 5 scalars)
        lab = f"14 {band}"
        if band == "narrow":
            t27 = tables.build_table(tb, f8)
            b11 = cuda_tables.build_table_dual_combine(t27, tb.chunk_dloc, 8)
            check(card, "B11", f"T={T} nf=8 vs plain", b11,
                  cuda_tables.build_table_dual_combine_plain(t27, tb.chunk_dloc, 8), 0.0, lab)
            tdual = tables.build_table_dual(tb, f8)
            check(card, "B11", f"T={T} nf=8 vs build_table_dual", b11, tdual, 0.0, lab)
            # the config-4 sphere at frame 0 as the SDF, as phase 3's B1 checks
            col4 = CELLS["c4"].collider
            sdf3 = collider.sphere_sdf(topo, collider.collider_center(col4, 0, params.dt, DEV),
                                       col4.radius) * active_mask(topo)[:, None]
            for sdf_ in (None, sdf3):
                for fl, fields in ((0, vb), (3, f8)):
                    dual_both(card, lab, topo, tb, vb, fields, fl, sdf_)
            k_ms, p_ms = paired_ms(
                lambda: cuda_tables.build_table_dual_combine(t27, tb.chunk_dloc, 8),
                lambda: cuda_tables.build_table_dual_combine_plain(t27, tb.chunk_dloc, 8))
            t27_ms = statistics.median(time_ms(lambda: tables.build_table(tb, f8), 5, 10))
            dual_ms = statistics.median(time_ms(lambda: tables.build_table_dual(tb, f8), 5, 10))
            print(f"[{lab}] nf=8 tables: B11 {k_ms:.4f} ms (plain {p_ms:.4f}), build_table "
                  f"{t27_ms:.4f} ms, build_table_dual {dual_ms:.4f} ms ({nbytes(t27) / 1e6:.1f} "
                  f"and {nbytes(tdual) / 1e6:.1f} MB) | {card}", flush=True)
            del t27, b11, tdual
        elif band == "mixed":
            dual_checks(card, lab, topo, tb, vb, f8)
        # the scalar pass: the table path against the nbr-form B1
        times = {}
        for what, fn in (("nbr B1", lambda: cuda_bfecc.bfecc_sample(topo.nbr, f8, sdt, 3)),
                         ("table path", lambda: advection._bfecc_samples(tb, f8, sdt, 3, None, 1)),
                         ("table path + B11", lambda: advection._bfecc_samples(
                             tb, f8, sdt, 3, None, 1))):
            vmem("B11" in what)
            fn()
            times[what] = statistics.median(time_ms(fn, 5, 5))
        nbr_path()
        print(f"[{lab}] scalar pass (3 + 5 fields, CFL {cfl}): "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())
              + f" (with the host CFL read and the table builds) | {card}", flush=True)
        del f8, vb, sb, out_v
    # B1d on small topologies: one chunk of 102 rows (below 512), and two
    # chunks whose second is mostly padding rows; a plane SDF through each
    for name, tiles, cap in (
            ("102 rows", np.array([(x, y, z) for x in range(5) for y in range(5)
                                   for z in range(5)])[:101], 102),
            ("two chunks, padding", np.array([(x, y, z) for x in range(9) for y in range(9)
                                              for z in range(8)]), 1024)):
        ts_ = topology_mod.build_topology(tiles, capacity=cap, device=DEV, plans=True)
        ms_ = active_mask(ts_)[:, None]
        vs_ = field(rng, ms_, 3, cap, 512, scale=1.8 / sdt / 4.0).clamp(-1.8 / sdt, 1.8 / sdt)
        fs_ = torch.cat([vs_, field(rng, ms_, 5, cap, 512)]).contiguous()
        py_ = positions_flat(ts_)[1].to(torch.float32)
        sdf_ = (py_ - float(py_[ms_[:, 0] > 0].median())) * ms_
        dual_checks(card, f"14 {name}", ts_, ts_, vs_.contiguous(), fs_, sdf_)
    groups = record(card, band_steps["narrow"], ("B1d", "B11"))
    nbr_path()
    res14 = time_calls(card, "14", groups)
    for key, r in res14.items():
        card.kernels[key].update(r)
    before = BEFORE_REDESIGN["table"]
    r = res14["B1d"]
    print(f"[14] B1d narrow step, its two launches alone: {r['ms']:.4f} ms "
          f"({r['bound_ms'] / r['ms']:.1%} of its bound {r['bound_ms']:.4f}), "
          f"{r['wrapper_ms']:.4f} through the wrapper; the design before: "
          f"{before['narrow B1d']} alone | {card}", flush=True)
    mixed = record(card, band_steps["mixed"], ("B1d",))
    nbr_path()
    for key, a, kw, out_bytes, count in mixed:
        nb_, fl_, mode_, _ = b1d_mode(a, kw)
        vs_plain(card, "14 mixed", key, a, kw)
        k_ms = median_ms(b1d_cost.kernel_call(*a, **kw), 10, 10)
        b_ms = bound_ms(key, a, kw, out_bytes)[0]
        print(f"[14 mixed] B1d {mode_} nb={nb_} f_lo={fl_} x{count}/step: {k_ms:.4f} ms alone "
              f"(bound {b_ms:.4f}); the design before: {before[f'mixed {mode_} nb={nb_}']} | "
              f"{card}", flush=True)
    nbr_path()
    card.done("14")
    return planned


def ms_line(card, what, k_ms, p_ms, b_ms, lib_ms, lib):
    bound = "on chip" if b_ms is None else f"{b_ms:.6f} ms"
    print(f"[15] {what}: {k_ms:.4f} ms kernel, {p_ms:.4f} ms plain, bound {bound}, "
          f"{lib} {lib_ms:.4f} ms | {card}", flush=True)


def bytes_ms(nb):
    return nb / HBM_BYTES_PER_S * 1e3


def along_rows(x_, idx, form):
    """P4 through its C entry in ``form`` (the wrapper picks the form from
    x's rows; this also runs the direct form, the design before the slab
    form, where the slab form is the wrapper's), into a fixed output."""
    out = torch.empty(idx.shape, device=DEV)
    code = build.library().hn_take_along_rows(
        x_.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0], x_.shape[0],
        cuda_probe.ALONG_ROWS_FORMS[form], build.stream_ptr(DEV))
    build.check(code, "hn_take_along_rows")
    return out


def copy_n(kw) -> int:
    return int(kw["count"][0]) if kw.get("count") is not None else kw["n"]


def rows_copied(kw) -> int:
    """Rows one launch copies: ctas x reps x n x L."""
    return kw.get("ctas", 1) * kw.get("reps", 1) * copy_n(kw) * kw.get("span", 1)


def copy_spans(x_, kw):
    """The source row of every row one round of copies reads (n x L)."""
    n, L = copy_n(kw), kw.get("span", 1)
    return (probe.source_rows(x_.shape[0], kw["rows"][:n], L, kw.get("onchip_rows", 0))
            [:, None] + torch.arange(L, device=DEV)).reshape(-1)


def copy_bound_ms(x_, kw):
    """Bytes the copies need over the HBM rate: each source row they
    read once (the data decides), the row starts, the stage and acc
    written once; None for the on-chip source. (Every copy's bytes,
    rows_copied x 2 KB, over the HBM rate would be no least time: the
    copies re-read rows the L2 holds.)"""
    if kw.get("onchip_rows", 0):
        return None
    used = int(torch.unique(copy_spans(x_, kw)).numel())
    return bytes_ms(used * 2048 + 4 * copy_n(kw) + probe.STAGE_ROWS * 2048
                    + 4 * kw.get("ctas", 1))


def copy_lib_ms(x_, kw):
    """One index_select of every row the launch copies (rows_copied:
    one round's n x L rows for each block and rep), into a buffer."""
    reps = kw.get("ctas", 1) * kw.get("reps", 1)
    idx = copy_spans(x_, kw).repeat(reps)
    buf = torch.empty(idx.numel(), 512, device=DEV)
    return median_ms(lambda: torch.index_select(x_, 0, idx, out=buf), batch=5)


def phase_15_probes(card: Card, rng, topo) -> None:
    """The probe kernels PG and PC: every PG form and every PC case of the four
    probe scripts bitwise its plain version and timed beside its bound, its
    library call and its design before the redesign; then the probe scripts
    as the probes' own path."""
    # PG's and PC's launches are a few us: each time below is per call, a
    # median over spans of back-to-back calls queued behind a spin
    # (timing.paired_ms, median_ms), so that the span holds device time and
    # not the host's launch latency
    T = topo.capacity
    nbr6 = probe.face_rows(topo.nbr)
    xg = torch.from_numpy(rng.standard_normal((T, 512)).astype(np.float32)).to(DEV)
    xm = xg * torch.from_numpy(10.0 ** rng.uniform(-15, 15, (T, 1))).float().to(DEV)
    idx8 = torch.arange(7, -1, -1, dtype=torch.int32, device=DEV)[:, None].expand(8, 512)
    idxr = torch.from_numpy(rng.integers(0, T, (T, 512)).astype(np.int32)).to(DEV)
    RX_DIRECT = 8192  # past probe.SLAB_MAX_ROWS: the wrapper's direct form
    xd = torch.from_numpy(rng.standard_normal((RX_DIRECT, 512)).astype(np.float32)).to(DEV)
    idxd = torch.from_numpy(rng.integers(0, RX_DIRECT, (T, 512)).astype(np.int32)).to(DEV)
    before = BEFORE_REDESIGN["probes"]
    for label, x_, idx, was in (("P4 per-element, 8 rows reversed", xg[:8], idx8.contiguous(),
                                 before["P4 8 rows"]),
                                (f"P4 per-element, {T} rows random", xg, idxr,
                                 before["P4 4608 rows"]),
                                (f"P4 per-element, {RX_DIRECT} source rows random, {T} out",
                                 xd, idxd, None)):
        form = cuda_probe.along_rows_form(x_.shape[0])
        got = cuda_probe.take_along_rows(x_, idx)
        want = cuda_probe.take_along_rows_plain(x_, idx)
        check(card, "PG", f"{label} ({form} form)", got, want, 0.0, "15")
        if form == "slab":
            check(card, "PG", f"{label} (direct form)", along_rows(x_, idx, "direct"), want, 0.0,
                  "15")
        k_ms, p_ms = paired_ms(lambda: cuda_probe.take_along_rows(x_, idx),
                               lambda: cuda_probe.take_along_rows_plain(x_, idx))
        i64 = idx.long()
        lib_ms = median_ms(lambda: torch.gather(x_, 0, i64), batch=10)
        src_rows = int(torch.unique(idx).numel()) if idx is not idx8 else 8
        b_ms = bytes_ms(src_rows * 2048 + 2 * nbytes(idx))
        ms_line(card, f"{label} ({form} form)", k_ms, p_ms, b_ms, lib_ms, "gather")
        if form == "slab":  # the direct form, the design before, in this call
            d_ms = median_ms(lambda: along_rows(x_, idx, "direct"), batch=10)
            print(f"[15] {label}: slab form {k_ms:.4f} ms ({b_ms / k_ms:.1%} of its bound), "
                  f"direct form {d_ms:.4f} ms ({b_ms / d_ms:.1%}) in this call; before the "
                  f"redesign {was} (recorded) | {card}", flush=True)
    del xd, idxd
    for d in range(6):
        got = cuda_probe.take_rows(xg, nbr6[d])
        check(card, "PG", f"P5 rows, T={T}, face {d}", got, cuda_probe.take_rows_plain(xg, nbr6[d]),
              0.0, "15")
        check(card, "PG", f"P5 rows, T={T}, face {d} vs index_select", got,
              xg.index_select(0, nbr6[d]), 0.0, "15")
    pg_in = (xg, nbr6[0])
    pg_bound = bytes_ms(int(torch.unique(nbr6[0]).numel()) * 2048 + nbytes(nbr6[0]) + nbytes(xg))
    k_ms, p_ms = paired_ms(lambda: cuda_probe.take_rows(*pg_in),
                           lambda: cuda_probe.take_rows_plain(*pg_in))
    lib_ms = median_ms(lambda: torch.index_select(xg, 0, nbr6[0]), batch=10)
    card.kernels["PG"].update(ms=k_ms, plain_ms=p_ms, bound_ms=pg_bound, bound_by="bytes",
                              library_ms=lib_ms)
    ms_line(card, f"P5 rows, T={T}, face 0 (one launch costs about its bound)", k_ms, p_ms,
            pg_bound, lib_ms, "index_select")
    # T - 1 rows (not a multiple of the chain's 6 rows a block), random
    # neighbours inside them
    nbr6_1 = torch.from_numpy(rng.integers(0, T - 1, (6, T - 1)).astype(np.int32)).to(DEV)
    for reps in probe_dgather.REPS:
        check(card, "PG", f"P6 chain, reps {reps}, T={T - 1} rows",
              cuda_probe.take_chain(xg[:T - 1], nbr6_1, reps),
              cuda_probe.take_chain_plain(xg[:T - 1], nbr6_1, reps), 0.0, "15")
        for inp, x_ in (("normal", xg), ("mixed scales", xm)):
            got = cuda_probe.take_chain(x_, nbr6, reps)
            check(card, "PG", f"P6 chain, reps {reps}, {inp} "
                  f"({float((got != x_).float().mean()):.2%} of values moved)", got,
                  cuda_probe.take_chain_plain(x_, nbr6, reps), 0.0, "15")
            # bound: x read once (s starts as x), the index and the output
            # once; or a multiply and an add a value a gather, if longer
            k_ms, p_ms = paired_ms(lambda: cuda_probe.take_chain(x_, nbr6, reps),
                                   lambda: cuda_probe.take_chain_plain(x_, nbr6, reps))
            b_bytes = bytes_ms(nbytes(x_) + nbytes(nbr6) + nbytes(got))
            b_ops = 2 * reps * nbr6.shape[0] * x_.numel() / F32_OPS_PER_S * 1e3
            print(f"[15] P6 chain, reps {reps}, {inp}: {k_ms:.4f} ms kernel (before the "
                  f"redesign {before[f'P6 reps {reps}, {inp}']}, recorded), {p_ms:.4f} ms "
                  f"plain, bound {max(b_bytes, b_ops):.6f} ms (by "
                  f"{'operations' if b_ops > b_bytes else 'bytes'}: bytes {b_bytes:.6f}, f32 "
                  f"operations {b_ops:.6f}), library none (no one PyTorch call computes a "
                  f"chain of dependent gathers) | {card}", flush=True)
    del xm, idxr, nbr6_1

    xb = probe_dmabisect.source(DEV)
    xc, rows_c = probe_dmacost.inputs(DEV)
    count64 = torch.tensor([64], dtype=torch.int32, device=DEV)
    pc_cases = [(name, xb, kw, pick, want) for name, kw, pick, want in
                probe_dmabisect.cases(xb) + probe_dmabisect2.cases(xb)]
    pc_cases += [(name, xc, kw, None, None) for name, kw in probe_dmacost.cases(xc, rows_c)]
    pc_cases.append(("dmacost dynamic count", xc, dict(rows=rows_c, n=0, count=count64), None,
                     None))
    # the design's other launch form (device-memory source: a cluster of
    # one, where the wrapper launches plainly) and the design before
    pc_forms = {"cluster launch": pc_cost.DESIGN & ~pc_cost.PARTS["plain launch"],
                "design before": pc_cost.BEFORE}
    for name, x_, kw, pick, want in pc_cases:
        for g in (1, ctas_all(DEV)):
            kwg = dict(kw, ctas=g)
            got, plain = cuda_probe.row_copy(x_, **kwg), cuda_probe.row_copy_plain(x_, **kwg)
            onchip = f", on-chip source {kw['onchip_rows']} rows" if kw.get("onchip_rows") else ""
            label = f"{name} ({g} block{'s' if g > 1 else ''}{onchip})"
            check(card, "PC", f"{label} stage", got[0], plain[0], 0.0, "15")
            check(card, "PC", f"{label} acc", got[1], plain[1], 0.0, "15")
            if pick is not None:  # v4's and v5's acc: one expected value for every block
                picked = pick(*got)
                check(card, "PC", f"{label} vs expected", picked, want.expand_as(picked), 0.0, "15")
            calls = {form: pc_cost.kernel_call(x_, parts, **kwg)
                     for form, parts in pc_forms.items()}
            for form, call in calls.items():
                if form == "cluster launch" and kw.get("onchip_rows"):
                    continue  # the on-chip source's only launch form: the wrapper's
                for part, g_, p_ in zip(("stage", "acc"), call(), plain):
                    check(card, "PC", f"{label} {part}, {form}", g_, p_, 0.0, "15")
            k_ms, p_ms = paired_ms(lambda: cuda_probe.row_copy(x_, **kwg),
                                   lambda: cuda_probe.row_copy_plain(x_, **kwg), batch=5)
            b_ms = median_ms(calls["design before"], batch=5)
            lib_ms = copy_lib_ms(x_, kwg) if rows_copied(kwg) else float("nan")
            ms_line(card, label, k_ms, p_ms, copy_bound_ms(x_, kwg), lib_ms, "index_select")
            print(f"[15] {label}: the design before the redesign {b_ms:.4f} ms in this call"
                  + (f" ({before['PC v5']} recorded)" if name.startswith("v5") else "")
                  + f" | {card}", flush=True)
            if rows_copied(kwg):
                print(f"[15] {label}: {rows_copied(kwg)} rows copied a launch; ns a row copied: "
                      f"PC {k_ms * 1e6 / rows_copied(kwg):.4f} (before the redesign "
                      f"{b_ms * 1e6 / rows_copied(kwg):.4f}), index_select "
                      f"{lib_ms * 1e6 / rows_copied(kwg):.4f}; every row copied over the HBM "
                      f"rate {bytes_ms(rows_copied(kwg) * 2048):.6f} ms | {card}", flush=True)
    # step 0's breakdown of the fixed cost (tools/pc_cost.py) at v5, no copy
    v5_x, v5_kw = pc_cost.cases(DEV)["v5"]
    for g in (1, ctas_all(DEV)):
        parts = pc_cost.breakdown(v5_x, dict(v5_kw, ctas=g))
        label = f"PC fixed cost (pc_cost), v5, {g} block{'s' * (g > 1)}"
        print(f"[15] {pc_cost.line(label, parts)} | {card}", flush=True)
    pc_kw = dict(rows=rows_c, n=probe_dmacost.NS[1], span=8, reps=probe_dmacost.REPS,
                 ctas=ctas_all(DEV))
    k_ms, p_ms = paired_ms(lambda: cuda_probe.row_copy(xc, **pc_kw),
                           lambda: cuda_probe.row_copy_plain(xc, **pc_kw))
    b_ms = median_ms(pc_cost.kernel_call(xc, pc_cost.BEFORE, **pc_kw), batch=10)
    lib_ms = copy_lib_ms(xc, pc_kw)
    card.kernels["PC"].update(ms=k_ms, plain_ms=p_ms, bound_ms=copy_bound_ms(xc, pc_kw),
                              bound_by="bytes", library_ms=lib_ms)
    print(f"[15] PC JSON launch (L {pc_kw['span']}, n {pc_kw['n']}, {pc_kw['reps']} reps, "
          f"{pc_kw['ctas']} blocks: {rows_copied(pc_kw)} rows copied): {k_ms:.4f} ms, "
          f"{k_ms * 1e6 / rows_copied(pc_kw):.4f} ns a row copied; index_select of as many "
          f"rows {lib_ms:.4f} ms, {lib_ms * 1e6 / rows_copied(pc_kw):.4f} ns a row; bound "
          f"{card.kernels['PC']['bound_ms']:.6f} ms (each source row once), "
          f"{bytes_ms(rows_copied(pc_kw) * 2048):.4f} for every row copied over the HBM "
          f"rate; the design before the redesign {b_ms:.4f} ms in this call, "
          f"{before['PC JSON launch']} recorded | {card}", flush=True)
    del xb, xc, rows_c

    # the probes' own path: the four probe scripts, counters 0 before, read after
    for k in card.kernels.values():
        k["counter"].n = 0
    torch.cuda.synchronize()
    runs = {}
    for mod, kw in ((probe_dgather, dict(rounds=PROBE_ROUNDS)), (probe_dmabisect, {}),
                    (probe_dmabisect2, dict(rounds=PROBE_ROUNDS)),
                    (probe_dmacost, dict(rounds=PROBE_ROUNDS))):
        tag = mod.__name__.rsplit(".", 1)[1]
        runs[tag] = mod.run(say=lambda line, tag=tag: print(f"[15 {tag}] {line}"), **kw)
    torch.cuda.synchronize()
    counts = card.counts()
    print(f"[15] probe scripts: launches {counts} (PG and PC > 0, no other kernel)", flush=True)
    if not (counts["PG"] > 0 and counts["PC"] > 0
            and all(v == 0 for key, v in counts.items() if key not in ("PG", "PC"))):
        raise AssertionError(f"phase 15: launch counts {counts}")
    for key in ("PG", "PC"):
        card.kernels[key]["launches"] += counts[key]
    chain = {k: statistics.median(v) for k, v in runs["probe_dgather"]["chain_ms_per_iter"].items()}
    print(f"[15] P6 chain ms/iter, median of {PROBE_ROUNDS} rounds: "
          + ", ".join(f"{k} {v:.4f}" for k, v in chain.items())
          + f"; bound {bytes_ms(6 * nbytes(xg)):.4f} if every gather read HBM (x, "
            f"{nbytes(xg) / 1e6:.2f} MB, stays in the L2) | {card}", flush=True)
    per_sm = HBM_BYTES_PER_S / ctas_all(DEV)
    for tag in ("probe_dmabisect2", "probe_dmacost"):
        for (source, L, g), v in runs[tag]["ns_per_copy"].items():
            ns = statistics.median(v)
            rate = L * 2048 / ns  # GB/s a block
            if source == "onchip":
                where = "bound: on chip"
            elif g == 1:
                where = (f"{rate * 1e9 / per_sm:.1%} of 3.35 TB/s / {ctas_all(DEV)}; bound "
                         f"{bytes_ms(L * 2048) * 1e6:.2f} ns/copy")
            else:
                where = (f"{rate * g / 1e3:.2f} TB/s over the blocks; bound "
                         f"{bytes_ms(L * 2048) * 1e6 / g:.3f} ns/copy over the card")
            print(f"[15] {tag} {source}, L={L}, {g} block{'s' * (g > 1)}: {ns:.2f} ns/copy a "
                  f"block (median of {PROBE_ROUNDS} rounds), {rate:.1f} GB/s a block; {where}"
                  f" | {card}", flush=True)
        for (source, L, g), v in runs[tag].get("one_drain", {}).items():
            issue = statistics.median(i for i, _ in v)
            drain = statistics.median(d for _, d in v)
            batched = statistics.median(runs[tag]["ns_per_copy"][(source, L, g)])
            per = probe.STAGE_ROWS // L
            print(f"[15] {tag} {source}, L={L}, {g} block{'s' * (g > 1)}, one drain a rep: "
                  f"issue {issue:.2f} ns/copy, drain {drain:.1f} ns/rep (medians of "
                  f"{PROBE_ROUNDS} rounds); issue + drain / {per} = {issue + drain / per:.2f} "
                  f"ns/copy beside the batched {batched:.2f} | {card}", flush=True)
        for (L, temp), v in runs[tag]["index_select_ns_per_row"].items():
            print(f"[15] {tag} index_select, L={L}, L2 {temp}: {statistics.median(v):.2f} "
                  f"ns/row | {card}", flush=True)
    card.done("15")


def phase_16_cook(card: Card, topo, state) -> None:
    """The cook on user files through the CLI, inputs written under
    build/chip_smoke/cook/: ``solve`` with exact launches and every frame
    checked, its file bitwise the state, a resume bitwise the same, one frame
    vs plain, an interrupter, the operator nodes; the I/O and a frame timed."""
    params, cfg = CELLS["bench"].params, CELLS["bench"].plume
    cook_dir = OUT / "cook"
    shutil.rmtree(cook_dir, ignore_errors=True)
    cook_dir.mkdir(parents=True)
    paths = {k: str(cook_dir / f"{k}.vdb") for k in
             ("feedback", "feedback_plain", "source", "collision", "out", "resumed")}
    n_f = topo.n_active
    org_f = (topo.origins[1:n_f + 1].cpu().numpy() * 8).astype(np.int32)
    gen = np.random.default_rng(SEED)
    extra_org = org_f[gen.permutation(n_f)[:COOK_EXTRA_LEAVES]]
    fb_grids = [vdb_io.VdbGrid("velocity", org_f, state.velocity[:, 1:n_f + 1].cpu().numpy(),
                               params.voxel_size, grid_class="staggered")]
    fb_grids += [vdb_io.VdbGrid(k, org_f, state.scalars[k][1:n_f + 1].cpu().numpy(),
                                params.voxel_size,
                                grid_class="fog volume" if k == "density" else "unknown")
                 for k in sorted(state.scalars)]
    fb_grids.append(vdb_io.VdbGrid(COOK_EXTRA, extra_org, gen.standard_normal(
        (3, len(extra_org), 512)).astype(np.float32), params.voxel_size))
    io_s = {}
    for what, path, comp in (("plain", paths["feedback_plain"], False),
                             ("blosc", paths["feedback"], "blosc")):
        t0 = time.perf_counter()
        vdb_io.write_vdb(path, fb_grids, compress=comp)
        io_s[f"write {what}"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = vdb_io.read_vdb(paths["feedback_plain"])
    io_s["read plain"] = time.perf_counter() - t0
    if [g["name"] for g in back] != [g.name for g in fb_grids]:
        raise AssertionError("phase 16: the plain feedback file lost a grid")
    del back
    # source: one frame of emit's density, temperature and fuel on the emitter's tiles
    etopo = build_topology(plume.emitter_tiles(cfg), device=DEV)
    em = plume.emit(etopo, zeros_state(etopo), cfg, params.dt)
    org_e = (etopo.origins[1:etopo.n_active + 1].cpu().numpy() * 8).astype(np.int32)
    vdb_io.write_vdb(paths["source"], [
        vdb_io.VdbGrid(k, org_e, em.scalars[k][1:etopo.n_active + 1].cpu().numpy(),
                       params.voxel_size) for k in ("density", "temperature", "fuel")])
    # collision: config 4's sphere as a narrow-band SDF (in voxels) over its shell tiles
    ccol = CELLS["c4"].collider
    sh_t = np.unique(collider.collider_tiles(ccol, 0, params.dt), axis=0)
    pos = (sh_t * 8)[:, None, :] + np.stack(np.meshgrid(*([np.arange(8)] * 3), indexing="ij"),
                                            -1).reshape(1, 512, 3)
    sdf_vals = np.clip(np.linalg.norm(pos - np.asarray(ccol.center0), axis=-1) - ccol.radius,
                       -COOK_BAND, COOK_BAND).astype(np.float32)
    vdb_io.write_vdb(paths["collision"], [vdb_io.VdbGrid(
        COOK_SDF, (sh_t * 8).astype(np.int32), sdf_vals, params.voxel_size,
        grid_class="level set", background=COOK_BAND)])
    print(f"[16] inputs: feedback {n_f} leaves x {len(fb_grids)} grids ({COOK_EXTRA}: "
          f"{len(extra_org)} leaves, passed through), source {etopo.n_active} emitter leaves, "
          f"collision {len(sh_t)} shell leaves (sphere {ccol.center0} r {ccol.radius}, band "
          f"{COOK_BAND})", flush=True)

    # the cook through the CLI: every frame's pieces timed, its states checked
    real = {k: getattr(solve, k) for k in
            ("_source_state", "cfl_clamped_count", "step", "expand_for_state", "_sdf_field",
             "run_solve")}
    split, caps16, frames16, cooked = collections.defaultdict(list), [], [], {}

    def timed(name, fn):
        def wrapped(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **kw)
            e1.record()
            torch.cuda.synchronize()
            if name == "step":
                caps16.append(a[0].capacity)
                split["step (CUDA events)"].append(e0.elapsed_time(e1) / 1e3)
            if name != "_sdf_field" or caps16:  # the SDF's re-scatters, not its first
                split[name].append(time.perf_counter() - t0)
            return out
        return wrapped

    def spy_run_solve(inp, *a, on_frame=None, **kw):
        cooked["inp"] = inp

        def both(f, topo_, st):
            check_state("16", topo_, st)
            if not torch.equal(st.scalars[COLLISION_FIELD], real["_sdf_field"](topo_, inp)):
                raise AssertionError(f"phase 16: frame {f}: the SDF is not the input re-scattered")
            frames16.append((topo_.n_active, topo_.capacity))
            on_frame(f, topo_, st)
        cooked["topo"], cooked["state"] = real["run_solve"](inp, *a, on_frame=both, **kw)
        return cooked["topo"], cooked["state"]

    read_s = []

    def timed_read(path, *a, **kw):
        t0 = time.perf_counter()
        out = real_read(path, *a, **kw)
        read_s.append((os.path.basename(path), time.perf_counter() - t0))
        return out

    real_read = vdb_io.read_vdb
    cook_argv = [paths["feedback"], "--source", paths["source"], "--collision",
                 paths["collision"], "--device", "cuda"]
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for k in ("_source_state", "cfl_clamped_count", "step", "expand_for_state",
                  "_sdf_field"):
            stack.enter_context(mock.patch.object(solve, k, timed(k, real[k])))
        stack.enter_context(mock.patch.object(solve, "run_solve", spy_run_solve))
        stack.enter_context(mock.patch.object(vdb_io, "read_vdb", timed_read))
        stack.enter_context(main_path(card, "16", totals(caps16, SolverParams(has_collision=True))))
        cli.main(["solve", *cook_argv, "--frames", str(COOK_FRAMES), "--ckpt-every",
                  str(COOK_FRAMES // 2), "--out", paths["out"]])
    cook_wall = time.perf_counter() - t0
    io_s["read blosc"] = dict(read_s)["feedback.vdb"]
    print(f"[16] feedback file seconds (io/vdb.py, host): write plain {io_s['write plain']:.3f}, "
          f"write blosc {io_s['write blosc']:.3f}, read plain {io_s['read plain']:.3f}, read "
          f"blosc {io_s['read blosc']:.3f} (the cook's own read); "
          f"{os.path.getsize(paths['feedback_plain']) / 1e6:.1f} MB plain, "
          f"{os.path.getsize(paths['feedback']) / 1e6:.1f} MB blosc | {card}", flush=True)
    if len(frames16) != COOK_FRAMES:
        raise AssertionError(f"phase 16: {len(frames16)} frames cooked, not {COOK_FRAMES}")
    med = {k: statistics.median(v) for k, v in split.items()}
    print(f"[16] cook: {COOK_FRAMES} frames in {cook_wall:.2f} s wall (the blosc feedback read "
          f"included); tiles / capacity per frame {frames16}; steps at capacities {caps16}",
          flush=True)
    print(f"[16] seconds a frame, median of {COOK_FRAMES}: source scatter "
          f"{med['_source_state']:.5f}, CFL guard {med['cfl_clamped_count']:.5f}, step "
          f"{med['step (CUDA events)']:.5f} (CUDA events; host {med['step']:.5f}), growth "
          f"{med['expand_for_state']:.5f}, SDF re-scatter "
          f"{med.get('_sdf_field', 0.0):.5f} ({len(split['_sdf_field'])} of "
          f"{COOK_FRAMES} frames changed the topology) | {card}", flush=True)

    # the state written back, and the file
    topo16, st16, inp16 = cooked["topo"], cooked["state"], cooked["inp"]
    out_grids = vdb_io.read_vdb(paths["out"])
    names16 = [g["name"] for g in out_grids]
    want_names = (["velocity"] + sorted(k if k != COLLISION_FIELD else COOK_SDF
                                        for k in st16.scalars) + [COOK_EXTRA])
    if names16 != want_names:
        raise AssertionError(f"phase 16: output grids {names16} != {want_names}")
    for g in out_grids[:-1]:
        rows = lookup_tiles(topo16, g["origins"] // 8)
        if not (bool((rows > 0).all()) and len(rows) == topo16.n_active):
            raise AssertionError(f"phase 16: {g['name']} leaves are not the active tiles")
        name = COLLISION_FIELD if g["name"] == COOK_SDF else g["name"]
        want = (st16.velocity[:, rows] if name == "velocity" else st16.scalars[name][rows])
        if not np.array_equal(g["values"], want.cpu().numpy()):
            raise AssertionError(f"phase 16: {g['name']} in the file != the state")
    ex_in, ex_out = inp16.extra_vecs[0], out_grids[-1]
    if not (np.array_equal(ex_in["origins"], ex_out["origins"])
            and np.array_equal(ex_in["values"], ex_out["values"])):
        raise AssertionError(f"phase 16: the passthrough grid {COOK_EXTRA} changed")
    print(f"[16] {paths['out']}: grids {names16}, each equal to the state's active rows "
          f"bitwise ({topo16.n_active} tiles), {COOK_EXTRA} equal to the input bitwise",
          flush=True)

    # resume from the mid-run checkpoint: the same output, bitwise
    caps16.clear()
    with main_path(card, "16 resume", totals(caps16, SolverParams(has_collision=True))), \
            mock.patch.object(solve, "step", timed("step", real["step"])):
        cli.main(["solve", str(cook_dir / f"solve_{COOK_FRAMES // 2:04d}.npz"), *cook_argv[1:],
                  "--frames", str(COOK_FRAMES - COOK_FRAMES // 2), "--out", paths["resumed"]])
    res = vdb_io.read_vdb(paths["resumed"])
    if [g["name"] for g in res] != names16[:-1] or not all(
            np.array_equal(a["origins"], b["origins"]) and np.array_equal(a["values"], b["values"])
            for a, b in zip(res, out_grids)):
        raise AssertionError("phase 16: the resumed output differs from the uninterrupted one")
    print(f"[16] resume from solve_{COOK_FRAMES // 2:04d}.npz: every grid bitwise equal to the "
          f"uninterrupted output (the passthrough comes only from a .vdb feedback)", flush=True)

    # one cook frame through the kernels vs through the plain versions
    p16 = SolverParams(voxel_size=inp16.voxel_size, has_collision=True)
    step_vs_plain(card, "16", lambda: solver.step(topo16, st16, p16))

    # the interrupter: a poll that trips after frame 2
    seen = []
    intr = Interrupter(poll=lambda: len(seen) >= 2)
    solve.run_solve(inp16, SolverParams(), COOK_FRAMES, interrupter=intr, device=DEV,
                    on_frame=lambda f, t_, s_: seen.append(f), warn=lambda m: None)
    if seen != [0, 1]:
        raise AssertionError(f"phase 16: the interrupted run cooked frames {seen}, not [0, 1]")
    print(f"[16] interrupter tripping after frame 2 of {COOK_FRAMES}: frames {seen} cooked",
          flush=True)

    # the operator nodes on the cook's output (the resumed file: every grid of
    # out.vdb but the passthrough Vec3, which the nodes would take as the velocity)
    node_topo = []
    real_load = cli._load_vdb_fields

    def spy_load(*a, **kw):
        got = real_load(*a, **kw)
        node_topo.append(got[0].capacity)
        return got

    def node_counts(kind):
        def want():
            cap = node_topo[-1]
            if kind == "advect":
                return {"B1": -(-(len(names16) - 2) // cuda_bfecc.MAX_SCALARS),
                        "B2": -(-(len(names16) - 2) // cuda_bfecc.MAX_SCALARS)}
            if kind == "advect-velocity":
                return {"B1": 1, "B2": 1}
            if kind == "outdiv":
                return {"B7a": 1}
            c = step_counts(cap, SolverParams(iterations=20))
            c["B1"] = c["B2"] = 0
            return c
        return want

    div_max = {}
    with mock.patch.object(cli, "_load_vdb_fields", spy_load):
        for kind, argv in (("advect", ["advect"]), ("advect-velocity", ["advect-velocity"]),
                           ("project", ["project", "--iterations", "20"]),
                           ("outdiv", ["project", "--outdiv"])):
            node_out = str(cook_dir / f"{kind}.vdb")
            with main_path(card, f"16 {kind}", node_counts(kind)):
                cli.main([argv[0], paths["resumed"], *argv[1:], "--out", node_out,
                          "--device", "cuda"])
            for g in vdb_io.read_vdb(node_out):
                if not np.isfinite(g["values"]).all():
                    raise AssertionError(f"phase 16: {kind} wrote non-finite {g['name']}")
            if kind == "project":
                cli.main(["project", node_out, "--outdiv", "--out",
                          str(cook_dir / "div_projected.vdb"), "--device", "cuda"])
                div_max["projected"] = float(np.abs(vdb_io.read_vdb(
                    str(cook_dir / "div_projected.vdb"))[0]["values"]).max())
            if kind == "outdiv":
                div_max["input"] = float(np.abs(vdb_io.read_vdb(node_out)[0]["values"]).max())
    print(f"[16] operator nodes on the cook's output (capacity {node_topo[0]}): launches as "
          f"expected, outputs finite; max|div| {div_max['input']:.4f} -> "
          f"{div_max['projected']:.4f} after project --iterations 20", flush=True)
    if not div_max["projected"] < div_max["input"]:
        raise AssertionError(f"phase 16: projection did not lower max|div|: {div_max}")
    card.done("16")


@contextlib.contextmanager
def step_caps(model, caps: list):
    """``model.step`` recording the capacity each step runs at."""
    real_step = model.step

    def wrapped(topo_, *a, **kw):
        caps.append(topo_.capacity)
        return real_step(topo_, *a, **kw)

    with mock.patch.object(model, "step", wrapped):
        yield


def stepped(card, label: str, model, p_, run, what: str = "") -> None:
    """``run()`` on the card as a main path: the launches of the steps of
    ``model`` it ran, from the capacity each ran at (renders launch none)."""
    caps = []
    t0 = time.perf_counter()
    with step_caps(model, caps), main_path(card, label, totals(caps, p_, emits(model))):
        run()
    print(f"[{label}] {what}{len(caps)} steps at capacities {caps}, "
          f"{time.perf_counter() - t0:.2f} s wall | {card}", flush=True)


def png_frames(path) -> tuple[list, int | None]:
    """([H, W, 3] uint8 per frame, acTL's frame count or None) of a PNG /
    APNG written by viewer/render.py (8-bit RGB, filter 0 on every row);
    raises on a malformed file."""
    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"phase 17: {path} is not a PNG")
    w, h = struct.unpack(">II", data[16:24])
    pos, frames, n_actl = 8, [], None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] != (
                zlib.crc32(tag + body) & 0xFFFFFFFF):
            raise AssertionError(f"phase 17: {path}: bad CRC in {tag}")
        if tag == b"acTL":
            n_actl = struct.unpack(">I", body[:4])[0]
        elif tag in (b"IDAT", b"fdAT"):
            raw = np.frombuffer(zlib.decompress(body if tag == b"IDAT" else body[4:]),
                                np.uint8).reshape(h, 1 + 3 * w)
            if raw[:, 0].any():
                raise AssertionError(f"phase 17: {path}: a row filter other than 0")
            frames.append(raw[:, 1:].reshape(h, w, 3))
        pos += 12 + n
    return frames, n_actl


def png_pixels(path) -> np.ndarray:
    return png_frames(path)[0][0].astype(int)


def as_png(img) -> np.ndarray:
    """What write_png stores of a float image."""
    return np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8).astype(int)


def get(base, path):
    """GET ``base + path`` from a local server, past any proxy setting."""
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    with opener.open(base + path, timeout=120) as r:
        return r.read()


def serve_checks(card, label, src, steps: int):
    """The page, ``steps`` frames through /step (a live source), then
    /meta and the density volume (its u8 peak 255); a static source
    answers /step with 404."""
    httpd, thread = webapp.serve(src, port=0, block=False)
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        if get(base, "/") != webapp.PAGE.encode():
            raise AssertionError(f"phase {label}: / is not the page")
        if steps:
            t0_ = time.perf_counter()
            frame = json.loads(get(base, f"/step?n={steps}"))["frame"]
            print(f"[{label}] /step?n={steps}: frame {frame}, {time.perf_counter() - t0_:.3f} "
                  f"s wall | {card}", flush=True)
        else:
            try:
                get(base, "/step?n=1")
                raise AssertionError(f"phase {label}: a static source stepped")
            except urllib.error.HTTPError as e:
                if e.code != 404:
                    raise
        meta = json.loads(get(base, "/meta"))
        dims = meta["fields"]["density"]["dims"]
        vol = get(base, "/volume?field=density")
        if meta["frame"] != steps or len(vol) != int(np.prod(dims)) or max(vol) != 255:
            raise AssertionError(f"phase {label}: frame {meta['frame']}, /volume {len(vol)} "
                                 f"bytes for {dims}")
        print(f"[{label}] GET / /meta /volume on port {httpd.server_address[1]}: frame "
              f"{meta['frame']}, dims {dims}, {len(vol)} bytes, step_ms {meta['step_ms']} "
              f"(host clock a frame, the bake included)", flush=True)
    finally:
        httpd.shutdown()
        httpd.server_close()
    thread.join(timeout=60)
    if thread.is_alive():
        raise AssertionError(f"phase {label}: the server thread did not stop")


def phase_17_viewer(card: Card, topo, state) -> None:
    """The viewer and the profiling entry points through ``cli.main`` as main
    paths (outputs under build/chip_smoke/view/), the viewer's server, the
    device trace and ``Profiler.scope`` around one bench step, render times."""
    params, cfg = CELLS["bench"].params, CELLS["bench"].plume
    view_dir = OUT / "view"
    shutil.rmtree(view_dir, ignore_errors=True)
    view_dir.mkdir(parents=True)

    # plume: renders every 2 frames and a checkpoint at frame 4
    d_plume = view_dir / "plume"
    stepped(card, "17 plume", plume, SolverParams(), lambda: cli.main(
        ["plume", "--frames", "4", "--render", "--render-every", "2", "--view-box", "128", "128",
         "128", "--ckpt-every", "4", "--out", str(d_plume), "--device", "cuda"]), "plume: ")
    ex, ey = 64, 16  # the image is (x, y): the emitter at the CLI's --center 64 16 64
    for f in (2, 4):
        img = png_pixels(d_plume / f"frame_{f:04d}.png")
        if img.shape != (128, 128, 3) or not img[ex, ey].sum() > img[2, 125].sum() + 20:
            raise AssertionError(f"phase 17: frame_{f:04d}.png {img.shape}: no smoke at the "
                                 f"emitter {img[ex, ey]} beside the corner {img[2, 125]}")
        print(f"[17] plume frame_{f:04d}.png: 128x128, emitter pixel {img[ex, ey].tolist()}, "
              f"corner {img[2, 125].tolist()}", flush=True)
    ck = str(d_plume / "frame_0004.npz")
    renders = [render.render_state(*load_npz(ck, device=where)[:2], (128, 128, 128))
               for where in (DEV, "cpu")]
    err = float(np.abs(renders[0] - renders[1]).max())
    print(f"[17] render_state of frame_0004.npz on the card vs on the CPU: max abs err "
          f"{err:.3e} (tol 1e-5)", flush=True)
    if not err <= 1e-5:
        raise AssertionError(f"phase 17: the card's render differs from the CPU's by {err}")

    # collide: the solid occludes (its pixel is the solid's colour, not the smoke render's)
    d_col = view_dir / "collide"
    stepped(card, "17 collide", collider, SolverParams(has_collision=True), lambda: cli.main(
        ["collide", "--frames", "2", "--render", "--ckpt-every", "2", "--out", str(d_col),
         "--device", "cuda"]), "collide: ")
    img = png_pixels(d_col / "frame_0002.png")
    t_, s_, _, _ = load_npz(str(d_col / "frame_0002.npz"), device=DEV)
    bare = as_png(render.render_state(t_, s_, (128, 128, 128), solid=None))
    cx, cy = 42, 56  # inside the sphere (centre (40, 56, 64) + 2 voxels a frame, r 14)
    solid_px = (np.array((0.45, 0.47, 0.5)) * 255).astype(int)
    print(f"[17] collide frame_0002.png: pixel ({cx}, {cy}) {img[cx, cy].tolist()}, without the "
          f"solid {bare[cx, cy].tolist()}, the solid's colour {solid_px.tolist()}", flush=True)
    if not (np.abs(img[cx, cy] - solid_px).max() <= 3 and np.abs(img[cx, cy]
                                                               - bare[cx, cy]).max() > 20):
        raise AssertionError("phase 17: the collider does not occlude")

    # fire: the PNG is the card's render of its checkpoint (flame tints it)
    d_fire = view_dir / "fire"
    stepped(card, "17 fire", fire, fire.default_params().replace(iterations=20), lambda: cli.main(
        ["fire", "--frames", "2", "--render", "--ckpt-every", "2", "--out", str(d_fire),
         "--device", "cuda"]), "fire: ")
    img = png_pixels(d_fire / "fire_0002.png")
    t_, s_, _, _ = load_npz(str(d_fire / "fire_0002.npz"), device=DEV)
    warm = img[..., 0] - img[..., 2]
    print(f"[17] fire fire_0002.png: {img.shape}, max red - blue {int(warm.max())} (background "
          f"{int(warm[2, 125])}), max flame {float(s_.scalars['flame'].max()):.4f}", flush=True)
    if not np.array_equal(img, as_png(render.render_state(t_, s_, (128, 128, 128)))):
        raise AssertionError("phase 17: fire_0002.png is not the render of its checkpoint")

    # turntable of the plume checkpoint: 8 PNGs and an APNG of 8 frames
    d_turn = view_dir / "turntable"
    with main_path(card, "17 turntable", {}):
        t0 = time.perf_counter()
        cli.main(["turntable", "--ckpt", ck, "--frames", "8", "--size", "384", "--out",
                  str(d_turn), "--device", "cuda"])
    turn_s = time.perf_counter() - t0
    pngs = sorted(p_.name for p_ in d_turn.glob("turn_*.png"))
    anim, n_actl = png_frames(d_turn / "turntable.apng")
    if len(pngs) != 8 or len(anim) != 8 or n_actl != 8:
        raise AssertionError(f"phase 17: turntable wrote {pngs}, an APNG of {len(anim)} frames "
                             f"(acTL {n_actl})")
    for i, a_ in enumerate(anim):
        if a_.shape != (384, 384, 3) or not np.array_equal(a_, png_pixels(
                d_turn / f"turn_{i:03d}.png")):
            raise AssertionError(f"phase 17: turntable frame {i} differs from its PNG")
    if np.array_equal(anim[0], anim[2]):
        raise AssertionError("phase 17: the orbit's frames do not change with the angle")
    print(f"[17] turntable: {len(pngs)} PNGs of 384x384 and turntable.apng (acTL 8 frames), "
          f"{turn_s:.2f} s wall ({turn_s / 8 * 1e3:.1f} ms a frame, PNG writes included) | "
          f"{card}", flush=True)

    # bench-report at its defaults (64^3 box: 512 tiles at capacity 1024)
    br = {"lo": 2, "hi": 10, "repeats": 4}  # phase_profile.profile's defaults, --chain 10

    def report_counts():
        """Each phase body's launches times its applications (lo + hi
        chained runs, each run once to warm and ``repeats`` times timed), and
        the full step's also the 2 warm-up plume steps (each one EM), and
        one B7a for the pressure phases' input divergence: the bodies launch
        B1 + B2 (velocity), B7a, the pressure solve at halo lag 1 (one B5 at
        T <= 2048), B7b, B1 + B2 (scalars); vorticity is an exact no-op at
        factor_scale 0.5 and combustion plain torch."""
        apps = (br["lo"] + br["hi"]) * (1 + br["repeats"])
        cap = prof_times["capacity"]
        body = {"B1": 2, "B2": 2, "B7a": 1, "B7b": 1}
        body.update({k: v for k, v in step_counts(cap, SolverParams(halo_lag=1)).items()
                     if k in ("B3", "B4", "B5")})
        full = step_counts(cap, SolverParams())
        out = {k: body.get(k, 0) * apps + full.get(k, 0) * (apps + 2)
               for k in set(body) | set(full)}
        out["B7a"] += 1  # phase_functions' div0, once
        out["EM"] = 2 * emits(plume)
        return out

    out_buf = io.StringIO()
    real_profile = phase_profile.profile
    prof_times = {}

    def spy_profile(topo_, *a, **kw):
        prof_times["capacity"] = topo_.capacity
        prof_times["times"] = real_profile(topo_, *a, **kw)
        return prof_times["times"]

    t0 = time.perf_counter()
    with main_path(card, "17 bench-report", report_counts), \
            contextlib.redirect_stdout(out_buf), mock.patch.object(phase_profile, "profile",
                                                                   spy_profile):
        cli.main(["bench-report", "--device", "cuda"])
    report = out_buf.getvalue().strip()
    print(f"[17] bench-report (defaults: 64^3, --frames 2, --chain 10; "
          f"{time.perf_counter() - t0:.2f} s wall) | {card}\n{report}", flush=True)
    floor = 1e-9  # timers.chain_slope's floor, seconds; the no-op vorticity may sit on it
    times17 = prof_times["times"]
    flat = [k for k, v in times17.items() if not v > floor and k != "vorticity_confinement"]
    if len(times17) != 8 or flat or prof_times["capacity"] != 1024:
        raise AssertionError(f"phase 17: bench-report phases {list(times17)} at capacity "
                             f"{prof_times['capacity']}, at the floor {flat}")

    # the viewer server: live plume at the view subcommand's default box, then the npz
    live = webapp.live_source("plume", shape=(256, 256, 256), params=SolverParams(), device=DEV)
    caps_live = []
    with step_caps(plume, caps_live), main_path(card, "17 view --live", totals(
            caps_live, SolverParams(), emits(plume))):
        serve_checks(card, "17 view --live", live, 2)
    moved = {k: card.kernels[k]["counter"].n for k in ("B1", "B3", "B5")}
    print(f"[17] live plume: steps at capacities {caps_live}, launches {moved}", flush=True)
    if not (len(caps_live) == 2 and moved["B1"] == 4 and moved["B3"] + moved["B5"] > 0):
        raise AssertionError(f"phase 17: the live viewer's steps launched {moved}")
    with main_path(card, "17 view npz", {}):
        serve_checks(card, "17 view npz", webapp.file_source(ck, device=DEV), 0)

    # device_trace and Profiler.scope around one bench step
    trace_dir = view_dir / "trace"
    with profiling.device_trace(str(trace_dir)):
        with profiling.span("bench step"):
            plume.plume_step(topo, state, params, cfg)
        torch.cuda.synchronize()
    traces = list(trace_dir.glob("*.json"))
    events = json.loads(traces[0].read_text())["traceEvents"] if len(traces) == 1 else []
    hn = sorted({e["name"] for e in events if e.get("cat") == "kernel"
                 and "hn::" in e.get("name", "")})
    spans = {e.get("name", "") for e in events} & {"bench step", "plume.step", "step.pressure"}
    launch_spans = sorted({e["name"] for e in events if e.get("name", "").startswith("launch.")})
    recs = profiling.records()
    phase_ms = sum(r.device_ms for r in recs if r.name.startswith("step."))
    print(f"[17] device_trace: {[t_.name for t_ in traces]}, {len(events)} events, "
          f"hand-written kernels on the device timeline: {hn}; program spans {sorted(spans)}, "
          f"{launch_spans}; {len(recs)} records, phases {phase_ms:.3f} device ms", flush=True)
    if not hn:
        raise AssertionError("phase 17: the trace holds no kernel of the port")
    if len(spans) != 3 or not launch_spans or not phase_ms > 0:
        raise AssertionError("phase 17: the trace lacks the program's spans")
    profiling.clear()
    prof = timers.Profiler()
    with prof.scope("bench step", voxels=topo.num_voxels,
                    bytes_per_voxel=timers.full_step_bytes_per_voxel(params.iterations)) as out:
        out["result"] = plume.plume_step(topo, state, params, cfg)
    print(f"[17] Profiler.scope: {prof.records[0]} | {card}", flush=True)

    # render times: ortho at 128^3 (the plume checkpoint), perspective 384^2 x 256 steps
    t_, s_, _, _ = load_npz(ck, device=DEV)
    dense128 = tiles_to_dense(t_, s_.scalar_blocks("density"), (128, 128, 128))
    ortho_ms = statistics.median(time_ms(lambda: render.render_state(t_, s_, (128, 128, 128)), 5,
                                         device=DEV))
    persp_ms = statistics.median(time_ms(lambda: render.render_perspective(
        dense128, size=(384, 384), steps=256), 3, device=DEV))
    print(f"[17] render ms a frame (CUDA events around the call, its copy to the host included; "
          f"median): render_state ortho 128^3 {ortho_ms:.2f}, render_perspective 384^2 x 256 "
          f"steps {persp_ms:.2f} | {card}", flush=True)
    card.done("17")


def n_launches(nc_: int, k: int) -> int:
    """The kernel calls of a pass over k slices: JAX's scan over full
    slices of ceil(nc / k) chunks plus one call on the remainder."""
    return 1 if k <= 1 else -(-nc_ // -(-nc_ // k))


def jax_dispatch(tb_, passes: list, comb: bool, budget: int) -> dict:
    """B1d, B11, B8 and B1 launches of the table passes as the JAX
    package's dispatch gives them (``advection.py:233-255``,
    ``pallas_bfecc.py:955-1087``), from each pass's fields and the
    branch it took: a sliced pass builds no table by B11; the mixed band
    shares its table and may sample forward from it only when neither
    its dual plan nor the 27-table plan of its forward fields slices."""
    nc_, Ud_ = tb_.chunk_dsrc.shape[:2]
    U27 = tb_.chunk_uniq.shape[1]
    c = collections.Counter()
    for nb_, f_lo_, has_sdf, taken in passes:
        if "wide" in taken:
            c["B1"] += 1
            continue
        kd = tables.pick_slices(nc_, Ud_, nb_ + has_sdf, budget)
        if "narrow" in taken:
            c["B1d"] += n_launches(nc_, kd)
            c["B11"] += int(kd <= 1 and comb)
            continue
        k27 = tables.pick_slices(nc_, U27, max(nb_ if f_lo_ == 0 else nb_ - 3, 1), budget)
        if kd <= 1 and k27 <= 1:
            c["B11"] += int(comb)
            c["B1d"] += 1 + int("mixed fwd narrow" in taken)
            c["B8"] += int("mixed fwd wide" in taken)
        else:
            c["B1d"] += n_launches(nc_, kd)
            c["B11"] += int(kd <= 1 and comb)
            c["B8"] += 1
    return dict(c)


@contextlib.contextmanager
def table_passes(passes: list):
    """advection._table_samples recording (nb, f_lo, SDF, branches taken)
    of each pass."""
    real_ts = advection._table_samples

    def spy(topo_, fields, sdt_, f_lo_, sdf_):
        before = collections.Counter(advection.BANDS)
        out = real_ts(topo_, fields, sdt_, f_lo_, sdf_)
        passes.append((fields.shape[0], f_lo_, sdf_ is not None,
                       dict(advection.BANDS - before)))
        return out

    with mock.patch.object(advection, "_table_samples", spy):
        yield


def sliced_counts(tb_, passes, comb, budget, p_):
    """The launches of one table-path step with the budget ``budget``,
    from the passes :func:`table_passes` recorded (asked after the step)."""
    def want():
        c = step_counts(tb_.capacity, p_, emits(plume))
        del c["B1"]
        c.update(jax_dispatch(tb_, passes, comb, budget))
        return c
    return want


def phase_18_sliced_tables(card: Card, topo, state, planned: dict) -> None:
    """The sliced table path (above ``TABLE_BYTES_BUDGET``): bench steps
    bitwise the unsliced step, launches as the JAX package's dispatch gives
    them; config 5 with phase 14's plans within TOL_STEP of the nbr path."""
    bench = CELLS["bench"]
    params, cfg = bench.params, bench.plume
    c5_rb, cfg5 = CELLS["c5"].params, CELLS["c5"].plume
    cfl0 = outside_cfl(topo, state, cfg, params)
    real_budget = advection.TABLE_BYTES_BUDGET
    tb18 = planned["bench"]
    nc18, Ud18 = tb18.chunk_dsrc.shape[:2]
    budget18 = tables.table_bytes(nc18, Ud18, 3) // 3  # the velocity pass's table: 3 slices
    ks = {nf: tables.pick_slices(nc18, Ud18, nf, budget18) for nf in (3, 8)}
    print(f"[18] bench ({nc18} chunks, Ud {Ud18}, U {tb18.chunk_uniq.shape[1]}): budget "
          f"{budget18} B -> {ks[3]} slices at 3 fields ({n_launches(nc18, ks[3])} launches), "
          f"{ks[8]} at 8 ({n_launches(nc18, ks[8])} launches)", flush=True)
    if not min(ks.values()) >= 3:
        raise AssertionError(f"phase 18: the bench tables take {ks} slices, not >= 3")
    for band, cfl in BANDS[:2]:
        vb = (state.velocity * (cfl / cfl0)).contiguous()
        sb = FieldState(velocity=vb, scalars=state.scalars)
        for comb in (False, True):
            label = f"18 {band} COMBINE_TBL={comb}"
            vmem(comb)
            whole = plume.plume_step(tb18, sb, params, cfg)
            advection.TABLE_BYTES_BUDGET = budget18
            passes = []
            try:
                with table_passes(passes), main_path(card, label, sliced_counts(
                        tb18, passes, comb, budget18, params)):
                    sliced = plume.plume_step(tb18, sb, params, cfg)
            finally:
                advection.TABLE_BYTES_BUDGET = real_budget
            nbr_path()
            same = [k for k in ["velocity"] + sorted(whole.scalars) if torch.equal(
                whole.velocity if k == "velocity" else whole.scalars[k],
                sliced.velocity if k == "velocity" else sliced.scalars[k])]
            print(f"[{label}] passes (nb, f_lo, SDF, branches) {passes}; bitwise the unsliced "
                  f"step: {same}", flush=True)
            if len(same) != 1 + len(whole.scalars):
                raise AssertionError(f"phase {label}: the sliced step differs from the unsliced")
    del vb, sb, whole, sliced

    # config 5 under "vmem" with its plans at the real budget
    c5p = planned["config 5"]
    nc5, Ud5 = c5p.chunk_dsrc.shape[:2]
    U5 = c5p.chunk_uniq.shape[1]
    torch.cuda.empty_cache()
    nbr_path()
    with main_path(card, "18 c5 develop", RBGS50_STEP, CELLS["c5"].develop):
        c5p, st5 = plume.run_plume(CELLS["c5"].develop, c5_rb, cfg5, topo=c5p, grow_every=0)
    k5 = {nf: tables.pick_slices(nc5, Ud5, nf, real_budget) for nf in (3, 8)}
    print(f"[18] config 5: {nc5} chunks, Ud {Ud5}, U {U5}; table bytes (byte model) "
          f"{tables.table_bytes(nc5, Ud5, 3)} at 3 fields, {tables.table_bytes(nc5, Ud5, 8)} at 8 "
          f"against the budget {real_budget}: pick_slices {k5} -> B1d launches "
          f"{ {nf: n_launches(nc5, k) for nf, k in k5.items()} }", flush=True)
    nbr_path()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out_n = plume.plume_step(c5p, st5, c5_rb, cfg5)
    torch.cuda.synchronize()
    peak_n = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    vmem(None)
    passes = []
    with table_passes(passes), main_path(card, "18 c5 vmem", sliced_counts(
            c5p, passes, False, real_budget, c5_rb)):
        out_v = plume.plume_step(c5p, st5, c5_rb, cfg5)
    peak5 = torch.cuda.max_memory_allocated()
    n_b1d = card.kernels["B1d"]["counter"].n
    if not n_b1d > len(passes):
        raise AssertionError(f"phase 18: config 5's table passes {passes} did not slice")
    worst, parts = field_errors(out_v, out_n, True)
    print(f"[18] config 5 sliced step: passes {passes}, B1d launches {n_b1d}; vs the "
          f"nbr-path step, max rel err per field: {', '.join(parts)} (tol {TOL_STEP:g})",
          flush=True)
    if not worst <= TOL_STEP:
        raise AssertionError(f"phase 18: config 5 sliced step vs nbr {worst} > {TOL_STEP}")
    del out_n, out_v
    c5_ms = {}
    for name, mode in (("vmem (sliced)", None), ("nbr", "nbr")):
        if mode == "nbr":
            nbr_path()
        else:
            vmem(None)
        c5_ms[name] = statistics.median(time_ms(lambda: plume.plume_step(c5p, st5, c5_rb, cfg5),
                                                3))
    nbr_path()
    print(f"[18] config 5 RBGS-50 step, ms (median of 3, CUDA events): table path sliced "
          f"{c5_ms['vmem (sliced)']:.1f}, nbr path {c5_ms['nbr']:.1f}; peak device memory of the "
          f"sliced step {peak5 / 2**30:.2f} GiB, of the nbr step {peak_n / 2**30:.2f} GiB (the "
          f"developed state and the plans held) | {card}", flush=True)
    card.done("18")


def textbook(f):
    """A refresh hook that moves nothing: the one-device step under the
    sharded step's dispatch (B4 colour sweeps at the fine level)."""
    return f


@contextlib.contextmanager
def fine_cycles(counts: collections.Counter):
    """Fine-level V-cycles per thread (the calls that carry a refresh)."""
    real_v = multigrid.v_cycle

    def spy(*a, **kw):
        if kw.get("refresh") is not None:
            counts[threading.current_thread().name] += 1
        return real_v(*a, **kw)

    with mock.patch.object(multigrid, "v_cycle", spy):
        yield


def sharded_counts(p_, n: int, cycles: collections.Counter, emit: bool = True):
    """Launches of one textbook step on each of ``n`` devices, each with
    its emit (EM) where ``emit`` (the sharded plume step's): B4 2 a
    fine iteration, or for multigrid (mg_levels 2: level 1 and 2 by B5)
    8 B4 a fine V-cycle, B5 3 and B6 2, FMG's extra B5 4 and B6 1, and
    with mg_tol one B6 a stop test (V-cycles read from ``cycles``); MR
    and MP 2 a V-cycle and FMG's 5 (every device runs the replicated
    coarse levels)."""
    def want():
        c = {"B1": 2, "B2": 2, "B7a": 1, "B7b": 1, "EM": int(emit)}
        if p_.pressure_solver != "mg":
            c["B4"] = 2 * p_.iterations
        else:
            per = set(cycles.values())
            if len(per) != 1 or len(cycles) != n:
                raise AssertionError(f"phase 19: fine V-cycles per device {dict(cycles)}")
            v = per.pop() - 1  # FMG's own fine V-cycle aside
            tests = 0 if p_.mg_tol is None else v + int(v < p_.iterations)
            c.update(B4=8 * (v + 1), B5=7 + 3 * v, B6=3 + 2 * v + tests, MR=5 + 2 * v,
                     MP=5 + 2 * v)
        return {k: n * x for k, x in c.items()}
    return want


def compare(label, topo, got, want_state, on_host=False):
    """The sharded step's state checked (:func:`check_state`), and every
    field bitwise the one-device step's: the same kernels on the same
    per-voxel arithmetic, the partial restrictions adding exact zeros (max
    abs and rel error printed)."""
    check_state(label, topo, got)
    parts, worst, differ = [], 0.0, []
    for name in ["velocity"] + sorted(want_state.scalars):
        g = got.velocity if name == "velocity" else got.scalars[name]
        w = want_state.velocity if name == "velocity" else want_state.scalars[name]
        if on_host:
            w = w.to(g.device)
        err, rel = rel_err(g, w)
        same = bool(torch.equal(g, w))
        if not same:
            differ.append(name)
        parts.append(f"{name} {err:.2e}/{rel:.2e}{' (bitwise)' if same else ''}")
        del w
    print(f"[{label}] vs the one-device step, max abs/rel err per field: {', '.join(parts)}"
          f" (bitwise required)", flush=True)
    if differ:
        raise AssertionError(f"phase {label}: the sharded step is not bitwise the one-device "
                             f"step in {differ}")


@contextlib.contextmanager
def mg_residuals(ratios: list):
    """max|r| / max|div| of every multigrid solve's answer (each device
    reduces as its stop test does: ``tol_reduce``, ghosts refreshed),
    the residual by B6's plain version, so that no counter moves."""
    real = multigrid.solve_pressure_mg

    def spy(topo_, hier_, div_, cycles_, dx_, *a, **kw):
        p_out = real(topo_, hier_, div_, cycles_, dx_, *a, **kw)
        red = kw.get("tol_reduce") or (lambda f: f.abs().max())
        pr = kw["refresh"](p_out) if kw.get("refresh") is not None else p_out
        r = red(cuda_stencil.residual_plain(topo_.nbr, pr, div_, dx_))
        ratios.append(float(r) / max(float(red(div_)), 1e-30))
        return p_out

    with mock.patch.object(multigrid, "solve_pressure_mg", spy):
        yield


def phase_19_sharded(card: Card) -> None:
    """The sharded step (``parallel/``) over SLABS entries of this card: the
    bench's slabs and boxes, a CHAIN_STEPS multigrid chain and config 5, each
    bitwise the one-device step and within TOL_STEP on the plain versions,
    launches exact, timed; over distinct cards where there are two."""
    bench = CELLS["bench"]
    params, cfg = bench.params, bench.plume
    c5_rb, cfg5 = CELLS["c5"].params, CELLS["c5"].plume
    torch.cuda.empty_cache()
    t19, s19 = plume.run_plume(bench.develop, params, cfg, topo=bench.topology(DEV),
                               grow_every=0)
    mesh = make_mesh(SLABS, device=DEV)
    print(f"[19] mesh: {SLABS} entries of {mesh.devices[0]} ({torch.cuda.get_device_name(0)}); "
          f"one thread a device, one stream", flush=True)
    slab19 = pslab.build_slabs(t19, SLABS)
    box19 = pboxes.build_boxes(t19, (2, 2, 1))
    for name, dec in (("slabs", slab19), ("boxes (2,2,1)", box19)):
        owned = dec.local_mask.sum(1).tolist()
        print(f"[19] {name}: capacity {dec.capacity} a device ({SLABS * dec.capacity} rows "
              f"against {t19.capacity}), owned tiles {[int(o) for o in owned]}, rows in use "
              f"{dec.n_rows.tolist()}", flush=True)
    mg19 = CELLS["bench-mg"].params
    runs = (("RBGS-50", slab19, params), ("MG", slab19, mg19),
            ("MG mg_tol", slab19, mg19.replace(mg_tol=MG_TOL, iterations=MG_TOL_CAP)),
            ("boxes RBGS-50", box19, params))
    for name, dec, p_ in runs:
        label = f"19 {name}"
        hier19 = multigrid.hierarchy_for(t19, p_)
        shier = pslab.build_slab_hierarchy(t19, dec, p_.mg_levels) if hier19 else None
        emitted = plume.emit(t19, s19, cfg, p_.dt)

        def one_device():
            return solver.step_impl(t19, emitted, p_, hier19, refresh=textbook)

        one_cycles, shard_cycles = collections.Counter(), collections.Counter()
        with fine_cycles(one_cycles), main_path(card, f"{label} one device",
                                                sharded_counts(p_, 1, one_cycles, False)):
            want = one_device()
        blocks = pslab.scatter_state(t19, dec, s19, mesh)
        fn = pslab.sharded_plume_step(mesh, dec, p_, cfg, hierarchy=shier)
        with fine_cycles(shard_cycles), main_path(card, label,
                                                  sharded_counts(p_, SLABS, shard_cycles)):
            out = pslab.gather_state(t19, dec, fn(dec, blocks))
        if p_.mg_tol is not None:
            print(f"[{label}] V-cycles after FMG: {set(shard_cycles.values()).pop() - 1} on each "
                  f"slab, {one_cycles[threading.current_thread().name] - 1} on one device (cap "
                  f"{MG_TOL_CAP}, tol {MG_TOL:g})", flush=True)
            if set(shard_cycles.values()) != set(one_cycles.values()):
                raise AssertionError(f"phase {label}: the slabs stopped on another cycle")
        compare(label, t19, out, want)
        step_vs_plain(card, label, lambda: pslab.gather_state(t19, dec, fn(dec, blocks)), out)
        ms_shard = statistics.median(time_ms(lambda: fn(dec, blocks), 3))
        ms_one = statistics.median(time_ms(one_device, 3))
        print(f"[{label}] step ms (median of 3, CUDA events): {SLABS} devices on one card "
              f"{ms_shard:.3f}, one device (the same dispatch) {ms_one:.3f} | {card}", flush=True)
        if name == "RBGS-50":  # the host's cost of each slab's thread
            sweep = {}
            for n_ in SLAB_SWEEP:
                mesh_n, dec_n = make_mesh(n_, device=DEV), pslab.build_slabs(t19, n_)
                fn_n = pslab.sharded_plume_step(mesh_n, dec_n, p_, cfg)
                blocks_n = pslab.scatter_state(t19, dec_n, s19, mesh_n)
                sweep[n_] = statistics.median(time_ms(lambda: fn_n(dec_n, blocks_n), 3))
            del mesh_n, dec_n, fn_n, blocks_n
            print(f"[{label}] step ms (median of 3, CUDA events) by the number of slabs on "
                  f"one card: {sweep} | {card}", flush=True)
        del blocks, fn, out, want, emitted

    # the sharded convergence chain: CHAIN_STEPS consecutive MG + FMG +
    # mg_tol steps over the slabs beside the one-device chain
    p_ = mg19.replace(mg_tol=MG_TOL, iterations=MG_TOL_CAP)
    hier19 = multigrid.hierarchy_for(t19, p_)
    fn = pslab.sharded_plume_step(mesh, slab19, p_, cfg,
                                  hierarchy=pslab.build_slab_hierarchy(t19, slab19, p_.mg_levels))
    blocks = pslab.scatter_state(t19, slab19, s19, mesh)
    s_one = s19
    for k_ in range(1, CHAIN_STEPS + 1):
        label = f"19 chain {k_}"
        r_one, r_shard = [], []
        one_cycles, shard_cycles = collections.Counter(), collections.Counter()
        emitted = plume.emit(t19, s_one, cfg, p_.dt)
        with mg_residuals(r_one), fine_cycles(one_cycles), main_path(
                card, f"{label} one device", sharded_counts(p_, 1, one_cycles, False)):
            s_one = solver.step_impl(t19, emitted, p_, hier19, refresh=textbook)
        with mg_residuals(r_shard), fine_cycles(shard_cycles), main_path(
                card, label, sharded_counts(p_, SLABS, shard_cycles)):
            blocks = fn(slab19, blocks)
        out = pslab.gather_state(t19, slab19, blocks)
        v_one = set(one_cycles.values()).pop() - 1
        v_shard = set(shard_cycles.values())
        print(f"[{label}] V-cycles after FMG: {sorted(c - 1 for c in v_shard)} on the "
              f"{SLABS} slabs, {v_one} on one device (cap {MG_TOL_CAP}, tol {MG_TOL:g}); "
              f"max|r|/max|div| {max(r_shard):.3e} sharded (every slab's {len(r_shard)} "
              f"answers), {r_one[0]:.3e} one device (bound {C5_RMAX_OVER_DIV0})", flush=True)
        if v_shard != {v_one + 1}:
            raise AssertionError(f"phase {label}: the slabs ran {v_shard} fine V-cycles, one "
                                 f"device {v_one + 1}")
        if not max(r_shard + r_one) <= C5_RMAX_OVER_DIV0:
            raise AssertionError(f"phase {label}: max|r|/max|div| {max(r_shard + r_one)} > "
                                 f"{C5_RMAX_OVER_DIV0}")
        compare(label, t19, out, s_one)
    del blocks, fn, out, s_one, emitted

    # config 5 over 4 slabs on one card, RBGS-50
    torch.cuda.empty_cache()
    c5t = CELLS["c5"].topology(DEV)
    c5t, st5 = plume.run_plume(CELLS["c5"].develop, c5_rb, cfg5, topo=c5t, grow_every=0)
    emitted = plume.emit(c5t, st5, cfg5, c5_rb.dt)
    with main_path(card, "19 c5 one device",
                   sharded_counts(c5_rb, 1, collections.Counter(), False)):
        a_ = torch.cuda.Event(enable_timing=True)
        b_ = torch.cuda.Event(enable_timing=True)
        a_.record()
        want = solver.step_impl(c5t, emitted, c5_rb, (), refresh=textbook)
        b_.record()
    ms_one = a_.elapsed_time(b_)
    want = FieldState(velocity=want.velocity.cpu(),
                      scalars={k: v.cpu() for k, v in want.scalars.items()})
    del emitted
    slab5 = pslab.build_slabs(c5t, SLABS)
    rows = SLABS * slab5.capacity / c5t.capacity
    print(f"[19] config 5: {c5t.n_active} tiles, capacity {c5t.capacity}; {SLABS} slabs of "
          f"capacity {slab5.capacity} ({rows:.3f}x the rows), owned tiles "
          f"{[int(o) for o in slab5.local_mask.sum(1).tolist()]}; reckoned peak "
          f"{C5_STEP_PEAK_GIB} GiB x {rows:.3f} = {C5_STEP_PEAK_GIB * rows:.2f} GiB", flush=True)
    blocks = pslab.scatter_state(c5t, slab5, st5, mesh)
    del st5
    fn = pslab.sharded_plume_step(mesh, slab5, c5_rb, cfg5)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with main_path(card, "19 c5", sharded_counts(c5_rb, SLABS, collections.Counter())):
        a_.record()
        out_blocks = fn(slab5, blocks)
        b_.record()
    ms_shard = a_.elapsed_time(b_)
    peak = torch.cuda.max_memory_allocated()
    out = pslab.gather_state(c5t, slab5, out_blocks)
    del out_blocks
    compare("19 c5", c5t, out, want, on_host=True)
    del want
    t0_ = time.perf_counter()
    step_vs_plain(card, "19 c5", lambda: pslab.gather_state(c5t, slab5, fn(slab5, blocks)), out)
    print(f"[19 c5] the plain step over {SLABS} slabs took {time.perf_counter() - t0_:.1f} s",
          flush=True)
    # B4 at the slab shape (its operands far past the L2), a launch at a
    # time behind the spin, beside its HBM bound
    for key, a, kw, out_bytes, count in record(card, lambda: fn(slab5, blocks), ["B4"]):
        vs_plain(card, "19 c5", key, a, kw)
        k_ms = median_ms(lambda: card.kernels[key]["kernel_fn"](*a, **kw), 10, 1)
        b_ms, by, moved = bound_ms(key, a, kw, out_bytes)
        print(f"[19 c5] B4 at the slab shape, colour {a[3]}, T={a[0].shape[0]} x{count} a step "
              f"(every slab): {k_ms:.4f} ms a launch (median of 10, one launch a span), bound "
              f"{b_ms:.4f} ms ({by}, {moved / 1e6:.1f} MB), {b_ms / k_ms:.1%} of the bound | "
              f"{card}", flush=True)
    del blocks
    print(f"[19] config 5 RBGS-50 step over {SLABS} slabs on one card: {ms_shard:.1f} ms, the "
          f"one-device step (the same dispatch) {ms_one:.1f} ms (one step each, CUDA events); "
          f"peak device memory {peak / 2**30:.2f} GiB against the reckoned "
          f"{C5_STEP_PEAK_GIB * rows:.2f} (the one-device step's {C5_STEP_PEAK_GIB} x "
          f"{rows:.3f}) | {card}", flush=True)
    del out, fn, c5t
    torch.cuda.empty_cache()

    # distinct cards
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        meshc = make_mesh(min(SLABS, n_cards))
        dc = pslab.build_slabs(t19, meshc.size)
        emitted = plume.emit(t19, s19, cfg, params.dt)
        want = solver.step_impl(t19, emitted, params, (), refresh=textbook)
        blocks = pslab.scatter_state(t19, dc, s19, meshc)
        fn = pslab.sharded_plume_step(meshc, dc, params, cfg)
        with main_path(card, "19 cards", sharded_counts(params, meshc.size,
                                                         collections.Counter())):
            out = pslab.gather_state(t19, dc, fn(dc, blocks))
        compare("19 cards", t19, out, want)
        step_vs_plain(card, "19 cards", lambda: pslab.gather_state(t19, dc, fn(dc, blocks)), out)

        def on_all_cards():
            for d in meshc.devices:
                torch.cuda.synchronize(d)
            t0_ = time.perf_counter()
            fn(dc, blocks)
            for d in meshc.devices:
                torch.cuda.synchronize(d)
            return (time.perf_counter() - t0_) * 1e3

        ms_cards = statistics.median(on_all_cards() for _ in range(3))
        print(f"[19] bench RBGS-50 over {meshc.size} cards {[str(d) for d in meshc.devices]}: "
              f"{ms_cards:.3f} ms a step (median of 3, host clock, every card synchronised)"
              f" | {card}", flush=True)
    else:
        print(f"[19] the run over distinct cards was not made: torch.cuda.device_count() is "
              f"{n_cards}", flush=True)
    card.done("19")


def dense_diffs(got, ref):
    """Max abs and rel error of each field of ``got`` against ``ref``,
    both (velocity, scalars) on the dense box."""
    pairs = [("velocity", got[0], ref[0])] + [(k, got[1][k], ref[1][k])
                                              for k in sorted(ref[1])]
    return {k: rel_err(g.to(w.dtype), w) for k, g, w in pairs}


def show_diffs(res):
    """:func:`dense_diffs`'s errors, one "name abs/rel" a field."""
    return ", ".join(f"{k} {e:.2e}/{r:.2e}" for k, (e, r) in res.items())


def finite_fields(label, fields: dict):
    """Raise where a field of ``fields`` (numpy arrays) is not finite."""
    bad = [k for k, v in fields.items() if not np.isfinite(np.asarray(v)).all()]
    if bad:
        raise AssertionError(f"phase {label}: non-finite values in {bad}")


def phase_20_dense(card: Card) -> None:
    """The dense oracle: one sparse step on each of DENSE_BOXES against
    ``step_dense`` in float64 (TOL_DENSE_ABS, TOL_DENSE_REL), kernels and
    plain versions alike; then the three user examples as main paths."""
    params = CELLS["bench"].params
    comb3 = fire.default_params().combustion  # config 3: confinement at s >= 1
    vort = CombustionParams(vorticity_scale=comb3.vorticity_scale,
                            factor_scale=comb3.factor_scale)
    param_sets = (("test", SolverParams(dt=0.2, iterations=6, halo_lag=1)),
                  ("bench", SolverParams(dt=params.dt, voxel_size=params.voxel_size,
                                         iterations=params.iterations, halo_lag=1)))
    failed = []  # every case runs and prints; the phase fails after the last
    for n in DENSE_BOXES:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        shape = (n, n, n)
        t20 = build_topology_dense(shape, device=DEV)
        print(f"[20] {n}^3 box: {t20.n_active} tiles, capacity {t20.capacity} (textbook B4 "
              f"solve above MAX_FUSED_ROWS {cuda_pressure.MAX_FUSED_ROWS})", flush=True)
        for seed in DENSE_SEEDS:
            vel_np, rho_np = spread.smooth_box(n, seed)
            vel_d0 = torch.from_numpy(vel_np).to(DEV)
            scal_d = spread.dense_scalars(torch.from_numpy(rho_np).to(DEV))
            del vel_np, rho_np
            # the first seed runs every case; the others the vorticity case
            # at the test parameters, where the confinement's conditioning
            # decides the margin
            cases = [(pname, base, vname, comb_)
                     for pname, base in param_sets
                     for vname, comb_ in (("", base.combustion),
                                          (f", vorticity s={int(comb3.factor_scale)}", vort))
                     if seed == DENSE_SEEDS[0] or (pname == "test" and vname)]
            for pname, base, vname, comb_ in cases:
                p20 = base.replace(combustion=comb_)
                label = f"20 {n}^3 seed {seed} {pname}{vname}"
                vel_d = spread.scaled(vel_d0, p20, DENSE_CFL)
                state = spread.to_tiles(t20, vel_d, scal_d)
                vel_t = state.velocity
                sdt_ = p20.dt * p20.inv_voxel_size
                cfl = float((vel_t.abs() * sdt_).max())
                clamped_in = int(advection.cfl_clamped_count(t20, vel_t, p20.dt,
                                                             p20.inv_voxel_size))
                with main_path(card, label, {"B1": 2, "B2": 2, "B4": 2 * p20.iterations, "B7a": 1,
                                             "B7b": 1, "VC": confines(p20)}):
                    out = solver.step(t20, state, p20)
                clamped_out = int(advection.cfl_clamped_count(t20, out.velocity, p20.dt,
                                                              p20.inv_voxel_size))
                print(f"[{label}] max CFL {cfl:.3f} in, cfl_clamped_count {clamped_in} in, "
                      f"{clamped_out} on the projected velocity (the scalar pass's)",
                      flush=True)
                if clamped_in or clamped_out:
                    raise AssertionError(f"phase {label}: a trace clamp can engage")
                check_state(label, t20, out)
                # the kernels at this path's shapes against their plain
                # versions: the whole step, then each distinct call
                out_p = step_vs_plain(card, label, lambda: solver.step(t20, state, p20), out)
                for key, a, kw, _, _ in record(card, lambda: solver.step(t20, state, p20),
                                               ("B1", "B2", "B4", "B7a", "B7b", "VC")):
                    vs_plain(card, label, key, a, kw)
                # the oracle in float64: its own f32 rounding grows with the
                # box (absolute trace positions, an ulp of 2^-24 * n) and the
                # confinement's normalisation amplifies it past the gate
                vel64 = vel_d.double()
                scal64 = {k: v.double() for k, v in scal_d.items()}
                ref64 = step_dense(vel64, scal64, p20)
                ref32 = step_dense(vel_d, scal_d, p20)
                torch.cuda.synchronize()

                got = spread.to_dense(t20, out, shape)
                res = dense_diffs(got, ref64)
                res_p = dense_diffs(spread.to_dense(t20, out_p, shape), ref64)
                gate = ("abs", TOL_DENSE_ABS) if pname == "test" else ("rel", TOL_DENSE_REL)
                worst = max(e if gate[0] == "abs" else r for e, r in res.values())
                worst_p = max(e if gate[0] == "abs" else r for e, r in res_p.values())
                print(f"[{label}] vs step_dense in float64, max abs/rel err per field: "
                      f"{show_diffs(res)}; the plain versions' step {show_diffs(res_p)} (gate: "
                      f"{gate[0]} err <= {gate[1]:g}, both) | {card}", flush=True)
                print(f"[{label}] printed, not gated: vs step_dense in float32 "
                      f"{show_diffs(dense_diffs(got, ref32))}; step_dense float32 vs float64 "
                      f"{show_diffs(dense_diffs(ref32, ref64))} | {card}", flush=True)
                for who, w_ in (("kernels", worst), ("plain", worst_p)):
                    if not w_ <= gate[1]:
                        failed.append(f"{label} ({who}): {gate[0]} err {w_} > {gate[1]}")
                if seed == DENSE_SEEDS[0]:
                    # printed, not gated: the bench default halo_lag 5 (B3 blocks)
                    out5 = solver.step(t20, state, p20.replace(halo_lag=None))
                    print(f"[{label}] halo_lag {p20.replace(halo_lag=None).effective_halo_lag} "
                          f"(B3 blocks, another iteration) vs step_dense in float64, max abs/rel "
                          f"err per field: "
                          f"{show_diffs(dense_diffs(spread.to_dense(t20, out5, shape), ref64))} | "
                          f"{card}", flush=True)
                    ms_sparse = statistics.median(time_ms(lambda: solver.step(t20, state, p20),
                                                          3))
                    ms_dense = statistics.median(time_ms(lambda: step_dense(vel_d, scal_d, p20),
                                                         3))
                    ms_dense64 = statistics.median(time_ms(
                        lambda: step_dense(vel64, scal64, p20), 3))
                    print(f"[{label}] ms a step (median of 3, CUDA events): sparse "
                          f"{ms_sparse:.3f}, step_dense {ms_dense:.3f} (float32), "
                          f"{ms_dense64:.3f} (float64) | {card}", flush=True)
                    del out5
                del out, out_p, got, ref32, ref64, state, vel_t, vel_d, vel64, scal64
            del vel_d0, scal_d
        print(f"[20] {n}^3 peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
              f"GiB | {card}", flush=True)
        del t20
    if failed:
        raise AssertionError("phase 20: " + "; ".join(failed))

    # the user examples on the card at their default widths, a few frames
    # each, as main paths (launches from the capacity each step ran at)
    ex_dir = OUT / "examples"
    shutil.rmtree(ex_dir, ignore_errors=True)

    # fireball: 12 frames, its first checkpoint and render
    d_ex = ex_dir / "fireball"
    stepped(card, "20 fireball", fire, fire.default_params(),
            lambda: fireball.main(["--frames", "12", "--out", str(d_ex)]))
    t_, s_, _, _ = load_npz(str(d_ex / "fire_0012.npz"), device=DEV)
    check_state("20 fireball", t_, s_)
    img = png_pixels(d_ex / "fire_0012.png")
    if img.shape != (128, 128, 3) or not np.array_equal(
            img, as_png(render.render_state(t_, s_, (128, 128, 128)).transpose(1, 0, 2)[::-1])):
        raise AssertionError("phase 20: fire_0012.png is not the render of its checkpoint")
    print(f"[20 fireball] fire_0012.npz: {t_.n_active} tiles, max temperature "
          f"{float(s_.scalars['temperature'].max()):.3f}, max flame "
          f"{float(s_.scalars['flame'].max()):.4f}; fire_0012.png its render", flush=True)

    # smoke_to_nvdb: 8 frames, one export (velocity, density, temperature)
    d_ex = ex_dir / "smoke_to_nvdb"
    stepped(card, "20 smoke_to_nvdb", plume, SolverParams(dt=1 / 24, voxel_size=0.5, iterations=24),
            lambda: smoke_to_nvdb.main(["--frames", "8", "--out", str(d_ex)]))
    grids = {g[0]: g for g in (read_nvdb(str(f)) for f in sorted(d_ex.glob("*.nvdb")))}
    if sorted(grids) != ["density", "temperature", "velocity"]:
        raise AssertionError(f"phase 20: smoke_to_nvdb wrote {sorted(grids)}")
    finite_fields("20 smoke_to_nvdb", {k: g[3] for k, g in grids.items()})
    max_rho = float(np.max(grids["density"][3]))
    if not (max_rho > 0 and png_pixels(d_ex / "preview_0008.png").shape == (128, 128, 3)):
        raise AssertionError("phase 20: smoke_to_nvdb exported no density or no preview")
    print(f"[20 smoke_to_nvdb] grids {sorted(grids)} of {len(grids['density'][2])} leaves, "
          f"max density {max_rho:.4f}; preview_0008.png", flush=True)

    # view_and_export: 2 frames, two .vdb files, then its viewer on port 0,
    # read over HTTP and shut down
    d_ex = ex_dir / "view_and_export"
    servers, errors = [], []

    class Recorded(webapp.ThreadingHTTPServer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            servers.append(self)

    def run_view():
        try:
            view_and_export.main(["--frames", "2", "--port", "0", "--out", str(d_ex)])
        except BaseException as e:  # re-raised below, in the script's thread
            errors.append(e)

    ex_thread = threading.Thread(target=run_view, daemon=True)

    def start_view():
        """The example's thread, until its viewer listens (its frames are
        done by then) or it ends."""
        ex_thread.start()
        deadline = time.monotonic() + 300
        while not servers and ex_thread.is_alive() and time.monotonic() < deadline:
            time.sleep(0.05)

    with mock.patch.object(webapp, "ThreadingHTTPServer", Recorded):
        stepped(card, "20 view_and_export", plume, SolverParams(iterations=20), start_view)
    if errors or not servers:
        raise AssertionError(f"phase 20: view_and_export never served: {errors}")
    try:
        base = f"http://127.0.0.1:{servers[0].server_address[1]}"
        meta = json.loads(get(base, "/meta"))
        if get(base, "/") != webapp.PAGE.encode() or max(get(base, "/volume?field=density")) != 255:
            raise AssertionError("phase 20: view_and_export's viewer served a wrong page or volume")
    finally:
        servers[0].shutdown()
        servers[0].server_close()
    ex_thread.join(timeout=60)
    if ex_thread.is_alive() or errors:
        raise AssertionError(f"phase 20: view_and_export did not end: {errors}")
    plain_vdb, zip_vdb = (vdb_io.read_vdb(str(d_ex / f)) for f in ("final.vdb", "final_zip.vdb"))
    finite_fields("20 view_and_export", {g["name"]: g["values"] for g in plain_vdb})
    if [(g["name"], g["origins"].tobytes(), g["values"].tobytes()) for g in plain_vdb] != [
            (g["name"], g["origins"].tobytes(), g["values"].tobytes()) for g in zip_vdb]:
        raise AssertionError("phase 20: final_zip.vdb does not hold final.vdb's grids")
    print(f"[20 view_and_export] final.vdb and final_zip.vdb: grids "
          f"{[g['name'] for g in plain_vdb]}, the same values; viewer on port "
          f"{servers[0].server_address[1]}: /, /meta (dims "
          f"{meta['fields']['density']['dims']}), /volume, then shut down", flush=True)
    card.done("20")


def phase_21_repeat(card: Card) -> None:
    """``tools/repeat_check``: its stages twice and its first offset magnitude
    NARROW_REPEATS times, every repeat bitwise the first."""
    t21, s21, p21 = repeat_check.inputs(REPEAT_N, SEED, DEV)
    passes = []
    for i in (1, 2):
        with main_path(card, f"21 {REPEAT_N}^3 stages, pass {i}",
                       {"B1": 1, "B2": 1, "B4": 2 * p21.iterations, "B7a": 1,
                        "VC": confines(p21)}):
            passes.append(repeat_check.stages(t21, s21, p21))
    diffs = repeat_check.differing(*passes, threads=1)
    for name in passes[0]:
        print(f"[21] {name}: pass 2 bitwise pass 1 {name not in diffs}"
              + (f" ({diffs[name]['count']} values differ, max {diffs[name]['max']:.3e})"
                 if name in diffs else ""), flush=True)
    res = repeat_check.narrow(t21, passes[0]["advect"], 0.5 * p21.inv_voxel_size, NARROW_REPEATS,
                              say=lambda line: print(f"[21] {line}", flush=True))
    print(f"[21] first offset magnitude, {NARROW_REPEATS} repeats on one velocity: differing "
          f"{res['differing']}, stored outputs changed {res['stored_changed']}", flush=True)
    if diffs or res["differing"] or res["stored_changed"]:
        raise AssertionError(f"phase 21: stages {sorted(diffs)}, repeats {res['differing']}, "
                             f"stored {res['stored_changed']} do not repeat bitwise")
    card.done("21")


def steps_from(topo, state: FieldState, params, cfg, k: int) -> FieldState:
    """``k`` dependent plume steps from ``state``, eagerly."""
    for _ in range(k):
        state = plume.plume_step(topo, state, params, cfg)
    return state


def clone_state(state: FieldState) -> FieldState:
    """A copy of every field of ``state``."""
    return FieldState(velocity=state.velocity.clone(),
                      scalars={k: v.clone() for k, v in state.scalars.items()})


def make_chain(card, topo, params, cfg, state: FieldState, k: int) -> tuple:
    """``k`` plume steps from ``state`` in one ``torch.cuda.CUDAGraph``: the
    state copied into static inputs, an eager warm-up on a side stream, then
    the capture, which raises where it fails (a read back to the host).
    Returns (replay, the launches counted across the capture alone);
    ``replay()`` returns the outputs, which the next replay overwrites."""
    static = clone_state(state)
    side = torch.cuda.Stream(device=static.velocity.device)
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        steps_from(topo, static, params, cfg, k)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = card.counts()
    with torch.cuda.graph(graph):
        out = steps_from(topo, static, params, cfg, k)
    across = {key: n - before[key] for key, n in card.counts().items()}

    def replay(reads=(topo, static)):  # held: the graph reads their memory
        graph.replay()
        return out

    return replay, across


def differing(a, b) -> dict:
    """Field -> max abs difference, for the fields of two states that are
    not bitwise equal."""
    pairs = [("velocity", a.velocity, b.velocity)] + [
        (n_, a.scalars[n_], b.scalars[n_]) for n_ in sorted(a.scalars)]
    return {n_: float((x - y).abs().max()) for n_, x, y in pairs if not torch.equal(x, y)}


def phase_22_graph(card: Card) -> None:
    """The bench step as one CUDA graph: the CHAINS-step chains captured
    (:func:`make_chain`) with exact launches, each replay bitwise the eager
    chain and the replay before, the replay's kernels by name; a capture
    through a host read (the table sampler's window check) must raise."""
    bench = CELLS["bench"]
    p22, cfg22 = bench.params, bench.plume
    topo22 = bench.topology(DEV)
    s22 = steps_from(topo22, zeros_state(topo22), p22, cfg22, GRAPH_DEVELOP)
    check_state("22", topo22, s22)
    chains = {}
    for k_ in CHAINS:
        with main_path(card, f"22 make_chain k={k_}: warm-up and capture", RBGS50_STEP, 2 * k_):
            chains[k_], across = make_chain(card, topo22, p22, cfg22, s22, k_)
        want = {key: RBGS50_STEP.get(key, 0) * k_ for key in KEYS}
        print(f"[22] capture of the {k_}-chain: launches {across} (expected {want})", flush=True)
        if across != want:
            raise AssertionError(f"phase 22: capture of the {k_}-chain launched {across}, "
                                 f"expected {want}")
    for k_, chain in chains.items():
        before = card.counts()
        first = clone_state(chain())
        second = clone_state(chain())
        torch.cuda.synchronize()
        moved = {key: n_ - before[key] for key, n_ in card.counts().items() if n_ != before[key]}
        eager = steps_from(topo22, s22, p22, cfg22, k_)
        check_state("22", topo22, first)
        vs_eager, vs_first = differing(first, eager), differing(second, first)
        print(f"[22] {k_}-chain: replay bitwise the eager chain {not vs_eager}"
              f"{' ' + str(vs_eager) if vs_eager else ''}; second replay bitwise the first "
              f"{not vs_first}{' ' + str(vs_first) if vs_first else ''}; counters moved by "
              f"the replays {moved or 'none'}", flush=True)
        if vs_eager or vs_first or moved:
            raise AssertionError(f"phase 22: {k_}-chain replay vs eager {vs_eager}, second vs "
                                 f"first {vs_first}, counters moved {moved}")
    # the kernels of one replay of the long chain, by name, on the device
    k_ = CHAINS[-1]
    names = {"B1": "bfecc_sample_kernel", "B2": "bfecc_tail_kernel",
             "B3": "rbsor_lagged_kernel", "B7a": "divergence_kernel",
             "B7b": "subtract_gradient_kernel", "EM": "emit_kernel"}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    # a replay in the profiler's warm-up step first: the device records at the
    # head of a session's first replay go missing (the first step's kernels up
    # to its first B3 were lost once the emit was one kernel)
    with torch.profiler.profile(activities=acts, schedule=torch.profiler.schedule(
            wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            chains[k_]()
            torch.cuda.synchronize()
            prof.step()
    seen, n_all, dev_us = collections.Counter(), 0, 0.0
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        n_all += e.count
        dev_us += float(e.self_device_time_total)
        for key, kname in names.items():
            if re.search(rf"\b{kname}\b", e.key):
                seen[key] += e.count
    want = {key: RBGS50_STEP[key] * k_ for key in names}
    print(f"[22] one replay of the {k_}-chain (torch.profiler): kernels by name "
          f"{dict(seen)} (expected {want}); {n_all} device kernels, {n_all / k_:.1f} a step, "
          f"device {dev_us / 1e3 / k_:.4f} ms a step | {card}", flush=True)
    if dict(seen) != want:
        raise AssertionError(f"phase 22: the replay ran {dict(seen)}, expected {want}")
    del chains, first, second, eager, prof
    torch.cuda.empty_cache()
    # a capture that meets a host read raises, with nothing falling back to
    # eager steps: the table sampler's window check reads max|d| on the host
    planned = topology_mod.ensure_chunk_plans(topo22)
    with mock.patch.object(advection, "INTERP", "vmem"):
        try:
            make_chain(card, planned, p22, cfg22, s22, 1)
        except RuntimeError as e:
            first = e  # the host read's own error, under the capture's end
            while isinstance(first.__context__, RuntimeError):
                first = first.__context__
            print(f"[22] a capture through the table sampler's host read raised "
                  + "; under it ".join(f"{type(x).__name__}: {str(x).strip().splitlines()[0][:120]}"
                                       for x in dict.fromkeys((e, first))), flush=True)
        else:
            raise AssertionError("phase 22: a capture through a host read did not raise")
    card.done("22")


def main() -> int:
    card = phase_1_device()
    if card is None:
        return 1
    phase_2_build(card)
    rng = np.random.default_rng(SEED)  # phases 3, 14 and 15 draw their inputs from it in turn
    c5, c5_hier = phase_3_kernels(card, rng)
    topo, state = phase_4_main_path(card)  # the developed bench state
    phase_5_step_vs_plain(card, topo, state)
    step_ms = phase_6_timing(card, topo, state)
    phase_7_multigrid(card, topo, state, step_ms)
    phase_8_parity(card, topo, state)
    phase_9_config5(card, c5, c5_hier)
    del c5, c5_hier
    t4, st4 = phase_10_collider(card)
    phase_11_rk(card, t4, st4)
    del t4, st4
    phase_12_config2(card)
    phase_13_config3(card)
    planned = phase_14_table_sampler(card, rng, topo, state)
    phase_15_probes(card, rng, topo)
    phase_16_cook(card, topo, state)
    phase_17_viewer(card, topo, state)
    phase_18_sliced_tables(card, topo, state, planned)
    del planned, topo, state  # config 5's chunk plans: room for phases 19-20
    phase_19_sharded(card)
    phase_20_dense(card)
    phase_21_repeat(card)
    phase_22_graph(card)
    print(card)
    print(json.dumps({"kernels": [
        {"name": k["name"], "route": k["route"], "source": k["source"],
         "replaces": k["replaces"], "launches": k["launches"],
         "max_abs_err": k["max_abs_err"], "ms": k["ms"], "plain_ms": k["plain_ms"],
         "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
         "library_ms": k["library_ms"]}
        for k in card.kernels.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
