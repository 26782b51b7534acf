#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (hnanosolver_tpu_torch) on one NVIDIA GPU and
check it end to end. Run from the repository root:

    python3 chip_smoke.py

It needs one CUDA card and the CUDA toolkit (nvcc); it builds the
hand-written kernels from ``hnanosolver_tpu_torch/csrc`` on first use. It
runs in phases, one line per check, and any failing check raises (non-zero
exit). Each phase prints the seconds it took.

  1. device: nvidia-smi's card name and power limit, torch and CUDA versions
  2. build the kernels, print the seconds it took
  3. each kernel against its plain PyTorch version on the card, inputs from
     a seed: at the bench shapes (4196-tile plume at capacity 4608) B1 in
     velocity and scalar mode with displacements past the clamp, without
     and with a collision SDF (the config-4 sphere; the share of traces it
     rejects is printed and must be > 0), B2 for F = 3 and F = 5 (bitwise),
     B3 as 10 launches of 5 pairs, B4 both colours with and without an
     in-domain mask, B6, B7a, B7b, B8 for n = 1, 3, 8 and 11 fields with
     displacements past the clamp; B5 at T = 2048 with and without a mask
     (24 iterations); on BASELINE config 5 (1024^3, 269,104 tiles) B3 with
     mask at level 2 (6,144 rows), B6, B7a and B7b at the fine level
     (269,312 rows)
  4. the main path: plume_step for 20 steps from rest on the bench domain
     with the bench SolverParams / PlumeConfig, launch counters reset just
     before and read just after (exactly 2 B1, 2 B2, 10 B3, 1 B7a, 1 B7b
     launches per step), every field finite, null and padding rows exactly 0
  5. one more step from the developed state through the kernels and through
     the plain versions on the card, max relative error per field
  6. timing with CUDA events: ms/step (median of single steps), active
     voxel-updates/s; each kernel call of one step against its plain
     version on the same inputs, and its time per step beside the plain
     version's and its bound
  7. the multigrid path on the bench domain (mg_levels 2, 2 V-cycles, FMG):
     MG_STEPS steps from the developed state with exact launch counts, one
     step kernels vs plain, each kernel call of one step vs plain, timings
  8. one bench step in the "parity" precision tier (halo_lag 1: 100 B4
     colour sweeps), kernels vs plain, each B4 call vs plain, B4's time
  9. BASELINE config 5 at full size, steps through the kernels only (no
     plain step at this size): 4 RBGS-50 steps to develop the plume, MG
     steps (mg_levels 5) with exact launch counts, a project-only solve
     with both solvers (MG must reach max|r| <= 0.1 * max|div|), ms/step
     of both, peak device memory; then each kernel call of one MG step
     against its plain version, and the kernels' times
 10. BASELINE config 4, the moving SDF sphere crossing the bench plume:
     run_collider for 20 frames from rest with exact launch counts (2 B1
     with the SDF, 2 B2, 10 B3, 1 B7a, 1 B7b per step); after every frame
     velocity exactly 0 where sdf < 0, every scalar there bitwise equal to
     its value entering the scalar advection (a trace from inside the
     solid is rejected to d = 0, so phiF = phiB = phi(x)), median |u.n|/|u|
     on the shell -0.5 <= sdf < 0.05 below 0.35, the SDF preserved on
     active rows; the collider moved; then one step kernels vs plain, each
     kernel call of one step vs plain, ms/step
 11. RK2-4 backtraces on the developed config-4 state: the ops-level
     advect_velocity and advect_scalars_fused at trace_order 2, 3, 4,
     without and with the SDF, exactly order - 1 + 2 B8 launches per call
     (+2 with the SDF) and 1 B2; each call kernels vs plain, each recorded
     kernel call vs plain, times
 12. BASELINE config 2: run_plume with the JAX package's defaults
     (PlumeConfig(), SolverParams(), growth every frame) for C2_FRAMES
     frames from the emitter's topology, launch counts per frame from the
     capacity the step ran at (B5 at T <= 2048, else B3 blocks); each
     frame's tile count, capacity and seconds, fields finite, null and
     padding rows 0, and every remap keeping each kept tile's values
     exactly; then one step kernels vs plain
 13. BASELINE config 3: run_fire with FireConfig() and default_params()
     (vorticity confinement at s = 1) for C3_FRAMES frames, the same
     per-frame checks, then tests/test_fire.py's: max flame > 0.3, waste
     > 0, max temperature > 85, hot gas (T > 50) above y = 10; one step
     kernels vs plain
 14. the table sampler (advection.INTERP = "vmem") on the bench cell's
     developed state, the velocity scaled into each band (narrow, mixed,
     wide), COMBINE_TBL off and on: build_topology's host seconds with and
     without the chunk plans (bench and config 5); B11 vs its plain version
     and bitwise vs build_table_dual; the dual B1 ("both" with and without
     the SDF, "back", "fwd") vs its plain version and bitwise vs the nbr B1
     and B8; one step per band and switch as a main path (launches from the
     branches taken) vs its plain step and vs the nbr-path step; times of
     B11, the dual B1, the table builds and the table-path pass beside the
     nbr B1 pass

Launch counts come only from the main-path runs (phases 4, 7-14), each
with the counters set to 0 just before and read just after; launches made
to compare or time a kernel are not counted. A kernel's times in the JSON
line are per step of the path it serves (B1-B3, B7a, B7b the bench RBGS
step, B4 the parity step, B5-B6 the bench MG step, B8 one RK4 advection
with the SDF of the config-4 state: the velocity and the scalar pass; B1d
and B11 one table-path bench step in the narrow band with COMBINE_TBL on):
per-launch medians over runs of 10
back-to-back calls at the inputs recorded from one such step, times that
step's launches. ``bound_ms`` is the larger of the bytes the calls must
move (each input read once, each output written once; B11 reads each
distinct table value it copies once) over 3.35 TB/s and
their f32 operations over 67 TFLOP/s (the H100 SXM data sheet). On the
bench domain a launch's operands fit the 50 MB L2 and stay there between
back-to-back calls, as they largely do in the step, so its HBM bound is
not a floor on its time; the per-launch lines say where that holds. Only
the config-5 levels (551 MB a field at the fine one) and the bench's chunk
tables (133-353 MB a launch) are held to a true HBM bound.

The cells (domains, solver settings, develop steps) come from
``hnanosolver_tpu_torch/cells.py``, which ``profile_step`` reads too.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np

MG_STEPS = 3  # multigrid steps on the bench domain
C2_FRAMES = 48  # config-2 plume frames from rest (growth every frame)
C3_FRAMES = 48  # config-3 fire frames from rest
BANDS = (("narrow", 1.5), ("mixed", 3.0), ("wide", 5.0))  # phase 14: CFL per band
C5_MG_STEPS = 2  # counted multigrid steps at config 5
SEED = 0
# Tolerances, kernel vs its plain version on the card. The kernels use
# round-to-nearest intrinsics in the plain version's op order, so bitwise
# agreement is the expected outcome; the allowances below cover ulp-level
# drift (e.g. a different floor/convert path) and its amplification:
# B1's forward sample sits at a re-traced position whose ulp error is
# multiplied by the field's gradient.
TOL_B1 = 1e-5  # max abs err / max |ref|
TOL_B3 = 1e-5  # max abs err / max |ref|, 10 launches of 5 pairs (also B4-B6)
TOL_STEP = 1e-4  # per field, one full step from the developed state
C5_RMAX_OVER_DIV0 = 0.1  # SCALE_r05.md's convergence criterion
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, HBM3
F32_OPS_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores
L2_BYTES = 50e6  # H100 SXM L2 cache
C4_SHELL_VDOTN = 0.35  # median |u.n|/|u| on the shell (tests/test_collision.py)
KEYS = ("B1", "B2", "B3", "B4", "B5", "B6", "B7a", "B7b", "B8", "B1d", "B11")


def sh(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps: int, batch: int = 1) -> list[float]:
    """``reps`` samples of the per-call time (ms) of ``fn``, each sample a
    run of ``batch`` back-to-back calls between two CUDA events."""
    import torch

    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / batch)
    return out


def paired_ms(kernel, plain, reps: int = 5, batch: int = 10) -> tuple[float, float]:
    """Median per-call ms of kernel and plain over runs of ``batch`` calls,
    measured in turns (plain, kernel, kernel, plain) after a warm-up."""
    kernel(), plain()
    p = cuda_ms(plain, reps, batch)
    k = cuda_ms(kernel, reps, batch) + cuda_ms(kernel, reps, batch)
    p += cuda_ms(plain, reps, batch)
    return statistics.median(k), statistics.median(p)


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
        nb, f_lo = args[4], args[5]
        mode = args[6] if len(args) > 6 else kwargs.get("mode", "both")
        sdf = args[7] if len(args) > 7 else kwargs.get("has_sdf", False)
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
    return 9.0  # B6


def call_label(key: str, args: tuple) -> str:
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


def bound_ms(key: str, args: tuple, kwargs: dict, out) -> tuple[float, str, int]:
    """The least time the card could take for one launch: (ms, bound by,
    bytes moved). Each input is read once and each output written once;
    B11's reads are the table values its dloc picks (the data decides
    them): :func:`b11_read_bytes`."""
    import torch

    seen, moved = set(), 0
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, torch.Tensor) and a.data_ptr() not in seen:
            seen.add(a.data_ptr())
            moved += nbytes(a)
    if key == "B11":  # it reads each distinct 27-table value it copies once
        moved = nbytes(args[1]) + b11_read_bytes(args[1], args[2])
    moved += nbytes(out)
    ops = ops_per_voxel(key, args, kwargs) * rows(key, args) * 512
    t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes", moved) if t_bytes >= t_ops else (t_ops, "operations", moved)


def main() -> int:
    import torch

    # -- 1. device -----------------------------------------------------------
    t_phase = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    card = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    card = card.splitlines()[0]
    print(f"[1] device: {card} | torch {torch.__version__} | CUDA {torch.version.cuda}"
          f" | {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}", flush=True)

    from hnanosolver_tpu_torch import solver
    from hnanosolver_tpu_torch.cells import CELLS
    from hnanosolver_tpu_torch.core.topology import active_mask, build_topology
    from hnanosolver_tpu_torch.fields import COLLISION_FIELD, zeros_state
    from hnanosolver_tpu_torch.kernels import build
    from hnanosolver_tpu_torch.core import topology as topology_mod
    from hnanosolver_tpu_torch.core.layout import positions_flat
    from hnanosolver_tpu_torch.fields import FieldState
    from hnanosolver_tpu_torch.models import collider, fire, plume
    from hnanosolver_tpu_torch.config import SolverParams
    from hnanosolver_tpu_torch.ops import (advection, collision, combustion, cuda_bfecc,
                                           cuda_pressure, cuda_sample, cuda_stencil, cuda_tables,
                                           cuda_tail, multigrid, stencil, tables)
    from hnanosolver_tpu_torch.ops import pressure as prs

    def done(phase: str):
        nonlocal t_phase
        now = time.perf_counter()
        print(f"[{phase}] phase took {now - t_phase:.1f} s", flush=True)
        t_phase = now

    done("1")

    # -- 2. build ------------------------------------------------------------
    info = build.build()
    build.library()
    regs = [ln.strip() for ln in info.log.splitlines() if "registers" in ln]
    print(f"[2] build: {info.seconds:.1f} s -> {info.path.name}"
          f" ({len(regs)} ptxas register reports; one nvcc per source, no -rdc)",
          flush=True)
    for ln in regs:
        print(f"    ptxas: {ln}")
    done("2")

    dev = torch.device("cuda")
    bench = CELLS["bench"]
    topo = bench.topology(dev)
    T = topo.capacity
    params, cfg = bench.params, bench.plume
    sdt = params.dt * params.inv_voxel_size
    lag = params.effective_halo_lag
    omega, dx2 = params.omega, params.voxel_size ** 2
    src = "hnanosolver_tpu_torch/csrc/"
    kernels = {
        "B1": dict(name="bfecc_sample", source=src + "bfecc_sample.cu",
                   replaces="hnanosolver_tpu/ops/pallas_bfecc.py:303",
                   counter=cuda_bfecc.launches, wrap=(cuda_bfecc, "bfecc_sample")),
        "B2": dict(name="bfecc_tail", source=src + "bfecc_tail.cu",
                   replaces="hnanosolver_tpu/ops/pallas_tail.py:85",
                   counter=cuda_tail.launches, wrap=(cuda_tail, "bfecc_tail")),
        "B3": dict(name="rbsor_lagged", source=src + "rbsor_lagged.cu",
                   replaces="hnanosolver_tpu/ops/pallas_pressure.py:199",
                   counter=cuda_pressure.launches_lagged,
                   wrap=(cuda_pressure, "rbsor_lagged")),
        "B4": dict(name="rbsor_color", source=src + "rbsor_color.cu",
                   replaces="hnanosolver_tpu/ops/pallas_pressure.py:290",
                   counter=cuda_pressure.launches_color,
                   wrap=(cuda_pressure, "rbsor_color")),
        "B5": dict(name="rbsor_fused", source=src + "rbsor_fused.cu",
                   replaces="hnanosolver_tpu/ops/pallas_pressure.py:356",
                   counter=cuda_pressure.launches_fused,
                   wrap=(cuda_pressure, "rbsor_fused")),
        "B6": dict(name="residual", source=src + "residual.cu",
                   replaces="hnanosolver_tpu/ops/pallas_stencil.py:184",
                   counter=cuda_stencil.launches_residual, wrap=(cuda_stencil, "residual")),
        "B7a": dict(name="divergence", source=src + "stencil.cu",
                    replaces="hnanosolver_tpu/ops/pallas_stencil.py:89",
                    counter=cuda_stencil.launches_div, wrap=(cuda_stencil, "divergence")),
        "B7b": dict(name="subtract_gradient", source=src + "stencil.cu",
                    replaces="hnanosolver_tpu/ops/pallas_stencil.py:151",
                    counter=cuda_stencil.launches_subgrad,
                    wrap=(cuda_stencil, "subtract_gradient")),
        "B8": dict(name="sample_at", source=src + "sample_at.cu",
                   replaces="hnanosolver_tpu/ops/pallas_interp2.py:54, "
                            "hnanosolver_tpu/ops/pallas_interp.py:51",
                   counter=cuda_sample.launches, wrap=(cuda_sample, "sample_at")),
        "B1d": dict(name="bfecc_sample_dual", source=src + "bfecc_sample.cu",
                    replaces="hnanosolver_tpu/ops/pallas_bfecc.py:303 (use_dual, :899-913, "
                             ":974-984)",
                    counter=cuda_bfecc.launches_dual, wrap=(cuda_bfecc, "bfecc_sample_dual")),
        "B11": dict(name="combine_dual", source=src + "combine_dual.cu",
                    replaces="hnanosolver_tpu/ops/pallas_bfecc.py:676",
                    counter=cuda_tables.launches,
                    wrap=(cuda_tables, "build_table_dual_combine")),
    }
    for k in kernels.values():
        k.update(route="cuda", launches=0, max_abs_err=0.0, library_ms=None)
        mod, attr = k["wrap"]
        k["kernel_fn"], k["plain_fn"] = getattr(mod, attr), getattr(mod, attr + "_plain")

    def check(key, label, got, want, tol=TOL_B3, phase="3"):
        torch.cuda.synchronize()
        err, rel = rel_err(got, want)
        bitwise = bool(torch.equal(got, want))
        kernels[key]["max_abs_err"] = max(kernels[key]["max_abs_err"], err)
        print(f"[{phase}] {key} {label}: max abs err {err:.3e}, rel {rel:.3e} (tol {tol:g}),"
              f" bitwise {bitwise}", flush=True)
        if not rel <= tol:
            raise AssertionError(f"phase {phase}: {key} {label} rel err {rel} > {tol}")

    @contextlib.contextmanager
    def main_path(label: str, per_step, steps: int = 1):
        """Counters to 0 just before the run, read just after; the counts
        must be exactly ``per_step`` times ``steps`` (``per_step`` a
        callable: the run's total counts, asked after the run)."""
        for k in kernels.values():
            k["counter"].n = 0
        torch.cuda.synchronize()
        yield
        torch.cuda.synchronize()
        counts = {key: k["counter"].n for key, k in kernels.items()}
        if callable(per_step):
            per_step, steps = per_step(), 1
        want = {key: per_step.get(key, 0) * steps for key in KEYS}
        for key, k in kernels.items():
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

    def plain_versions():
        """Every kernel wrapper replaced by its plain version."""
        stack = contextlib.ExitStack()
        for k in kernels.values():
            mod, attr = k["wrap"]
            stack.enter_context(mock.patch.object(mod, attr, k["plain_fn"]))
        return stack

    def step_vs_plain(label, run):
        out_k = run()
        before = {key: k["counter"].n for key, k in kernels.items()}
        with plain_versions():
            out_p = run()
        torch.cuda.synchronize()
        if {key: k["counter"].n for key, k in kernels.items()} != before:
            raise AssertionError(f"phase {label}: the plain step launched a kernel")
        worst, parts = 0.0, []
        for name in ["velocity"] + sorted(out_k.scalars):
            g = out_k.velocity if name == "velocity" else out_k.scalars[name]
            w = out_p.velocity if name == "velocity" else out_p.scalars[name]
            _, rel = rel_err(g, w)
            worst = max(worst, rel)
            parts.append(f"{name} {rel:.2e}")
        print(f"[{label}] one step, kernels vs plain on the card, max rel err per field: "
              f"{', '.join(parts)} (tol {TOL_STEP:g})", flush=True)
        if not worst <= TOL_STEP:
            raise AssertionError(f"phase {label}: step rel err {worst} > {TOL_STEP}")

    def sig(key, args, kwargs):
        def one(a):
            return (tuple(a.shape), a.dtype) if isinstance(a, torch.Tensor) else a
        return (key, tuple(one(a) for a in args),
                tuple(sorted((n, one(v)) for n, v in kwargs.items())))

    def record(run, keys) -> list:
        """Run ``run`` once with the wrappers of ``keys`` recording their
        calls: [key, args, kwargs, result, count] per distinct call (the
        first one's inputs are kept)."""
        groups = {}
        with contextlib.ExitStack() as stack:
            for key in keys:
                def rec(*a, _fn=kernels[key]["kernel_fn"], _key=key, **kw):
                    out = _fn(*a, **kw)
                    groups.setdefault(sig(_key, a, kw), [_key, a, kw, out, 0])[4] += 1
                    return out
                stack.enter_context(mock.patch.object(*kernels[key]["wrap"], rec))
            run()
        torch.cuda.synchronize()
        return list(groups.values())

    def vs_plain(label, key, a, kw):
        """One recorded call through the kernel and through its plain
        version, each on its own copy of the inputs (B4 updates p in
        place)."""
        def inputs():
            return [x.clone() if isinstance(x, torch.Tensor) else x for x in a]

        k = kernels[key]
        got, want = k["kernel_fn"](*inputs(), **kw), k["plain_fn"](*inputs(), **kw)
        if not isinstance(got, tuple):
            got, want = (got,), (want,)
        for g, w in zip(got, want):
            check(key, f"main-path call {call_label(key, a)}", g, w,
                  TOL_B1 if key in ("B1", "B8", "B1d") else TOL_B3, label)

    def time_calls(label: str, groups: list, plain: bool = True) -> dict:
        """Each recorded call against its plain version on the same inputs,
        then per-step kernel, plain and bound ms: one timed launch per
        distinct call, times its count. ``plain=False`` times the kernels
        alone."""
        res = {}
        for key, a, kw, out, count in groups:
            k = kernels[key]
            vs_plain(label, key, a, kw)
            if plain:
                k_ms, p_ms = paired_ms(lambda: k["kernel_fn"](*a, **kw),
                                       lambda: k["plain_fn"](*a, **kw))
            else:
                k["kernel_fn"](*a, **kw)
                k_ms = statistics.median(cuda_ms(lambda: k["kernel_fn"](*a, **kw), 5, 10))
                p_ms = float("nan")
            b_ms, by, moved = bound_ms(key, a, kw, out)
            r = res.setdefault(key, dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bound_by={}))
            r["ms"] += k_ms * count
            r["plain_ms"] += p_ms * count
            r["bound_ms"] += b_ms * count
            r["bound_by"][by] = r["bound_by"].get(by, 0.0) + b_ms * count
            in_l2 = " (operands fit the L2: HBM bound)" if moved <= L2_BYTES else ""
            print(f"[{label}] {key} {call_label(key, a)} x{count}/step: {k_ms:.4f} ms kernel,"
                  f" {p_ms:.4f} ms plain, bound {b_ms:.4f} ms ({by}, {moved / 1e6:.1f} MB)"
                  f"{in_l2} per launch | {card}", flush=True)
        for key, r in res.items():
            r["bound_by"] = max(r["bound_by"], key=r["bound_by"].get) if r["bound_by"] else "bytes"
            print(f"[{label}] {key} {kernels[key]['name']}: {r['ms']:.4f} ms/step kernel vs "
                  f"{r['plain_ms']:.4f} plain, bound {r['bound_ms']:.4f} ({r['bound_by']})"
                  f" | {card}", flush=True)
        return res

    # -- 3. kernels vs plain versions ------------------------------------------
    rng = np.random.default_rng(SEED)
    m = active_mask(topo)[:, None]

    def field(*shape, scale=1.0, mask=m):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
        return x * scale * mask

    def in_domain(rows, mask):
        return (torch.from_numpy(rng.random((rows, 512))).to(dev) > 0.3).float() * mask

    vel = field(3, T, 512, scale=40.0)  # |u|*sdt reaches the 7-voxel clamp
    scal = field(5, T, 512)
    clamped = float(((vel * sdt).abs() > cuda_bfecc.DISP_LIMIT).float().mean())
    if clamped <= 0:
        raise AssertionError("phase 3: no displacement reaches the clamp")
    for mode, fields, f_lo in (("velocity", vel, 0),
                               ("scalars", torch.cat([vel, scal]).contiguous(), 3)):
        got = cuda_bfecc.bfecc_sample(topo.nbr, fields, sdt, f_lo)
        want = cuda_bfecc.bfecc_sample_plain(topo.nbr, fields, sdt, f_lo)
        for part, g, w in zip(("phiF", "phiB"), got, want):
            check("B1", f"{mode:8s} {part} ({clamped:.1%} of traces clamped)", g, w, TOL_B1)
    # B1 with the config-4 sphere at frame 0 as the collision SDF (masked,
    # as mask_state leaves it)
    col4 = CELLS["c4"].collider
    sdf3 = collider.sphere_sdf(topo, collider.collider_center(col4, 0, params.dt, dev),
                               col4.radius) * m
    lim = cuda_bfecc.DISP_LIMIT
    d = torch.clamp(-vel * sdt, -lim, lim)
    hit = cuda_sample.sample_at_plain(topo.nbr, sdf3[None], d)[0] < 0
    d = torch.where(hit, 0.0, d)
    d2 = torch.clamp(d + cuda_sample.sample_at_plain(topo.nbr, vel, d) * sdt, -lim, lim)
    hit2 = cuda_sample.sample_at_plain(topo.nbr, sdf3[None], d2)[0] < 0
    share = (float(hit.sum()) / topo.num_voxels, float(hit2.sum()) / topo.num_voxels)
    if not min(share) > 0:
        raise AssertionError(f"phase 3: the SDF rejected no trace at a probe: {share}")
    for mode, fields, f_lo in (("velocity", vel, 0),
                               ("scalars", torch.cat([vel, scal]).contiguous(), 3)):
        got = cuda_bfecc.bfecc_sample(topo.nbr, fields, sdt, f_lo, sdf3)
        want = cuda_bfecc.bfecc_sample_plain(topo.nbr, fields, sdt, f_lo, sdf3)
        for part, g, w in zip(("phiF", "phiB"), got, want):
            check("B1", f"{mode:8s} {part} with SDF ({share[0]:.2%} of back traces, "
                  f"{share[1]:.2%} of re-traces rejected)", g, w, TOL_B1)
    del d, d2, hit, hit2
    for F in (3, 5):
        phi0, pf, pb = field(F, T, 512), field(F, T, 512), field(F, T, 512)
        got = cuda_tail.bfecc_tail(topo.nbr, phi0, pf, pb)
        want = cuda_tail.bfecc_tail_plain(topo.nbr, phi0, pf, pb)
        check("B2", f"F={F}", got, want, 0.0)
    div = field(T, 512)
    p_k = p_p = torch.zeros_like(div)
    for _ in range(params.iterations // lag):
        p_k = cuda_pressure.rbsor_lagged(topo.nbr, p_k, div, lag, omega, dx2)
        p_p = cuda_pressure.rbsor_lagged_plain(topo.nbr, p_p, div, lag, omega, dx2)
    check("B3", f"{params.iterations // lag} launches x {lag} pairs", p_k, p_p)
    mask = in_domain(T, m)
    p0 = field(T, 512)
    for mk in (None, mask):
        for color in (0, 1):
            pk = p0.clone() if mk is None else p0 * mk
            want = cuda_pressure.rbsor_color_plain(topo.nbr, pk, div, color, omega, dx2, mk)
            cuda_pressure.rbsor_color(topo.nbr, pk, div, color, omega, dx2, mk)
            check("B4", f"colour {color}, {'mask' if mk is not None else 'no mask'}", pk, want)
    check("B6", f"bench T={T}", cuda_stencil.residual(topo.nbr, p0, div, 0.5),
          cuda_stencil.residual_plain(topo.nbr, p0, div, 0.5))
    for inv_dx in (params.inv_voxel_size, 1.0 / 0.3):  # an exact and an inexact scale
        check("B7a", f"bench T={T}, inv_dx {inv_dx:.4f}",
              cuda_stencil.divergence(topo.nbr, vel, inv_dx),
              cuda_stencil.divergence_plain(topo.nbr, vel, inv_dx))
        check("B7b", f"bench T={T}, inv_dx {inv_dx:.4f}",
              cuda_stencil.subtract_gradient(topo.nbr, vel, p0, inv_dx),
              cuda_stencil.subtract_gradient_plain(topo.nbr, vel, p0, inv_dx))
    # B8 at displacements past the clamp, n = 11 in two launches (8 + 3)
    dd = torch.from_numpy(rng.uniform(-9.0, 9.0, (3, T, 512)).astype(np.float32)).to(dev)
    dd = torch.clamp(dd, -lim, lim)
    allf = torch.cat([vel, scal, field(3, T, 512)])
    for n in (1, 3, 8, 11):
        fn = allf[:n].contiguous()
        check("B8", f"n={n} fields, {float((dd.abs() >= lim).float().mean()):.1%} of "
              f"displacements at the clamp", cuda_sample.sample_at(topo.nbr, fn, dd),
              cuda_sample.sample_at_plain(topo.nbr, fn, dd), TOL_B1)
    del dd, allf, fn
    t5 = build_topology(plume.build_plume_envelope(40, 256), capacity=2048, device=dev)
    m5 = active_mask(t5)[:, None]
    d5, k5 = field(2048, 512, mask=m5), in_domain(2048, m5)
    for mk in (None, k5):
        check("B5", f"T=2048, 24 iterations, {'mask' if mk is not None else 'no mask'}",
              cuda_pressure.rbsor_fused(t5.nbr, d5, 24, omega, dx2, mask=mk),
              cuda_pressure.rbsor_fused_plain(t5.nbr, d5, 24, omega, dx2, mask=mk))
    del t5, m5, d5, k5

    # BASELINE config 5: the domain and its hierarchy (reused in phase 9)
    c5 = CELLS["c5"].topology(dev)
    c5_mg = CELLS["c5-mg"].params
    c5_hier = multigrid.hierarchy_for(c5, c5_mg)
    lv2 = c5_hier[1]
    d2 = field(lv2.topo.capacity, 512, mask=lv2.mask)
    p_k = p_p = torch.zeros_like(d2)
    for _ in range(2):
        p_k = cuda_pressure.rbsor_lagged(lv2.topo.nbr, p_k, d2, 1, omega, 4 * dx2, lv2.mask)
        p_p = cuda_pressure.rbsor_lagged_plain(lv2.topo.nbr, p_p, d2, 1, omega, 4 * dx2,
                                               lv2.mask)
    check("B3", f"mask, config-5 level 2 T={lv2.topo.capacity}, 2 launches x 1 pair", p_k, p_p)
    m_c5 = active_mask(c5)[:, None]
    pc, dc = field(c5.capacity, 512, mask=m_c5), field(c5.capacity, 512, mask=m_c5)
    check("B6", f"config-5 fine T={c5.capacity}", cuda_stencil.residual(c5.nbr, pc, dc, 0.5),
          cuda_stencil.residual_plain(c5.nbr, pc, dc, 0.5))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    vc = torch.randn((3, c5.capacity, 512), generator=gen, device=dev) * m_c5
    check("B7a", f"config-5 fine T={c5.capacity}", cuda_stencil.divergence(c5.nbr, vc, 1 / 0.3),
          cuda_stencil.divergence_plain(c5.nbr, vc, 1 / 0.3))
    check("B7b", f"config-5 fine T={c5.capacity}",
          cuda_stencil.subtract_gradient(c5.nbr, vc, pc, 1 / 0.3),
          cuda_stencil.subtract_gradient_plain(c5.nbr, vc, pc, 1 / 0.3))
    del d2, p_k, p_p, pc, dc, m_c5, vc
    done("3")

    # -- 4. the main path ------------------------------------------------------
    state = zeros_state(topo)
    t0 = time.perf_counter()
    with main_path("4", {"B1": 2, "B2": 2, "B3": params.iterations // lag, "B7a": 1, "B7b": 1},
                   bench.develop):
        topo, state = plume.run_plume(bench.develop, params, cfg, topo=topo, state=state,
                                      grow_every=0)
    wall = time.perf_counter() - t0
    print(f"[4] main path: {bench.develop} plume steps on {topo.n_active} tiles "
          f"({topo.num_voxels} active voxels, capacity {T}), {params.iterations} "
          f"iterations at halo_lag {lag}: {wall:.2f} s wall; max density "
          f"{float(state.scalars['density'].max()):.4f}, max |u| "
          f"{float(state.velocity.abs().max()):.3f}", flush=True)
    check_state("4", topo, state)
    done("4")

    # -- 5. one step through the kernels vs through the plain versions ----------
    step_vs_plain("5", lambda: plume.plume_step(topo, state, params, cfg))
    done("5")

    # -- 6. timing ---------------------------------------------------------------
    s = state

    def one_step():
        plume.plume_step(topo, s, params, cfg)

    one_step()
    step_ms = statistics.median(cuda_ms(one_step, 15))
    vups = topo.num_voxels / (step_ms * 1e-3)
    for key, r in time_calls("6", record(one_step, ("B1", "B2", "B3", "B7a", "B7b"))).items():
        kernels[key].update(r)
    print(f"[6] step: {step_ms:.3f} ms/step (median of 15, CUDA events), "
          f"{vups:.4e} active voxel-updates/s, {topo.num_voxels} voxels, "
          f"{params.iterations} iterations | {card}", flush=True)
    done("6")

    # -- 7. multigrid on the bench domain ----------------------------------------
    # Per step (mg_levels 2, iterations = 2 V-cycles, FMG, n_pre = n_post = 2,
    # n_coarsest 24, smooth_lag "pair"): the fine level (4608 rows) is above
    # MAX_FUSED_ROWS, so each smoothing call is n_pre = 2 one-pair B3 blocks;
    # level 1 (1024 rows) and level 2 (128) take one B5 per solve. A V-cycle
    # from the fine level: B3 2 + 2, B6 at fine and level 1, B5 at level 1
    # pre and post and the level-2 solve: B3 4, B5 3, B6 2. A V-cycle from
    # level 1: B5 3, B6 1. FMG: the level-2 solve (B5 1), the level-1
    # V-cycle, the fine V-cycle: B3 4, B5 7, B6 3. Then 2 V-cycles: B3 8,
    # B5 6, B6 4. Per step: B1 2, B2 2, B3 12, B5 13, B6 7.
    mg_params = CELLS["bench-mg"].params
    hier = multigrid.hierarchy_for(topo, mg_params)
    print(f"[7] bench hierarchy: tiles per level "
          f"{[topo.n_active] + [lv.topo.n_active for lv in hier]}, capacities "
          f"{[T] + [lv.topo.capacity for lv in hier]}", flush=True)
    with main_path("7", {"B1": 2, "B2": 2, "B3": 12, "B5": 13, "B6": 7, "B7a": 1, "B7b": 1},
                   MG_STEPS):
        topo, mg_state = plume.run_plume(MG_STEPS, mg_params, cfg, topo=topo, state=state,
                                         grow_every=0)
    check_state("7", topo, mg_state)
    step_vs_plain("7", lambda: plume.plume_step(topo, mg_state, mg_params, cfg, hier))

    def mg_step():
        plume.plume_step(topo, mg_state, mg_params, cfg, hier)

    mg_step()
    mg_ms = statistics.median(cuda_ms(mg_step, 7))
    for key, r in time_calls("7", record(mg_step, ("B3", "B5", "B6"))).items():
        if key != "B3":  # B3's row stays the bench RBGS step's
            kernels[key].update(r)
    print(f"[7] bench MG step: {mg_ms:.3f} ms/step (median of 7, CUDA events) vs RBGS-50 "
          f"{step_ms:.3f} | {card}", flush=True)
    done("7")

    # -- 8. the "parity" precision tier: halo_lag 1 ---------------------------
    par_params = params.replace(precision="parity")
    assert par_params.effective_halo_lag == 1
    with main_path("8", {"B1": 2, "B2": 2, "B4": 2 * params.iterations, "B7a": 1, "B7b": 1}, 1):
        topo, par_state = plume.run_plume(1, par_params, cfg, topo=topo, state=state,
                                          grow_every=0)
    check_state("8", topo, par_state)
    step_vs_plain("8", lambda: plume.plume_step(topo, state, par_params, cfg))

    def par_step():
        plume.plume_step(topo, state, par_params, cfg)

    par_step()
    par_ms = statistics.median(cuda_ms(par_step, 5))
    kernels["B4"].update(time_calls("8", record(par_step, ("B4",)))["B4"])
    print(f"[8] bench parity-tier step: {par_ms:.3f} ms/step (median of 5) | {card}",
          flush=True)
    bench_state = state  # the developed bench state, for phase 14
    del mg_state, par_state, s, state
    done("8")

    # -- 9. BASELINE config 5 at full size, kernels only -------------------------
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    c5_rb, cfg5 = CELLS["c5"].params, CELLS["c5"].plume
    print(f"[9] config 5: {c5.n_active} tiles = {c5.num_voxels} voxels (capacity "
          f"{c5.capacity}); hierarchy tiles per level "
          f"{[c5.n_active] + [lv.topo.n_active for lv in c5_hier]}, capacities "
          f"{[c5.capacity] + [lv.topo.capacity for lv in c5_hier]}", flush=True)
    with main_path("9", {"B1": 2, "B2": 2, "B3": 10, "B7a": 1, "B7b": 1}, CELLS["c5"].develop):
        c5, st5 = plume.run_plume(CELLS["c5"].develop, c5_rb, cfg5, topo=c5, grow_every=0)
    check_state("9", c5, st5)
    # Per MG step (mg_levels 5): fine 269,312, L1 45,056 and L2 6,144 rows
    # smooth with one-pair B3 blocks (L1, L2 masked); L3 1,024, L4 128, L5 32
    # rows with one B5 per solve. A V-cycle from level k visits levels k..4
    # (pre + post smoothing and one B6 each) and solves level 5 (B5 1):
    # from the fine level B3 12, B5 5, B6 5. FMG: the level-5 solve, then one
    # V-cycle from each level 4..0: B3 0+0+4+8+12, B5 1+3+5+5+5+5, B6
    # 1+2+3+4+5. With 2 V-cycles: B3 48, B5 34, B6 25 (B1 2, B2 2).
    with main_path("9", {"B1": 2, "B2": 2, "B3": 48, "B5": 34, "B6": 25, "B7a": 1, "B7b": 1},
                   C5_MG_STEPS):
        c5, st5 = plume.run_plume(C5_MG_STEPS, c5_mg, cfg5, topo=c5, state=st5,
                                  grow_every=0)
    check_state("9", c5, st5)

    def c5_step(p_, h_):
        return lambda: plume.plume_step(c5, st5, p_, cfg5, h_)

    c5_ms = {}
    for name, p_, h_ in (("MG", c5_mg, c5_hier), ("RBGS-50", c5_rb, ())):
        c5_ms[name] = statistics.median(cuda_ms(c5_step(p_, h_), 3))
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
    print(f"[9] config 5 ms/step (median of 3, CUDA events): MG {c5_ms['MG']:.1f}, "
          f"RBGS-50 {c5_ms['RBGS-50']:.1f}; {c5.num_voxels / (c5_ms['MG'] * 1e-3):.4e} "
          f"(MG) and {c5.num_voxels / (c5_ms['RBGS-50'] * 1e-3):.4e} (RBGS) active "
          f"voxel-updates/s; peak device memory {peak / 2**30:.2f} GiB | {card}", flush=True)
    if not rmax["MG"] <= C5_RMAX_OVER_DIV0 * div0:
        raise AssertionError(f"phase 9: MG max|r| {rmax['MG']} > {C5_RMAX_OVER_DIV0} * "
                             f"div0 {div0}")
    # after the peak is read: the plain versions' temporaries are not the step's
    time_calls("9", record(c5_step(c5_mg, c5_hier), ("B3", "B5", "B6", "B7a", "B7b")), plain=False)
    del c5, st5, c5_hier, lv2, div5
    torch.cuda.empty_cache()
    done("9")

    # -- 10. BASELINE config 4: the moving SDF sphere ----------------------------
    c4 = CELLS["c4"]
    p4, cfg4 = c4.params, c4.plume
    t4 = c4.topology(dev)
    inv4, act = p4.inv_voxel_size, slice(1, t4.n_active + 1)
    print(f"[10] config 4: {t4.n_active} tiles = {t4.num_voxels} voxels (capacity "
          f"{t4.capacity}), sphere radius {col4.radius} from {col4.center0} at "
          f"{col4.velocity} voxels/s, {p4.iterations} iterations", flush=True)

    def advection_input(st_in):
        """The scalars entering a frame's scalar advection: the frame's input
        after emit and combustion (both pointwise, as in the step)."""
        s_ = plume.emit(t4, st_in, cfg4, p4.dt).scalars
        cp = p4.combustion
        fuel, waste, temp, flame, _ = combustion.combustion_oxygen(
            s_["fuel"], s_["waste"], s_["temperature"], s_["flame"],
            torch.zeros_like(s_["fuel"]), cp.temperature_release, cp.expansion_rate)
        return {**s_, "fuel": fuel, "waste": waste, "temperature": temp, "flame": flame}

    prev = [zeros_state(t4)]

    def on_frame(f, topo_, st):
        sdf = st.scalars[COLLISION_FIELD]
        want = collider.sphere_sdf(topo_, collider.collider_center(col4, f, p4.dt, dev),
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
    with main_path("10", {"B1": 2, "B2": 2, "B3": p4.iterations // p4.effective_halo_lag,
                          "B7a": 1, "B7b": 1}, c4.develop):
        t4, st4 = collider.run_collider(c4.develop, p4, cfg4, col4, topo=t4, state=prev[0],
                                        grow_every=0, on_frame=on_frame)
    print(f"[10] {c4.develop} collider frames: {time.perf_counter() - t0:.2f} s wall with "
          f"the per-frame checks", flush=True)
    check_state("10", t4, st4)
    travel = float((collider.collider_center(col4, c4.develop - 1, p4.dt)
                    - collider.collider_center(col4, 0, p4.dt)).norm())
    if not travel > 5.0:
        raise AssertionError(f"phase 10: the collider moved {travel} voxels")

    def c4_step():
        return collider.collider_step(t4, st4, p4, cfg4, col4, c4.develop)

    step_vs_plain("10", c4_step)
    c4_step()
    c4_ms = statistics.median(cuda_ms(c4_step, 7))
    time_calls("10", record(c4_step, ("B1", "B2", "B3", "B7a", "B7b")))
    print(f"[10] config-4 step: {c4_ms:.3f} ms/step (median of 7, CUDA events), "
          f"{t4.num_voxels / (c4_ms * 1e-3):.4e} active voxel-updates/s; the collider "
          f"travelled {travel:.1f} voxels | {card}", flush=True)
    done("10")

    # -- 11. RK2-4 backtraces on the developed config-4 state ---------------------
    vel4, sdf4 = st4.velocity, st4.scalars[COLLISION_FIELD]
    sc4 = {k: v for k, v in st4.scalars.items() if k != COLLISION_FIELD}
    for order in (2, 3, 4):
        for s_ in (None, sdf4):
            tag = f"RK{order}" + ("" if s_ is None else " + SDF")
            n8 = order - 1 + 2 + (0 if s_ is None else 2)

            def rk(order=order, s_=s_):
                return (advection.advect_velocity(t4, vel4, p4.dt, inv4, s_, order),
                        advection.advect_scalars_fused(t4, vel4, sc4, p4.dt, inv4, s_, order))

            with main_path(f"11 {tag} velocity", {"B8": n8, "B2": 1}, 1):
                advection.advect_velocity(t4, vel4, p4.dt, inv4, s_, order)
            with main_path(f"11 {tag} scalars", {"B8": n8, "B2": 1}, 1):
                advection.advect_scalars_fused(t4, vel4, sc4, p4.dt, inv4, s_, order)
            (uk, sk) = rk()
            with plain_versions():
                up, sp = rk()
            worst, parts = 0.0, []
            for name, g, w in [("velocity", uk, up)] + [(k, sk[k], sp[k]) for k in sorted(sk)]:
                if not bool(torch.isfinite(g).all()):
                    raise AssertionError(f"phase 11 {tag}: {name} not finite")
                _, rel = rel_err(g, w)
                worst = max(worst, rel)
                parts.append(f"{name} {rel:.2e}")
            print(f"[11] {tag}: kernels vs plain, max rel err per field {', '.join(parts)} "
                  f"(tol {TOL_STEP:g})", flush=True)
            if not worst <= TOL_STEP:
                raise AssertionError(f"phase 11 {tag}: rel err {worst} > {TOL_STEP}")
            groups = record(rk, ("B8", "B2"))
            if order == 4 and s_ is not None:
                kernels["B8"].update(time_calls("11", groups)["B8"])
            else:
                for key, a, kw, _, _ in groups:
                    vs_plain("11", key, a, kw)
            rk()
            print(f"[11] {tag}: velocity + scalar advection "
                  f"{statistics.median(cuda_ms(rk, 5)):.3f} ms (median of 5) | {card}",
                  flush=True)
    done("11")
    del t4, st4, vel4, sdf4, sc4, prev
    torch.cuda.empty_cache()

    # -- 12-13. growing topologies: BASELINE configs 2 and 3 -------------------
    from hnanosolver_tpu_torch.core import activation

    def step_counts(cap: int, p_) -> dict:
        """Launches of one step without collision at capacity ``cap`` on the
        nbr path with at most 8 scalars: the pressure solve as
        ops/pressure.solve_pressure dispatches it."""
        c = {"B1": 2, "B2": 2, "B7a": 1, "B7b": 1}
        if cap <= cuda_pressure.MAX_FUSED_ROWS:
            c["B5"] = 1
        else:
            lag_ = p_.effective_halo_lag
            blocks = p_.iterations // lag_ if lag_ > 1 else 0
            c["B3"], c["B4"] = blocks, 2 * (p_.iterations - blocks * lag_)
        return c

    def totals(caps: list, p_):
        def want():
            out = {}
            for cap in caps:
                for key, n in step_counts(cap, p_).items():
                    out[key] = out.get(key, 0) + n
            return out
        return want

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
            io, in_ = torch.from_numpy(io + 1).to(dev), torch.from_numpy(in_ + 1).to(dev)
            fresh = torch.ones(new_t.capacity, dtype=torch.bool, device=dev)
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

    def frame_printer(label: str, caps: list, clock: dict):
        clock.update(start=time.perf_counter(), step=[], grow=[])

        def on_frame(f, topo_, st):
            check_state(label, topo_, st)
            print(f"[{label}] frame {f}: step at capacity {caps[-1]} {clock['step'][-1]:.4f} s, "
                  f"growth {clock['grow'][-1]:.4f} s -> {topo_.n_active} tiles at capacity "
                  f"{topo_.capacity}; max|u| {float(st.velocity.abs().max()):.2f}", flush=True)
            torch.cuda.synchronize()
            clock["start"] = time.perf_counter()
        return on_frame

    def frame_summary(label: str, clock: dict):
        st_, gr = clock["step"], clock["grow"]
        print(f"[{label}] seconds per frame, median (last 10 frames): step "
              f"{statistics.median(st_):.4f} ({statistics.median(st_[-10:]):.4f}), growth "
              f"{statistics.median(gr):.4f} ({statistics.median(gr[-10:]):.4f}); sums step "
              f"{sum(st_):.3f}, growth {sum(gr):.3f} | {card}", flush=True)

    p2, cfg2 = SolverParams(), plume.PlumeConfig()
    caps2, clock2 = [], {}
    t0 = time.perf_counter()
    with growth_checked("12", plume, caps2, clock2), main_path("12", totals(caps2, p2)):
        t2, st2 = plume.run_plume(C2_FRAMES, p2, cfg2, device=dev,
                                  on_frame=frame_printer("12", caps2, clock2))
    frame_summary("12", clock2)
    print(f"[12] config 2: {C2_FRAMES} frames in {time.perf_counter() - t0:.2f} s wall "
          f"(growth and per-frame checks included): {t2.n_active} tiles, capacity "
          f"{t2.capacity}, max density {float(st2.scalars['density'].max()):.4f}", flush=True)
    check_state("12", t2, st2)
    if not t2.n_active > len(plume.emitter_tiles(cfg2)):
        raise AssertionError("phase 12: the topology did not grow")
    step_vs_plain("12", lambda: plume.plume_step(t2, st2, p2, cfg2))
    done("12")

    p3, cfg3 = fire.default_params(), fire.FireConfig()
    caps3, clock3 = [], {}
    t0 = time.perf_counter()
    with growth_checked("13", fire, caps3, clock3), main_path("13", totals(caps3, p3)):
        t3, st3 = fire.run_fire(C3_FRAMES, p3, cfg3, device=dev,
                                on_frame=frame_printer("13", caps3, clock3))
    frame_summary("13", clock3)
    sc3 = st3.scalars
    hot = torch.where(sc3["temperature"] > 50.0, positions_flat(t3)[1].to(torch.float32), -1e9)
    facts = dict(flame=float(sc3["flame"].max()), waste=float(sc3["waste"].sum()),
                 temperature=float(sc3["temperature"].max()), hot_y=float(hot.max()))
    print(f"[13] config 3: {C3_FRAMES} frames in {time.perf_counter() - t0:.2f} s wall: "
          f"{t3.n_active} tiles, capacity {t3.capacity}; max flame {facts['flame']:.4f} "
          f"(> 0.3), waste sum {facts['waste']:.3f} (> 0), max T {facts['temperature']:.2f} "
          f"(> 85), hot gas up to y {facts['hot_y']:.0f} (> 10)", flush=True)
    check_state("13", t3, st3)
    if not (facts["flame"] > 0.3 and facts["waste"] > 0 and facts["temperature"] > 85
            and facts["hot_y"] > 10):
        raise AssertionError(f"phase 13: the fireball checks failed: {facts}")
    step_vs_plain("13", lambda: fire.fire_step(t3, st3, p3, cfg3))
    del t2, st2, t3, st3, sc3, hot
    done("13")

    # -- 14. the table sampler on the bench cell ---------------------------------
    for name, cell in (("bench", bench), ("config 5", CELLS["c5"])):
        tiles = plume.build_plume_envelope(*cell.envelope)
        n = len(np.unique(tiles, axis=0))
        cap = ((n + 1 + 511) // 512) * 512
        secs = {}
        for what, kw in (("plain", {}), ("plans", {"plans": True})):
            t0 = time.perf_counter()
            topology_mod.build_topology(tiles, capacity=cap, device=dev, **kw)
            torch.cuda.synchronize()
            secs[what] = time.perf_counter() - t0
        print(f"[14] build_topology host seconds, {name} ({n} tiles, capacity {cap}): "
              + ", ".join(f"{k} {v:.3f}" for k, v in secs.items()), flush=True)
    torch.cuda.empty_cache()

    tb = topology_mod.ensure_chunk_plans(topo)
    nc, Ud = tb.chunk_dsrc.shape[:2]
    print(f"[14] bench chunk plans: {nc} chunks, U {tb.chunk_uniq.shape[1]}, Ud {Ud}", flush=True)
    vel0, sc0 = bench_state.velocity, bench_state.scalars
    # emit sets the jet inside the emitter: scale the flow outside it, so
    # that the velocity pass sees the band's CFL
    inside = plume.emit(topo, zeros_state(topo), cfg, params.dt).velocity[1] != 0
    cfl0 = float(vel0.abs().amax(0)[~inside].max()) * sdt
    print(f"[14] developed bench state: CFL max|u|*sdt = {float(vel0.abs().max()) * sdt:.3f}, "
          f"{cfl0:.3f} outside the emitter", flush=True)
    names = sorted(sc0)

    def table_counts(comb: bool):
        def want():
            b = advection.BANDS
            c = {"B2": 2, "B3": params.iterations // lag, "B7a": 1, "B7b": 1,
                 "B1": b["wide"], "B8": b["mixed fwd wide"],
                 "B1d": b["narrow"] + b["mixed"] + b["mixed fwd narrow"]}
            if comb:
                c["B11"] = b["narrow"] + b["mixed"]
            return c
        return want

    def vmem(comb):
        advection.INTERP, cuda_tables.COMBINE_TBL = "vmem", comb

    def nbr_path():
        advection.INTERP, cuda_tables.COMBINE_TBL = None, None

    narrow_step = None
    for band, cfl in BANDS:
        vb = (vel0 * (cfl / cfl0)).contiguous()
        sb = FieldState(velocity=vb, scalars=sc0)
        f8 = torch.cat([vb, torch.stack([sc0[k] for k in names])]).contiguous()
        for comb in (False, True):
            vmem(comb)
            advection.BANDS.clear()
            label = f"14 {band} COMBINE_TBL={comb}"
            with main_path(label, table_counts(comb)):
                out_v = plume.plume_step(tb, sb, params, cfg)
            print(f"[{label}] branches taken {dict(advection.BANDS)}", flush=True)
            step_vs_plain(label, lambda: plume.plume_step(tb, sb, params, cfg))
            nbr_path()
            out_n = plume.plume_step(topo, sb, params, cfg)
            parts, worst = [], 0.0
            for fname in ["velocity"] + sorted(out_v.scalars):
                g = out_v.velocity if fname == "velocity" else out_v.scalars[fname]
                w = out_n.velocity if fname == "velocity" else out_n.scalars[fname]
                _, rel = rel_err(g, w)
                worst = max(worst, rel)
                parts.append(f"{fname} {rel:.2e}{' (bitwise)' if torch.equal(g, w) else ''}")
            print(f"[{label}] step vs the nbr-path step, max rel err per field: "
                  f"{', '.join(parts)} (tol {TOL_STEP:g})", flush=True)
            if not worst <= TOL_STEP:
                raise AssertionError(f"phase {label}: vs the nbr path {worst} > {TOL_STEP}")
            if band == "narrow" and comb:
                def narrow_step(tb=tb, sb=sb):
                    vmem(True)
                    plume.plume_step(tb, sb, params, cfg)
        # the kernels at this band's inputs (scalar pass: velocity + 5 scalars)
        lab = f"14 {band}"
        if band == "narrow":
            t27 = tables.build_table(tb, f8)
            b11 = cuda_tables.build_table_dual_combine(t27, tb.chunk_dloc, 8)
            check("B11", f"T={T} nf=8 vs plain", b11,
                  cuda_tables.build_table_dual_combine_plain(t27, tb.chunk_dloc, 8), 0.0, lab)
            tdual = tables.build_table_dual(tb, f8)
            check("B11", f"T={T} nf=8 vs build_table_dual", b11, tdual, 0.0, lab)
            for fl, fields in ((0, vb), (3, f8)):
                tv = tables.build_table_dual(tb, fields)
                nb_ = fields.shape[0]
                got = cuda_bfecc.bfecc_sample_dual(tv, tb.chunk_ldual, vb, sdt, nb_, fl)
                want = cuda_bfecc.bfecc_sample_dual_plain(tv, tb.chunk_ldual, vb, sdt, nb_, fl)
                ref = cuda_bfecc.bfecc_sample(topo.nbr, fields, sdt, fl)
                for part, g, w, r in zip(("phiF", "phiB"), got, want, ref):
                    check("B1d", f"both f_lo={fl} {part} vs plain", g, w, TOL_B1, lab)
                    check("B1d", f"both f_lo={fl} {part} vs nbr B1", g, r, 0.0, lab)
            ts = tables.build_table_dual(tb, torch.cat([f8, sdf3[None]]))
            got = cuda_bfecc.bfecc_sample_dual(ts, tb.chunk_ldual, vb, sdt, 8, 3, "both", True)
            want = cuda_bfecc.bfecc_sample_dual_plain(ts, tb.chunk_ldual, vb, sdt, 8, 3, "both",
                                                      True)
            ref = cuda_bfecc.bfecc_sample(topo.nbr, f8, sdt, 3, sdf3)
            for part, g, w, r in zip(("phiF", "phiB"), got, want, ref):
                check("B1d", f"both + SDF {part} vs plain", g, w, TOL_B1, lab)
                check("B1d", f"both + SDF {part} vs nbr B1", g, r, 0.0, lab)
            k_ms, p_ms = paired_ms(
                lambda: cuda_tables.build_table_dual_combine(t27, tb.chunk_dloc, 8),
                lambda: cuda_tables.build_table_dual_combine_plain(t27, tb.chunk_dloc, 8))
            t27_ms = statistics.median(cuda_ms(lambda: tables.build_table(tb, f8), 5, 10))
            dual_ms = statistics.median(cuda_ms(lambda: tables.build_table_dual(tb, f8), 5, 10))
            print(f"[{lab}] nf=8 tables: B11 {k_ms:.4f} ms (plain {p_ms:.4f}), build_table "
                  f"{t27_ms:.4f} ms, build_table_dual {dual_ms:.4f} ms ({nbytes(t27) / 1e6:.1f} "
                  f"and {nbytes(tdual) / 1e6:.1f} MB) | {card}", flush=True)
            del t27, b11, tdual, ts
        elif band == "mixed":
            tv = tables.build_table_dual(tb, f8)
            d = torch.clamp(-vb * sdt, -lim, lim)
            got = cuda_bfecc.bfecc_sample_dual(tv, tb.chunk_ldual, vb, sdt, 8, 0, "back")
            check("B1d", "back vs plain", got, cuda_bfecc.bfecc_sample_dual_plain(
                tv, tb.chunk_ldual, vb, sdt, 8, 0, "back"), TOL_B1, lab)
            check("B1d", "back vs B8", got, cuda_sample.sample_at(topo.nbr, f8, d), 0.0, lab)
            d2 = torch.clamp(d + got[:3] * sdt, -3.85, 3.85)
            got = cuda_bfecc.bfecc_sample_dual(tv, tb.chunk_ldual, d2, sdt, 8, 3, "fwd")
            check("B1d", "fwd vs plain", got, cuda_bfecc.bfecc_sample_dual_plain(
                tv, tb.chunk_ldual, d2, sdt, 8, 3, "fwd"), TOL_B1, lab)
            check("B1d", "fwd vs B8", got,
                  cuda_sample.sample_at(topo.nbr, f8[3:].contiguous(), d2), 0.0, lab)
            del tv, d, d2
        # the scalar pass: the table path against the nbr-form B1
        times = {}
        for what, fn in (("nbr B1", lambda: cuda_bfecc.bfecc_sample(topo.nbr, f8, sdt, 3)),
                         ("table path", lambda: advection._bfecc_samples(tb, f8, sdt, 3, None, 1)),
                         ("table path + B11", lambda: advection._bfecc_samples(
                             tb, f8, sdt, 3, None, 1))):
            vmem("B11" in what)
            fn()
            times[what] = statistics.median(cuda_ms(fn, 5, 5))
        nbr_path()
        print(f"[{lab}] scalar pass (3 + 5 fields, CFL {cfl}): "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())
              + f" (with the host CFL read and the table builds) | {card}", flush=True)
        del f8, vb, sb, out_v, out_n
    groups = record(narrow_step, ("B1d", "B11"))
    nbr_path()
    for key, r in time_calls("14", groups).items():
        kernels[key].update(r)
    nbr_path()
    del tb, bench_state
    done("14")

    print(card)
    print(json.dumps({"kernels": [
        {"name": k["name"], "route": k["route"], "source": k["source"],
         "replaces": k["replaces"], "launches": k["launches"],
         "max_abs_err": k["max_abs_err"], "ms": k["ms"], "plain_ms": k["plain_ms"],
         "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
         "library_ms": k["library_ms"]}
        for k in kernels.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
