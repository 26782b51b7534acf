"""Command-line runner of the port — the JAX package's ``cli.py`` with its
argument names and defaults, the standalone equivalent of the reference's
SOP nodes: scenarios, the full-solver cook on user VDB files and the
file-level operator nodes.

Usage:
  python -m hnanosolver_tpu_torch.cli solve feedback.vdb --source src.vdb \\
      --collision col.vdb --frames 24 --ckpt-every 6 --out out/solved.vdb
  python -m hnanosolver_tpu_torch.cli solve out/solve_0006.npz --frames 6
  python -m hnanosolver_tpu_torch.cli advect in.vdb --out advected.vdb
  python -m hnanosolver_tpu_torch.cli plume --frames 24 --out out/ --ckpt-every 6 --render
  python -m hnanosolver_tpu_torch.cli bench-report --frames 5
  python -m hnanosolver_tpu_torch.cli turntable --ckpt out/frame_0024.npz --frames 24
  python -m hnanosolver_tpu_torch.cli view --live plume --port 8642

Subcommands: plume, collide, fire, resume, bench-report, turntable,
advect, advect-velocity, project, solve, view. Every subcommand runs on
``--device`` (default ``cuda``; ``cpu`` runs the kernels' plain PyTorch
versions). ``--precision`` is
accepted for the JAX package's command lines; the port computes in float32
at every tier, and the tier selects only the pressure solve's halo lag.

Parameter names mirror the SOP DS file
(`reference/src/SOP/HNanoSolver/SOP_HNanoSolver.cpp:21-88`).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time


def _add_device_arg(p: argparse.ArgumentParser):
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu runs the kernels' "
                        "plain versions)")


def _add_solver_args(p: argparse.ArgumentParser):
    p.add_argument("--timestep", type=float, default=1.0 / 24.0)
    p.add_argument("--voxel-size", type=float, default=0.5)
    p.add_argument("--iterations", type=int, default=20)
    p.add_argument("--expansion-rate", type=float, default=0.1)
    p.add_argument("--temperature-gain", type=float, default=0.5)
    p.add_argument("--buoyancy-strength", type=float, default=1.0)
    p.add_argument("--ambient-temp", type=float, default=23.0)
    p.add_argument("--vorticity", type=float, default=1.0)
    p.add_argument("--factor-scale", type=float, default=0.5)
    p.add_argument("--precision", choices=["parity", "balanced", "fast"],
                   default="balanced",
                   help="accepted for the JAX package's command lines; the port "
                        "computes float32 at every tier (parity: halo lag 1)")
    p.add_argument("--padding", type=int, default=None,
                   help="domain dilation in VOXELS (the reference SOP's "
                        "padding param); default: 1 tile ring")
    p.add_argument("--debug", action="store_true",
                   help="per-frame diagnostics: NaN guard + CFL-clamp count "
                        "(voxels where |u|*dt/dx >= 7 silently deviate from "
                        "the reference's unbounded backtrace)")
    _add_device_arg(p)


def _add_output_args(p: argparse.ArgumentParser):
    p.add_argument("--out", default="out")
    p.add_argument("--ckpt-every", type=int, default=0)
    p.add_argument("--format", choices=["npz", "vdb", "vdbz", "nvdb"], default="npz",
                   help="frame output format (vdb = Houdini-loadable OpenVDB; "
                        "vdbz = ZIP-compressed vdb)")
    p.add_argument("--render", action="store_true",
                   help="write an orthographic PNG of the density every --render-every frames")
    p.add_argument("--render-every", type=int, default=1)
    p.add_argument("--view-box", type=int, nargs=3, default=[128, 128, 128])


def _params(args):
    from hnanosolver_tpu_torch.config import CombustionParams, SolverParams

    return SolverParams(
        dt=args.timestep,
        voxel_size=args.voxel_size,
        iterations=args.iterations,
        precision=args.precision,
        combustion=CombustionParams(
            expansion_rate=args.expansion_rate,
            temperature_release=args.temperature_gain,
            buoyancy_strength=args.buoyancy_strength,
            ambient_temp=args.ambient_temp,
            vorticity_scale=args.vorticity,
            factor_scale=args.factor_scale,
        ),
    )


def _save_frame(fmt: str, out_dir: str, stem: str, topo, state, params, frame):
    """One frame to disk in the selected format: npz (exact resume), vdb /
    vdbz (Houdini-loadable OpenVDB), nvdb (NanoVDB)."""
    if fmt == "npz":
        from hnanosolver_tpu_torch.io.state import save_npz

        save_npz(os.path.join(out_dir, f"{stem}_{frame:04d}.npz"),
                 topo, state, params, frame=frame)
    elif fmt in ("vdb", "vdbz"):
        from hnanosolver_tpu_torch.io.vdb import state_to_vdb

        state_to_vdb(os.path.join(out_dir, f"{stem}_{frame:04d}.vdb"),
                     topo, state, voxel_size=params.voxel_size, compress=fmt == "vdbz")
    elif fmt == "nvdb":
        from hnanosolver_tpu_torch.io.nvdb import write_state_nvdb

        write_state_nvdb(os.path.join(out_dir, f"{stem}_{frame:04d}"),
                         topo, state, voxel_size=params.voxel_size)
    else:
        raise ValueError(f"unknown --format {fmt}")


def _render_frame(args, stem: str, f: int, topo, state):
    """--render: the orthographic PNG of frame f + 1 over the view box."""
    if args.render and (f + 1) % args.render_every == 0:
        from hnanosolver_tpu_torch.viewer.render import render_state, write_png

        write_png(os.path.join(args.out, f"{stem}_{f + 1:04d}.png"),
                  render_state(topo, state, tuple(args.view_box)))


def _frame_hook(args, params, stem: str):
    """on_frame for the scenario drivers: --debug checks, checkpoints,
    renders, a progress line."""
    def on_frame(f, topo, state):
        t0 = time.perf_counter()
        if args.debug:
            from hnanosolver_tpu_torch.utils.debug import assert_finite_state, check_cfl

            assert_finite_state(state, where=f"frame {f + 1}")
            n_clamped = check_cfl(topo, state, params)
            if n_clamped:
                print(f"  WARNING: CFL clamp engaged on {n_clamped} voxels "
                      f"(|u|*dt/dx >= 7)", flush=True)
        if args.ckpt_every and (f + 1) % args.ckpt_every == 0:
            _save_frame(args.format, args.out, stem, topo, state, params, f + 1)
        _render_frame(args, stem, f, topo, state)
        print(f"frame {f + 1}/{args.frames}: {int(topo.n_active)} tiles "
              f"({topo.num_voxels / 1e6:.2f} M voxels), io {time.perf_counter() - t0:.2f}s",
              flush=True)
    return on_frame


def cmd_plume(args):
    from hnanosolver_tpu_torch.models.plume import PlumeConfig, run_plume
    from hnanosolver_tpu_torch.utils.interrupt import Interrupter

    params = _params(args)
    cfg = PlumeConfig(center=tuple(args.center), radius=args.radius, padding=args.padding)
    os.makedirs(args.out, exist_ok=True)
    t0 = time.perf_counter()
    # Ctrl-C stops cleanly between frames and still writes a checkpoint
    with Interrupter() as intr:
        topo, state = run_plume(args.frames, params=params, cfg=cfg,
                                on_frame=_frame_hook(args, params, "frame"),
                                device=args.device, interrupter=intr)
    if intr.was_interrupted():
        _save_frame(args.format, args.out, "interrupted", topo, state, params, 0)
        print("interrupted: wrote checkpoint, exiting cleanly")
    else:
        print(f"done: {args.frames} frames in {time.perf_counter() - t0:.1f}s")


def cmd_collide(args):
    """Moving-collider scenario (BASELINE config 4): a plume with a
    translating sphere whose SDF is re-evaluated on the device each frame."""
    from hnanosolver_tpu_torch.models.collider import ColliderConfig, run_collider
    from hnanosolver_tpu_torch.models.plume import PlumeConfig
    from hnanosolver_tpu_torch.utils.interrupt import Interrupter

    params = _params(args)
    cfg = PlumeConfig(center=tuple(args.center), radius=args.radius, padding=args.padding)
    col = ColliderConfig(center0=tuple(args.collider_center),
                         velocity=tuple(args.collider_velocity), radius=args.collider_radius)
    os.makedirs(args.out, exist_ok=True)
    t0 = time.perf_counter()
    with Interrupter() as intr:
        run_collider(args.frames, params=params, cfg=cfg, col=col,
                     on_frame=_frame_hook(args, params, "frame"), device=args.device,
                     interrupter=intr)
    print(f"done: {args.frames} frames in {time.perf_counter() - t0:.1f}s")


def cmd_fire(args):
    from hnanosolver_tpu_torch.models.fire import FireConfig, default_params, run_fire

    params = default_params().replace(
        dt=args.timestep, voxel_size=args.voxel_size, iterations=args.iterations)
    cfg = FireConfig(center=tuple(args.center), radius=args.radius, padding=args.padding)
    os.makedirs(args.out, exist_ok=True)

    def on_frame(f, topo, state):
        if args.ckpt_every and (f + 1) % args.ckpt_every == 0:
            _save_frame(args.format, args.out, "fire", topo, state, params, f + 1)
        _render_frame(args, "fire", f, topo, state)
        print(f"frame {f + 1}/{args.frames}: {int(topo.n_active)} tiles", flush=True)

    run_fire(args.frames, params=params, cfg=cfg, on_frame=on_frame, device=args.device)


def cmd_bench_report(args):
    """Per-phase step timing table on a dense box, the CLI face of the
    reference's per-kernel ScopedTimerGPU printouts
    (``reference/src/Cuda/Utils.cuh:246-277``): ``utils/phase_profile``."""
    from hnanosolver_tpu_torch.core.topology import build_topology_dense
    from hnanosolver_tpu_torch.fields import zeros_state
    from hnanosolver_tpu_torch.models.plume import PlumeConfig, plume_step
    from hnanosolver_tpu_torch.utils.phase_profile import markdown_table, profile

    params = _params(args)
    n = max(args.size - args.size % 8, 8)
    topo = build_topology_dense((n, n, n), device=args.device)
    cfg = PlumeConfig(center=(n / 2.0, n / 8.0, n / 2.0), radius=n / 8.0)
    state = zeros_state(topo)
    for _ in range(max(args.frames, 1)):
        state = plume_step(topo, state, params, cfg)
    times = profile(topo, state, params, hi=args.chain)
    print(markdown_table(times, topo.num_voxels))


def cmd_turntable(args):
    """Orbit renders of a checkpointed state (a PNG sequence and an APNG),
    the offline face of HNanoViewer's camera."""
    from hnanosolver_tpu_torch.io.state import load_npz
    from hnanosolver_tpu_torch.viewer.render import render_turntable, write_apng, write_png

    topo, state, _, _ = load_npz(args.ckpt, device=args.device)
    os.makedirs(args.out, exist_ok=True)
    frames = render_turntable(topo, state, tuple(args.view_box), frames=args.frames,
                              size=(args.size, args.size))
    for i, img in enumerate(frames):
        write_png(os.path.join(args.out, f"turn_{i:03d}.png"), img)
    write_apng(os.path.join(args.out, "turntable.apng"), frames, delay_ms=args.delay_ms)
    print(f"wrote {len(frames)} orbit frames + turntable.apng to {args.out}")


def cmd_view(args):
    """The interactive WebGL raymarch viewer (HNanoViewer,
    ``reference/HNanoViewer/src/HNanoViewer.cpp:106-362``) over HTTP, of a
    file or a live simulation on ``--device``."""
    from hnanosolver_tpu_torch.viewer import webapp

    if args.live:
        src = webapp.live_source(args.live, shape=tuple(args.view_box), params=_params(args),
                                 device=args.device)
    else:
        if not args.file:
            raise SystemExit("view: pass a volume file or --live plume|fire")
        src = webapp.file_source(args.file, device=args.device)
    webapp.serve(src, port=args.port)


def _load_vdb_fields(path, device):
    """Load a .vdb into (topo over the UNION of all grids' leaf sets,
    scalars {name: [T,512]}, velocity [3,T,512] or None, voxel_size) on
    ``device`` — the standalone operator nodes' input contract (each
    reference node unions its input topologies, e.g. SOP_VDBAdvect.cpp:105-110)."""
    import numpy as np
    import torch

    from hnanosolver_tpu_torch.core.topology import build_topology, lookup_tiles
    from hnanosolver_tpu_torch.io.vdb import read_vdb

    grids = read_vdb(path)
    if not grids:
        raise SystemExit(f"{path}: no grids")
    all_tiles = np.unique(np.concatenate([g["origins"] // 8 for g in grids]), axis=0)
    topo = build_topology(all_tiles, device=device)
    scalars, vel = {}, None
    vs = grids[0]["voxel_size"]
    for g in grids:
        rows = lookup_tiles(topo, g["origins"] // 8).cpu().numpy()
        if g["values"].ndim == 3:
            out = np.zeros((3, topo.capacity, 512), np.float32)
            out[:, rows] = g["values"]
            out[:, 0] = 0
            vel = torch.from_numpy(out).to(topo.device)
        else:
            out = np.zeros((topo.capacity, 512), np.float32)
            out[rows] = g["values"]
            out[0] = 0
            scalars[g["name"]] = torch.from_numpy(out).to(topo.device)
    return topo, scalars, vel, vs


def _write_vdb_fields(path, topo, scalars, vel, voxel_size, compress=False, extra_grids=()):
    """The active rows of each field, moved to the host once, as one .vdb;
    ``extra_grids`` (read_vdb dicts) keep their own leaf sets."""
    import numpy as np

    from hnanosolver_tpu_torch.io.vdb import VdbGrid, write_vdb

    n = int(topo.n_active)
    origins = (topo.origins[1 : n + 1].cpu().numpy() * 8).astype(np.int32)
    grids = []
    if vel is not None:
        grids.append(VdbGrid("velocity", origins, vel[:, 1 : n + 1].cpu().numpy(),
                             voxel_size, grid_class="staggered"))
    for name in sorted(scalars):
        grids.append(VdbGrid(
            name, origins, scalars[name][1 : n + 1].cpu().numpy(), voxel_size,
            grid_class="fog volume" if name == "density" else "unknown",
        ))
    for g in extra_grids:
        grids.append(VdbGrid(g["name"], np.asarray(g["origins"], np.int32), g["values"],
                             g["voxel_size"], grid_class=g.get("grid_class", "unknown")))
    write_vdb(path, grids, compress=compress)
    print(f"wrote {path} ({len(grids)} grids, {n} leaves)")


def cmd_advect(args):
    """HNanoAdvect: BFECC-advect every float grid in the input by its
    velocity grid (`reference/src/SOP/Advection/SOP_VDBAdvect.cpp`)."""
    from hnanosolver_tpu_torch.solver import advect_scalars

    topo, scalars, vel, vs = _load_vdb_fields(args.file, args.device)
    if vel is None:
        raise SystemExit("advect: input has no velocity (Vec3) grid")
    if not scalars:
        raise SystemExit("advect: input has no float grids to advect")
    out = advect_scalars(topo, vel, scalars, args.timestep, vs)
    _write_vdb_fields(args.out, topo, dict(out), vel, vs)


def cmd_advect_velocity(args):
    """HNanoAdvectVelocity: BFECC self-advection of the velocity grid
    (`reference/src/SOP/VelocityAdvection/SOP_VDBAdvectVelocity.cpp`)."""
    from hnanosolver_tpu_torch.solver import advect_velocity

    topo, _scalars, vel, vs = _load_vdb_fields(args.file, args.device)
    if vel is None:
        raise SystemExit("advect-velocity: input has no velocity (Vec3) grid")
    out = advect_velocity(topo, vel, args.timestep, vs)
    _write_vdb_fields(args.out, topo, {}, out, vs)


def cmd_project(args):
    """HNanoProjectNonDivergent: pressure-project the velocity grid, or
    output its raw divergence with --outdiv
    (`reference/src/SOP/ProjectNonDivergent/SOP_VDBProjectNonDivergent.cpp`)."""
    from hnanosolver_tpu_torch.solver import divergence_only, project

    topo, _scalars, vel, vs = _load_vdb_fields(args.file, args.device)
    if vel is None:
        raise SystemExit("project: input has no velocity (Vec3) grid")
    if args.outdiv:
        div = divergence_only(topo, vel, vs)
        _write_vdb_fields(args.out, topo, {"divergence": div}, None, vs)
    else:
        out = project(topo, vel, args.iterations, vs)
        _write_vdb_fields(args.out, topo, {}, out, vs)


def cmd_solve(args):
    """HNanoSolver: the full solver cook on user VDB data — feedback state
    (input 0), compSum sourcing (input 1), collision SDF (input 2)
    (`reference/src/SOP/HNanoSolver/SOP_HNanoSolver.cpp:105-199`).
    The feedback may be a ``.vdb`` or an ``.npz`` checkpoint (exact resume).
    """
    from hnanosolver_tpu_torch.fields import COLLISION_FIELD
    from hnanosolver_tpu_torch.io.state import load_npz, save_npz
    from hnanosolver_tpu_torch.models.solve import load_inputs, run_solve
    from hnanosolver_tpu_torch.utils.interrupt import Interrupter

    params = _params(args)
    if args.pressure_solver:
        params = dataclasses.replace(params, pressure_solver=args.pressure_solver,
                                     mg_levels=args.mg_levels)
    resume = args.feedback.endswith(".npz")
    inp = load_inputs(None if resume else args.feedback, args.source, args.collision)
    if inp.velocity is not None:
        # the reference reads voxelSize off the primary velocity grid
        # (SOP_HNanoSolver.cpp:186)
        params = dataclasses.replace(params, voxel_size=inp.voxel_size)
    topo = state = None
    frame0 = 0
    if resume:
        topo, state, ck_params, frame0 = load_npz(args.feedback, device=args.device)
        if inp.velocity is None and ck_params is not None:
            inp.voxel_size = ck_params.voxel_size
    out_dir = os.path.dirname(args.out) or "."
    os.makedirs(out_dir, exist_ok=True)

    def on_frame(f, topo, state):
        if args.ckpt_every and (f + 1) % args.ckpt_every == 0:
            save_npz(os.path.join(out_dir, f"solve_{frame0 + f + 1:04d}.npz"),
                     topo, state, params, frame=frame0 + f + 1)
        print(f"frame {frame0 + f + 1}/{frame0 + args.frames}: "
              f"{int(topo.n_active)} tiles ({topo.num_voxels / 1e6:.2f} M voxels)",
              flush=True)

    with Interrupter() as intr:
        topo, state = run_solve(
            inp, params, args.frames, padding=args.padding, topo=topo, state=state,
            strict=args.strict, on_frame=on_frame, interrupter=intr, device=args.device)
    # write back every field; the collision SDF keeps its input grid name
    # and is NOT zeroed (the reference zeroes it — HNanoSolver.cu:364-369,
    # a bug not reproduced)
    scalars = dict(state.scalars)
    sdf = scalars.pop(COLLISION_FIELD, None)
    if sdf is not None and inp.sdf is not None:
        scalars[inp.sdf["name"]] = sdf
    _write_vdb_fields(args.out, topo, scalars, state.velocity,
                      inp.voxel_size or params.voxel_size, extra_grids=inp.extra_vecs)


def cmd_resume(args):
    from hnanosolver_tpu_torch.core.activation import expand_for_state
    from hnanosolver_tpu_torch.io.state import load_npz, save_npz
    from hnanosolver_tpu_torch.models.plume import PlumeConfig, plume_step

    topo, state, params, frame0 = load_npz(args.ckpt, device=args.device)
    if params is None:
        params = _params(args)
    cfg = PlumeConfig(center=tuple(args.center), radius=args.radius)
    out = args.out or os.path.dirname(args.ckpt) or "."
    for f in range(frame0, frame0 + args.frames):
        state = plume_step(topo, state, params, cfg)
        topo, state = expand_for_state(topo, state)
        print(f"frame {f + 1}: {int(topo.n_active)} tiles", flush=True)
    save_npz(os.path.join(out, f"frame_{frame0 + args.frames:04d}.npz"),
             topo, state, params, frame=frame0 + args.frames)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="hnanosolver_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("plume", help="run the rising-plume scenario")
    _add_solver_args(p)
    p.add_argument("--frames", type=int, default=24)
    p.add_argument("--center", type=float, nargs=3, default=[64.0, 16.0, 64.0])
    p.add_argument("--radius", type=float, default=12.0)
    _add_output_args(p)
    p.set_defaults(fn=cmd_plume)

    p = sub.add_parser("collide",
                       help="plume + moving solid (animated SDF re-evaluated per frame)")
    _add_solver_args(p)
    p.add_argument("--frames", type=int, default=24)
    p.add_argument("--center", type=float, nargs=3, default=[64.0, 16.0, 64.0])
    p.add_argument("--radius", type=float, default=12.0)
    p.add_argument("--collider-center", type=float, nargs=3, default=[40.0, 56.0, 64.0])
    p.add_argument("--collider-velocity", type=float, nargs=3, default=[48.0, 0.0, 0.0],
                   help="voxels/second")
    p.add_argument("--collider-radius", type=float, default=14.0)
    _add_output_args(p)
    p.set_defaults(fn=cmd_collide)

    p = sub.add_parser("fire", help="run the fire/combustion scenario")
    _add_solver_args(p)
    p.add_argument("--frames", type=int, default=24)
    p.add_argument("--center", type=float, nargs=3, default=[64.0, 8.0, 64.0])
    p.add_argument("--radius", type=float, default=14.0)
    _add_output_args(p)
    p.set_defaults(fn=cmd_fire)

    p = sub.add_parser("bench-report", help="per-phase step timing table (dense box domain)")
    _add_solver_args(p)
    p.add_argument("--frames", type=int, default=2, help="warm-up steps")
    p.add_argument("--size", type=int, default=64, help="domain edge (voxels)")
    p.add_argument("--chain", type=int, default=10, help="long-chain length")
    p.set_defaults(fn=cmd_bench_report)

    p = sub.add_parser("turntable", help="orbit renders of a checkpoint (PNG seq + APNG)")
    p.add_argument("--ckpt", required=True)
    p.add_argument("--frames", type=int, default=24)
    p.add_argument("--size", type=int, default=384)
    p.add_argument("--delay-ms", type=int, default=50)
    p.add_argument("--view-box", type=int, nargs=3, default=[128, 128, 128])
    p.add_argument("--out", default="out/turntable")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_turntable)

    p = sub.add_parser("advect", help="standalone scalar advection on a .vdb (HNanoAdvect)")
    p.add_argument("file", help=".vdb with float grids + a velocity grid")
    p.add_argument("--timestep", type=float, default=1.0 / 24.0)
    p.add_argument("--out", default="advected.vdb")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_advect)

    p = sub.add_parser(
        "advect-velocity",
        help="standalone velocity self-advection on a .vdb (HNanoAdvectVelocity)")
    p.add_argument("file", help=".vdb with a velocity grid")
    p.add_argument("--timestep", type=float, default=1.0 / 24.0)
    p.add_argument("--out", default="advected_velocity.vdb")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_advect_velocity)

    p = sub.add_parser(
        "project", help="pressure-project a .vdb velocity grid (HNanoProjectNonDivergent)")
    p.add_argument("file", help=".vdb with a velocity grid")
    p.add_argument("--iterations", type=int, default=20)
    p.add_argument("--outdiv", action="store_true",
                   help="output the raw divergence instead of projecting")
    p.add_argument("--out", default="projected.vdb")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_project)

    p = sub.add_parser(
        "solve",
        help="full solver cook on user VDB data (HNanoSolver: feedback + "
             "compSum sourcing + collision SDF)")
    _add_solver_args(p)
    p.add_argument("feedback",
                   help="feedback .vdb (simulation state: float grids + a "
                        "velocity grid) or .npz checkpoint (exact resume)")
    p.add_argument("--source", default=None,
                   help="sourcing .vdb, composited additively each frame "
                        "(openvdb::tools::compSum)")
    p.add_argument("--collision", default=None,
                   help="collision .vdb; its first float grid is the solid SDF")
    p.add_argument("--frames", type=int, default=1)
    p.add_argument("--pressure-solver", choices=["rbgs", "mg"], default=None)
    p.add_argument("--mg-levels", type=int, default=2)
    p.add_argument("--strict", action="store_true",
                   help="error on missing combustion fields like the "
                        "reference (default: create them as zeros)")
    p.add_argument("--ckpt-every", type=int, default=0)
    p.add_argument("--out", default="solved.vdb")
    p.set_defaults(fn=cmd_solve)

    p = sub.add_parser("view", help="interactive WebGL volume viewer (file or live sim)")
    _add_solver_args(p)
    p.add_argument("file", nargs="?", default=None, help=".npz checkpoint, .nvdb or .vdb volume")
    p.add_argument("--live", choices=["plume", "fire"], default=None,
                   help="serve a live stepped simulation instead of a file")
    p.add_argument("--port", type=int, default=8642)
    p.add_argument("--view-box", type=int, nargs=3, default=[256, 256, 256])
    p.set_defaults(fn=cmd_view)

    p = sub.add_parser("resume", help="resume the plume scenario from an .npz checkpoint")
    _add_solver_args(p)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--frames", type=int, default=24)
    p.add_argument("--center", type=float, nargs=3, default=[64.0, 16.0, 64.0])
    p.add_argument("--radius", type=float, default=12.0)
    p.add_argument("--out", default=None)
    p.set_defaults(fn=cmd_resume)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
