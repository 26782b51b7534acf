"""Run a short plume sim, export Houdini-loadable OpenVDB (plain + ZIP),
then serve the interactive WebGL viewer on the final state.

The workflow a reference (HNanoSolver) user would recognize: simulate ->
write .vdb for the DCC -> inspect interactively (HNanoViewer's role).

Usage:
  python -m hnanosolver_tpu_torch.examples.view_and_export --device cpu   # small demo
  python -m hnanosolver_tpu_torch.examples.view_and_export --frames 48 --size 128
then open http://localhost:8642/.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--size", type=int, default=64, help="view box edge (voxels)")
    ap.add_argument("--out", default="out/view_demo")
    ap.add_argument("--port", type=int, default=8642)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain PyTorch versions)")
    args = ap.parse_args(argv)

    from hnanosolver_tpu_torch.config import SolverParams
    from hnanosolver_tpu_torch.io.vdb import state_to_vdb
    from hnanosolver_tpu_torch.models import plume as P
    from hnanosolver_tpu_torch.viewer import webapp

    s = float(args.size)
    params = SolverParams(iterations=20)
    cfg = P.PlumeConfig(
        center=(s / 2, s / 8, s / 2), radius=s / 10,
        fuel_rate=2.0, temperature_target=300.0,
    )
    topo = P.initial_topology(cfg, device=args.device)
    state = P.initial_state(topo)
    topo, state = P.run_plume(
        args.frames, params=params, cfg=cfg, topo=topo, state=state,
        on_frame=lambda f, t, st: print(
            f"frame {f + 1}/{args.frames}: {int(t.n_active)} tiles", flush=True
        ),
    )

    os.makedirs(args.out, exist_ok=True)
    plain = os.path.join(args.out, "final.vdb")
    zipped = os.path.join(args.out, "final_zip.vdb")
    state_to_vdb(plain, topo, state, voxel_size=params.voxel_size)
    state_to_vdb(zipped, topo, state, voxel_size=params.voxel_size, compress=True)
    print(f"wrote {plain} ({os.path.getsize(plain)} B) and "
          f"{zipped} ({os.path.getsize(zipped)} B, ZIP)")

    src = webapp.state_source(topo, state, (args.size, args.size, args.size))
    webapp.serve(src, port=args.port)


if __name__ == "__main__":
    main()
