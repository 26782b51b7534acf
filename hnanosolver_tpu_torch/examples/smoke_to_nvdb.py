"""End-to-end example: simulate a rising smoke plume, export NanoVDB grids
(readable by Houdini 19.5+/Blender via nanovdb, convertible to .vdb with
nanovdb_convert), and render a preview PNG.

    python -m hnanosolver_tpu_torch.examples.smoke_to_nvdb --frames 24 --out out_demo
"""

import argparse
import os

from hnanosolver_tpu_torch.config import SolverParams
from hnanosolver_tpu_torch.io.nvdb import write_state_nvdb
from hnanosolver_tpu_torch.models.plume import PlumeConfig, run_plume
from hnanosolver_tpu_torch.viewer.render import render_state, write_png


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--out", default="out_demo")
    ap.add_argument("--export-every", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain PyTorch versions)")
    args = ap.parse_args(argv)

    params = SolverParams(dt=1 / 24, voxel_size=0.5, iterations=24)
    cfg = PlumeConfig(center=(64.0, 16.0, 64.0), radius=12.0, velocity_jet=6.0)
    os.makedirs(args.out, exist_ok=True)

    def on_frame(f, topo, state):
        if (f + 1) % args.export_every == 0:
            paths = write_state_nvdb(
                args.out, topo, state,
                voxel_size=params.voxel_size, frame=f + 1,
                fields=("density", "temperature"),
            )
            img = render_state(topo, state, (128, 128, 128))
            write_png(os.path.join(args.out, f"preview_{f + 1:04d}.png"),
                      img.transpose(1, 0, 2)[::-1])
            print(f"frame {f + 1}: exported {len(paths)} grids, "
                  f"{int(topo.n_active)} tiles")

    run_plume(args.frames, params=params, cfg=cfg, on_frame=on_frame, device=args.device)


if __name__ == "__main__":
    main()
