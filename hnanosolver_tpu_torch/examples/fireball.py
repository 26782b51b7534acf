"""End-to-end example: oxygen-limited combustion fireball with vorticity
confinement, checkpointed and rendered.

    python -m hnanosolver_tpu_torch.examples.fireball --frames 36 --out out_fire
"""

import argparse
import os

from hnanosolver_tpu_torch.io.state import save_npz
from hnanosolver_tpu_torch.models.fire import FireConfig, default_params, run_fire
from hnanosolver_tpu_torch.viewer.render import render_state, write_png


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=36)
    ap.add_argument("--out", default="out_fire")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain PyTorch versions)")
    args = ap.parse_args(argv)

    params = default_params()
    cfg = FireConfig(center=(64.0, 8.0, 64.0), radius=14.0)
    os.makedirs(args.out, exist_ok=True)

    def on_frame(f, topo, state):
        if (f + 1) % 12 == 0:
            save_npz(os.path.join(args.out, f"fire_{f + 1:04d}.npz"),
                     topo, state, params, frame=f + 1)
            img = render_state(topo, state, (128, 128, 128))
            write_png(os.path.join(args.out, f"fire_{f + 1:04d}.png"),
                      img.transpose(1, 0, 2)[::-1])
            print(f"frame {f + 1}: {int(topo.n_active)} tiles")

    run_fire(args.frames, params=params, cfg=cfg, on_frame=on_frame, device=args.device)


if __name__ == "__main__":
    main()
