#!/usr/bin/env python3
"""The readings the output check's limits are set from, for one cell, in
one process (the topology is built once):

    python3 benchmark/calibrate.py --workload NAME [--seeds 12] [--control-seeds 3]
        [--seconds S] [--frames K] [--first-seed N] [--out FILE]

- the program: ``--seeds`` runs of the cell's window, each with its own
  seed and every number the check compares, the windows from half to one
  and a half times ``--seconds`` (short: a run compares its last frame and
  its first; give about a cook's length, so that the last frames fall at
  every place in a cook);
- the control: the scene's plain reference computed in bfloat16 (the
  precision below the configuration's float32) in the program's place, on
  ``--control-seeds`` other seeds: its first frame from the seeded start
  and the last of ``--frames`` frames from it, each against the reference
  in float64, as the check compares the program's.

A limit lies between the program's largest reading and the control's
smallest. Prints one JSON line (also written to ``--out``). Needs the card,
as a run does; the benchmark's runs never call this.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import torch  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

import compare  # noqa: E402
import inputs  # noqa: E402
import spec  # noqa: E402
from reference import step  # noqa: E402
from reference import topology as rt  # noqa: E402

CONTROL_DTYPE = torch.bfloat16


def control_frame(cell, topo, fields: dict, levels, index: int):
    """The control's frame ``index`` of its cook: the scene's reference in
    CONTROL_DTYPE from float32 fields; returns (topo, float32 fields), grown
    where the cell grows."""
    scene = cell.scene
    out = scene.frame(cell, topo, {k: v.to(CONTROL_DTYPE) for k, v in fields.items()}, levels,
                      index)
    if cell.traffic["topology"] == "grow":
        topo, out = scene.grow(cell, topo, out, index)
    return topo, {k: v.float() for k, v in out.items()}


def control_readings(cell, prep, seed: int, frames: int, dev) -> dict:
    """The control's numbers on ``seed``: its first frame from the seeded
    start, and the last of ``frames`` chained frames of one cook from its
    own input."""
    sp = cell.solver()
    topo = rt.with_index(prep.rows, dev)
    start = inputs.start_fields(cell, prep.rows, seed, dev)
    levels = step.levels_for(topo, sp, CONTROL_DTYPE)
    cur_t, cur = control_frame(cell, topo, start, levels, 0)
    gap0, off0, _ = compare.check_frame(cell, topo, compare.to64(start, dev), cur_t.keys, cur, 0)
    for index in range(1, frames):
        prev_t, prev = cur_t, cur
        if prev_t is not topo:
            topo, levels = prev_t, step.levels_for(prev_t, sp, CONTROL_DTYPE)
        cur_t, cur = control_frame(cell, prev_t, prev, levels, index)
    gap, off, _ = compare.check_frame(cell, prev_t, compare.to64(prev, dev), cur_t.keys, cur,
                                      index)
    found = {"start_gap": gap0, "start_tiles_off": off0, "last_gap": gap, "last_tiles_off": off}
    return {k: v for k, v in found.items() if v is not None}


def readings(cell, dev, seeds: int, control_seeds: int, seconds: float, frames: int,
             first_seed: int) -> dict:
    """Every reading of the program and of the control, with the program's
    largest and the control's smallest of each number."""
    import harness

    prep = harness.prepare(cell, dev)
    program, control = {}, {}
    for i in range(seeds):
        seed = first_seed + 7919 * i
        t = time.perf_counter()
        # windows from half to one and a half times ``seconds``, so that the
        # last frames fall at every place in a cook
        res = harness.run_prepared(cell, prep, seed, seconds * (0.5 + i / max(seeds, 1)), False,
                                   dev, harness.Clock(time.perf_counter()))
        program[seed] = {k: v["value"] for k, v in res["checks"].items()}
        print(f"program seed {seed}: {program[seed]} ({res['attempted']} frames, "
              f"{time.perf_counter() - t:.1f} s)", file=sys.stderr, flush=True)
    for i in range(control_seeds):
        seed = first_seed + 104729 * (i + 1) + 1
        t = time.perf_counter()
        control[seed] = control_readings(cell, prep, seed, frames, dev)
        print(f"control seed {seed}: {control[seed]} ({time.perf_counter() - t:.1f} s)",
              file=sys.stderr, flush=True)
    names = sorted({k for r in list(program.values()) + list(control.values()) for k in r})
    summary = {k: {"program_max": max((r[k] for r in program.values() if k in r), default=None),
                   "control_min": min((r[k] for r in control.values() if k in r), default=None)}
               for k in names}
    return {"workload": cell.name, "summary": summary, "program": program, "control": control}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    dev = torch.device("cuda")
    cell = spec.load(args.workload, ROOT / "BENCHMARK.json")
    out = readings(cell, dev, args.seeds, args.control_seeds, args.seconds, args.frames,
                   args.first_seed)
    out.update(device=torch.cuda.get_device_name(dev), seconds=time.perf_counter() - T0)
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
