#!/usr/bin/env python3
"""Run one cell of the benchmark once, from the root of a checkout, on the
machine's CUDA card:

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

It sets up, steps the cell's frames for S seconds, checks the last frame and
the first against the plain reference, and prints one JSON line last on
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number compared beside its limit (also the last lines on standard error).
Without a CUDA card, or with fewer cards than the cell asks for, it prints
no result and exits with 2; if a module of JAX or of the JAX package is
loaded, with 3.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# every cache of the program and its libraries at a fixed place in the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "benchmark_cache" / sub)

import guard  # noqa: E402


def card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi not available"
    return out.strip().splitlines()[0] if out.strip() else "nvidia-smi printed nothing"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    guard.check("start")

    import torch

    import spec

    cell = spec.load(args.workload, ROOT / "BENCHMARK.json")
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA card(s); this machine has {n}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))  # the program under test
    import harness

    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    print(f"card: {card()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
