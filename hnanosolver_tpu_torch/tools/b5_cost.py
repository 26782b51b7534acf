"""What a B5 solve (``csrc/rbsor_fused.cu``) costs on the card, part by part:
the time of a half-sweep and of a launch in each of its two forms, and the
barriers each form is built on, alone.

- Each form on the multigrid levels B5 solves on the main paths: the bench
  plume's coarse levels at capacities 1024, 128 and 32 (levels 1-3 of its
  hierarchy, with their in-domain masks, div from the seed times the mask,
  dx = 0.5 * 2^k). A solve of n iterations takes t(n) = launch + 2n *
  half-sweep; both come from n = 2 and n = 24 (the smoother's and the
  coarsest solve's counts): half-sweep = (t(24) - t(2)) / 44, launch =
  t(2) - 4 * half-sweep.
- The empty barriers (``csrc/barrier_probe.cu``): n grid barriers of a
  cooperative grid of T 256-thread blocks (the grid form's grid at T <=
  1056), and n cluster barriers of one cluster of C blocks, C = 1, 2, 4, 8,
  16, at 128, 512 and 1024 threads a block (cooperative_groups'
  ``cluster.sync()``, as B5 calls it); one barrier is the slope (t(n1) -
  t(n0)) / (n1 - n0).

- The threshold between the forms: both forms at T = 64 ... 256 rows
  (SWEEP, up to the most the cluster form holds), on bench level 1's tiles (the first T - 1 of them, at capacity
  T, the active rows as the mask), each at 2 and 24 iterations: the
  cluster form beats the grid form at T where both its launches are the
  faster. ``ops/cuda_pressure.CLUSTER_ROWS`` is the largest T of SWEEP
  up to which it beats it at every swept T.

Every form's result is checked bitwise against the plain version first.
The card only: a barrier has no plain version.

Run: python -m hnanosolver_tpu_torch.tools.b5_cost [--rounds N]
"""

from __future__ import annotations

import statistics
from typing import Callable

import numpy as np
import torch

from hnanosolver_tpu_torch.cells import CELLS
from hnanosolver_tpu_torch.core.topology import active_mask, build_topology, resolve_device
from hnanosolver_tpu_torch.kernels import build
from hnanosolver_tpu_torch.ops import cuda_pressure, multigrid
from hnanosolver_tpu_torch.timing import median_ms
from hnanosolver_tpu_torch.tools import SEED, parser

LEVELS = 3  # bench hierarchy levels 1-3: capacities 1024, 128, 32
ITERS = (2, 24)  # iterations of the two timed solves
SYNCS = (0, 2000)  # barriers of the two timed barrier launches
CLUSTERS = (1, 2, 4, 8, 16)
CLUSTER_THREADS = (128, 512, 1024)
GRID_THREADS = 256
SWEEP = (64, 128, 160, 192, 224, 256)  # T of the threshold sweep (to CLUSTER_CAPACITY)


def fit(solve: Callable[[int], object], rounds: int = 5) -> tuple[float, float]:
    """(us a half-sweep, us a launch) of ``solve(iterations)`` from its
    median times at ITERS."""
    n0, n1 = ITERS
    t0, t1 = (median_ms(lambda n=n: solve(n), rounds, 10) for n in ITERS)
    half = (t1 - t0) / (2 * (n1 - n0)) * 1e3
    return half, t0 * 1e3 - 2 * n0 * half


def barrier_us(launch: Callable[[int], int], rounds: int = 5) -> float:
    """us a barrier: the slope of a barrier loop's time over SYNCS."""
    def run(n):
        build.check(launch(n), "barrier loop")
    t0, t1 = (median_ms(lambda n=n: run(n), rounds, 5) for n in SYNCS)
    return (t1 - t0) / (SYNCS[1] - SYNCS[0]) * 1e3


def grid_sync_us(blocks: int, threads: int = GRID_THREADS, rounds: int = 5) -> float:
    lib, s = build.library(), build.stream_ptr(torch.device("cuda"))
    return barrier_us(lambda n: lib.hn_grid_sync_loop(n, blocks, threads, s), rounds)


def cluster_sync_us(cluster: int, threads: int, rounds: int = 5) -> float:
    lib, s = build.library(), build.stream_ptr(torch.device("cuda"))
    return barrier_us(lambda n: lib.hn_cluster_sync_loop(n, cluster, threads, s), rounds)


def levels(dev: torch.device) -> list:
    """(T, nbr, div, mask, dx2) of bench hierarchy levels 1..LEVELS."""
    bench = CELLS["bench"]
    topo = bench.topology(dev)
    rng = np.random.default_rng(SEED)
    out = []
    for k, lv in enumerate(multigrid.build_hierarchy(topo, LEVELS), start=1):
        T = lv.topo.capacity
        div = torch.from_numpy(rng.standard_normal((T, 512)).astype(np.float32)).to(dev)
        dx = bench.params.voxel_size * 2 ** k
        out.append((T, lv.topo.nbr, div * lv.mask, lv.mask, dx * dx))
    return out


def sweep_level(dev: torch.device, T: int):
    """(nbr, div, mask, dx2) at capacity T from bench level 1's tiles."""
    bench = CELLS["bench"]
    lv = multigrid.build_hierarchy(bench.topology(dev), 1)[0].topo
    tiles = lv.origins[1:min(lv.n_active, T - 1) + 1].cpu().numpy()
    topo = build_topology(tiles, capacity=T, device=dev)
    rng = np.random.default_rng(SEED)
    mask = active_mask(topo)[:, None].expand(T, 512).contiguous()
    div = torch.from_numpy(rng.standard_normal((T, 512)).astype(np.float32)).to(dev) * mask
    dx = bench.params.voxel_size * 2
    return topo.nbr, div, mask, dx * dx


def form_solver(form: str, nbr, div, mask, omega: float, dx2: float):
    """``iterations -> p``: one B5 launch in ``form`` at div's T."""
    shape = cuda_pressure.fused_shape(div.shape[0], form)
    p0 = torch.zeros_like(div)
    return lambda n: cuda_pressure._launch_fused(shape, nbr, div, n, omega, dx2, p0, mask)


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type != "cuda":
        raise SystemExit("b5_cost: the card only (barriers have no plain version)")
    card = torch.cuda.get_device_name(dev)
    omega = CELLS["bench"].params.omega
    print(f"b5_cost on {card}: CUDA events, medians of {args.rounds} runs", flush=True)
    for T, nbr, div, mask, dx2 in levels(dev):
        want = cuda_pressure.rbsor_fused_plain(nbr, div, ITERS[1], omega, dx2, mask=mask)
        for form in ("grid", "cluster")[:1 + (T <= cuda_pressure.CLUSTER_CAPACITY)]:
            solve = form_solver(form, nbr, div, mask, omega, dx2)
            if not torch.equal(solve(ITERS[1]), want):
                raise AssertionError(f"B5 {form} form at T={T} differs from its plain version")
            half, launch = fit(solve, args.rounds)
            print(f"B5 {form:7s} T={T:5d} {cuda_pressure.fused_shape(T, form)}: "
                  f"{half:.3f} us a half-sweep, {launch:.3f} us a launch", flush=True)
        blocks = min(T, 1056)
        print(f"grid barrier, {blocks} blocks x {GRID_THREADS} threads: "
              f"{grid_sync_us(blocks, rounds=args.rounds):.3f} us", flush=True)
    for T in SWEEP:
        nbr, div, mask, dx2 = sweep_level(dev, T)
        ms = {}
        for form in ("grid", "cluster"):
            solve = form_solver(form, nbr, div, mask, omega, dx2)
            ms[form] = [median_ms(lambda n=n: solve(n), args.rounds, 10) for n in ITERS]
        wins = all(c < g for c, g in zip(ms["cluster"], ms["grid"]))
        print(f"threshold sweep T={T}: a launch of {ITERS} iterations, grid form "
              + ", ".join(f"{x * 1e3:.3f}" for x in ms["grid"]) + " us, cluster form "
              + ", ".join(f"{x * 1e3:.3f}" for x in ms["cluster"])
              + f" us: the cluster form {'beats' if wins else 'does not beat'} the grid form",
              flush=True)
    for threads in CLUSTER_THREADS:
        us = [cluster_sync_us(c, threads, args.rounds) for c in CLUSTERS]
        print(f"cluster barrier, {threads} threads a block, C = {CLUSTERS}: "
              + ", ".join(f"{u:.3f}" for u in us) + " us", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
