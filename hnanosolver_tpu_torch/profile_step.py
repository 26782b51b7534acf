"""Where the time of one step goes on the card. Run from the repository
root on a machine with one CUDA card:

    python3 -m hnanosolver_tpu_torch.profile_step [CELL ...]

Cells (``cells.CELLS``, default all): ``bench`` (RBGS-50 on the
4196-tile bench plume), ``bench-mg`` (multigrid, mg_levels 2, FMG + 2
V-cycles, same domain), ``c5`` and ``c5-mg`` (BASELINE config 5, the
269,104-tile 1024^3 plume cone, RBGS-50 and multigrid with mg_levels 5),
``c4`` (BASELINE config 4: the bench plume with a moving SDF sphere,
4354 tiles, RBGS-50, one collider step). Each cell's state is developed
first (20 RBGS-50 steps on the bench domain, 4 at config 5, 20 collider
frames at config 4). Per cell it prints:

- host ms/step: median wall time of single steps ending in a synchronise;
- enqueue ms/step: median time for the step call to return, unsynchronised
  (how long the host needs to issue the step's work);
- device ms/step and busy share: the kernels' device time per step from
  ``torch.profiler`` over STEPS steps, over the wall time of that window;
- the kernels with the most device time per step, with launches per step,
  and every other kernel of the port's own (``csrc/``) that ran.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import time

import torch

from hnanosolver_tpu_torch.cells import CELLS, RBGS50
from hnanosolver_tpu_torch.models import collider, plume
from hnanosolver_tpu_torch.ops import multigrid

STEPS = 5  # steps timed on the host clock, then steps profiled
TOP = 15  # kernels listed per cell


def _device_events(prof):
    """(name, device us, count) per kernel from a profiler's averages."""
    out = []
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        out.append((e.key, float(us), int(e.count)))
    return sorted(out, key=lambda x: -x[1])


def profile_cell(name: str) -> None:
    cell = CELLS[name]
    params, cfg, col = cell.params, cell.plume, cell.collider
    if col is None:
        topo, state = plume.run_plume(cell.develop, RBGS50, cfg, topo=cell.topology(),
                                      grow_every=0)
        hier = multigrid.hierarchy_for(topo, params)

        def step():
            return plume.plume_step(topo, state, params, cfg, hier)
    else:
        topo, state = collider.run_collider(cell.develop, params, cfg, col,
                                            topo=cell.topology(), grow_every=0)

        def step():
            return collider.collider_step(topo, state, params, cfg, col, cell.develop)

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    host, enqueue = [], []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        step()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        enqueue.append((t1 - t0) * 1e3)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / STEPS
    ev = _device_events(prof)
    dev_ms = sum(us for _, us, _ in ev) / 1e3 / STEPS
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(f"[{name}] {topo.n_active} tiles, capacity {topo.capacity}, {params.pressure_solver}"
          f" | host {statistics.median(host):.3f} ms/step (median of {STEPS}), enqueue "
          f"{statistics.median(enqueue):.3f} ms/step | profiled: wall {wall:.3f} ms/step, "
          f"device {dev_ms:.3f} ms/step, busy share {dev_ms / wall:.3f}, "
          f"{sum(c for _, _, c in ev) / STEPS:.0f} kernels/step | {card}", flush=True)
    # the TOP kernels with the most device time, then every other kernel of
    # the port's own (csrc/, namespace hn) that ran, so each has its line
    for i, (key, us, count) in enumerate(ev):
        if i < TOP or "hn::" in key:
            print(f"[{name}]   {us / STEPS:9.1f} us/step  x{count / STEPS:6.1f}  {key[:110]}")


def main() -> None:
    names = sys.argv[1:] or list(CELLS)
    unknown = sorted(set(names) - set(CELLS))
    if unknown:
        raise SystemExit(f"unknown cells {unknown}; the cells are {', '.join(CELLS)}")
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA card")
    for name in names:
        profile_cell(name)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
