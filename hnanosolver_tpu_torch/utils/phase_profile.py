"""Per-phase step profiling, the JAX package's ``utils/phase_profile.py``
on PyTorch: the chain-slope method.

The reference times every kernel per cook with cudaEvents and a
bytes/voxel bandwidth model (``reference/src/Cuda/Utils.cuh:246-277``).
Here each phase of the step is timed as the slope between a short and a
long chain of that phase alone (``utils/timers.chain_slope``: CUDA events
on the card, the host clock on the CPU), the best of several runs each.
Each phase body feeds its output into its input, so the chained
applications carry a real data dependence.

The phases, their names and their order are the JAX package's. Its
precision tier (``params.precision``) maps to a sampler tier there
("parity" -> "strict", "balanced", "fast"); the port samples in float32 at
every tier, so the tier changes no body here. As in the JAX package, the
pressure phase calls ``solve_pressure`` at its default halo lag of 1.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from hnanosolver_tpu_torch.utils.timers import chain_slope


def time_chained(fn: Callable, x0, lo: int = 2, hi: int = 10, repeats: int = 4) -> float:
    """Seconds per application of ``fn`` (a map from a tensor tree to a like
    tree) by the chain-slope estimator."""
    return chain_slope(fn, x0, lo, hi, repeats)


def phase_functions(topo, state, params) -> List[Tuple[str, Callable, object]]:
    """(name, body, x0) per pipeline phase, each self-chaining."""
    from hnanosolver_tpu_torch.fields import COLLISION_FIELD
    from hnanosolver_tpu_torch.ops import advection as adv
    from hnanosolver_tpu_torch.ops import combustion as comb
    from hnanosolver_tpu_torch.ops import pressure as prs
    from hnanosolver_tpu_torch.ops import stencil as stn

    inv_dx = params.inv_voxel_size
    dt = params.dt
    c = params.combustion
    vel = state.velocity
    scal = {k: v for k, v in state.scalars.items() if k != COLLISION_FIELD}
    div0 = stn.divergence(topo, vel, inv_dx)

    def combustion(args):
        f, w, t, fl, d = comb.combustion_oxygen(
            args[0], args[1], args[2], args[3], args[4], c.temperature_release,
            c.expansion_rate)
        t = comb.temperature_buoyancy(torch.stack([t, t, t]), t, dt, c.ambient_temp,
                                      c.buoyancy_strength)[1]
        return f, w, t, fl, d

    names = sorted(scal)

    def adv_scal(s):
        outs = adv.advect_scalars_fused(topo, vel, {k: s[i] for i, k in enumerate(names)}, dt,
                                        inv_dx, None)
        return torch.stack([outs[k] for k in names])

    return [
        ("advect_velocity (BFECC)",
         lambda v: adv.advect_velocity(topo, v, dt, inv_dx, None), vel),
        ("vorticity_confinement",
         lambda v: stn.vorticity_confinement(topo, v, dt, inv_dx, max(c.vorticity_scale, 0.1),
                                             c.factor_scale), vel),
        ("divergence", lambda v: v + 1e-9 * stn.divergence(topo, v, inv_dx)[None], vel),
        ("combustion+buoyancy", combustion,
         (scal["fuel"], scal["waste"], scal["temperature"], scal["flame"], div0)),
        (f"pressure ({params.iterations} RBGS iters)",
         lambda d: 1e-9 * d + prs.solve_pressure(topo, d, params.iterations, params.voxel_size,
                                                 params.omega), div0),
        ("subtract_pressure_gradient",
         lambda v: stn.subtract_pressure_gradient(topo, v, div0, inv_dx), vel),
        (f"advect_scalars ({len(names)} fields, fused)", adv_scal,
         torch.stack([scal[k] for k in names])),
    ]


def profile(topo, state, params, lo: int = 2, hi: int = 10, repeats: int = 4
            ) -> Dict[str, float]:
    """{phase name: seconds} for each pipeline phase, plus "FULL STEP"
    (``solver.step``)."""
    from hnanosolver_tpu_torch.solver import step

    out: Dict[str, float] = {}
    for name, fn, x0 in phase_functions(topo, state, params):
        out[name] = time_chained(fn, x0, lo, hi, repeats)
    out["FULL STEP"] = time_chained(lambda s: step(topo, s, params), state, lo, hi, repeats)
    return out


def markdown_table(times: Dict[str, float], voxels: int) -> str:
    total = times.get("FULL STEP", sum(times.values()))
    lines = [
        "| phase | ms | % of step | Mvox/s |",
        "|---|---|---|---|",
    ]
    for name, t in times.items():
        lines.append(
            f"| {name} | {t * 1e3:.2f} | {100 * t / total:.1f}% "
            f"| {voxels / t / 1e6:.1f} |"
        )
    return "\n".join(lines)
