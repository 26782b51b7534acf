"""Whether the sparse step's stages give the same answer twice in one
process: each stage is a pure function, so two runs on identical inputs
must agree bitwise.

The inputs are ``tools/dense_spread``'s case (the parity test's fields on
an n^3 box, config 3's confinement at the parity test's parameters). The
stages run twice, in order: the velocity advection, the curl, the six
offset curl magnitudes of the confinement's gradient, the confinement, the
divergence and the pressure solve. Every stage whose two outputs differ is
printed with the count of differing values, the largest difference and
where it lies; the last line is one JSON object ``{"n", "threads",
"differing": {stage: count}}``.

``--narrow R`` instead advects once and repeats only the first offset
magnitude (``cuda_vorticity.curl_mag_at_offset`` at (1, 0, 0)) R times on that
one velocity, keeping every intermediate: its 12 ``offset_view`` gathers,
the ``wx``, ``wy`` and ``wz`` terms, the sum of squares and the ``sqrt``.
Each repeat is held to the first; the first repeat's outputs are also
cloned as they are made and compared again after the last repeat, which
tells a wrong computation from a later overwrite. For each repeat that
differs it prints the first intermediate that does, the flat index range
of its differing values and which of the ``threads`` equal chunks of that
range hold them (torch's parallel loop gives each thread one chunk); the
last line is one JSON object ``{"n", "threads", "repeats", "differing":
{repeat: intermediate}, "odd_first", "stored_changed", ...}``.

Run: python -m hnanosolver_tpu_torch.tools.repeat_check [--n 128] [--seed 0]
     [--narrow R] [--device cpu|cuda]
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from hnanosolver_tpu_torch.core.topology import build_topology_dense, resolve_device
from hnanosolver_tpu_torch.ops import advection, cuda_vorticity, stencil
from hnanosolver_tpu_torch.ops import pressure as prs
from hnanosolver_tpu_torch.ops.shifts import offset_view
from hnanosolver_tpu_torch.tools import dense_spread as spread
from hnanosolver_tpu_torch.tools import parser

NARROW_OFFSET = (1, 0, 0)  # the first offset magnitude the confinement takes


def inputs(n: int, seed: int, dev: torch.device):
    """(topology, state, params) of the case (module doc)."""
    p = spread.params_with_vorticity()
    topo = build_topology_dense((n,) * 3, device=dev)
    vel_np, rho_np = spread.smooth_box(n, seed)
    state = spread.to_tiles(topo, spread.scaled(torch.from_numpy(vel_np).to(dev), p),
                            spread.dense_scalars(torch.from_numpy(rho_np).to(dev)))
    return topo, state, p


def stages(topo, state, p) -> dict:
    """Every stage's output, each from the one before (module doc)."""
    c, f = p.combustion, 0.5 * p.inv_voxel_size
    out = {"advect": advection.advect_velocity(topo, state.velocity, p.dt, p.inv_voxel_size)}
    u = out["advect"]
    out["curl"] = stencil.curl(topo, u, f)
    for ax in range(3):
        for sign in (1, -1):
            off = [0, 0, 0]
            off[ax] = sign
            mag = cuda_vorticity.curl_mag_at_offset(topo, u, off, f)
            out[f"curl magnitude at {tuple(off)}"] = mag
    out["confinement"] = stencil.vorticity_confinement(topo, u, p.dt, p.inv_voxel_size,
                                                       c.vorticity_scale, c.factor_scale)
    out["divergence"] = stencil.divergence(topo, out["confinement"], p.inv_voxel_size)
    out["pressure"] = prs.solve_pressure(topo, out["divergence"], p.iterations, p.voxel_size,
                                         p.omega, halo_lag=1)
    return out


def curl_mag_parts(topo, vel: torch.Tensor, off, factor: float,
                   held: Optional[dict] = None) -> dict:
    """``cuda_vorticity.curl_mag_at_offset(topo, vel, off, factor)`` in its op
    order with every intermediate kept, in the order it makes them: the
    gathers ``g0``-``g3``, ``wx``, ``g4``-``g7``, ``wy``, ``g8``-``g11``,
    ``wz``, ``sum of squares`` and ``sqrt`` (bitwise its result). ``held``
    gets a clone of each as soon as it is made."""
    parts = {}

    def keep(name, t):
        parts[name] = t
        if held is not None:
            held[name] = t.clone()
        return t

    def v(c, o):
        return keep(f"g{sum(k.startswith('g') for k in parts)}",
                    offset_view(topo, vel[c], (off[0] + o[0], off[1] + o[1], off[2] + o[2])))

    wx = keep("wx", ((v(2, (0, 1, 0)) - v(2, (0, -1, 0)))
                     - (v(1, (0, 0, 1)) - v(1, (0, 0, -1)))) * factor)
    wy = keep("wy", ((v(0, (0, 0, 1)) - v(0, (0, 0, -1)))
                     - (v(2, (1, 0, 0)) - v(2, (-1, 0, 0)))) * factor)
    wz = keep("wz", ((v(1, (1, 0, 0)) - v(1, (-1, 0, 0)))
                     - (v(0, (0, 1, 0)) - v(0, (0, -1, 0)))) * factor)
    ss = keep("sum of squares", wx * wx + wy * wy + wz * wz)
    keep("sqrt", torch.sqrt(ss))
    return parts


def difference(a: torch.Tensor, b: torch.Tensor, threads: int) -> Optional[dict]:
    """None where ``a`` is bitwise ``b``; else the count of differing
    values, the largest difference and where it lies, the flat index range
    of the differing values and the chunks (of ``threads`` equal ones of
    the flat range) that hold them."""
    d = (a != b).reshape(-1)
    if not bool(d.any()):
        return None
    flat = d.nonzero().reshape(-1)
    diff = (a - b).abs()
    chunk = -(-d.numel() // threads)
    return {"count": int(flat.numel()), "max": float(diff.max()),
            "at": [int(i) for i in np.unravel_index(int(diff.argmax()), diff.shape)],
            "flat": [int(flat[0]), int(flat[-1])],
            "chunks": sorted(set((flat // chunk).tolist())), "chunk": chunk}


def differing(first: dict, second: dict, threads: int) -> dict:
    """``{name: difference}`` of every output of ``first`` that ``second``
    does not repeat bitwise."""
    out = {}
    for name, a in first.items():
        d = difference(a, second[name], threads)
        if d is not None:
            out[name] = d
    return out


def narrow(topo, u: torch.Tensor, factor: float, repeats: int, say=print) -> dict:
    """The first offset magnitude ``repeats`` times on ``u``, each repeat
    held to the first (module doc, ``--narrow``). ``odd_first``: every later
    repeat differs from the first and all of them repeat the second
    bitwise; ``sqrt_rel``: the first repeat's largest relative difference
    from the second in the ``sqrt``."""
    threads = torch.get_num_threads()
    held = {}
    first = curl_mag_parts(topo, u, NARROW_OFFSET, factor, held)
    found, second, later_agree = {}, None, True
    for r in range(1, repeats):
        parts = curl_mag_parts(topo, u, NARROW_OFFSET, factor)
        if second is None:
            second = parts
        elif differing(second, parts, threads):
            later_agree = False
        diffs = differing(first, parts, threads)
        if diffs:
            name, d = next(iter(diffs.items()))
            found[r] = name
            say(f"repeat {r}: {name} first differs from repeat 0: {d['count']} values, max "
                f"{d['max']:.3e} at {tuple(d['at'])}, flat {d['flat'][0]}..{d['flat'][1]}, "
                f"chunks {d['chunks']} of {threads} ({d['chunk']} values each)")
    rel = 0.0
    if second is not None:
        b = second["sqrt"].double()
        rel = float(((first["sqrt"].double() - b) / b.clamp_min(1e-30)).abs().max())
    return {"repeats": repeats, "threads": threads, "differing": found,
            "odd_first": repeats > 1 and len(found) == repeats - 1 and later_agree,
            "sqrt_rel": rel,
            "stored_changed": sorted(k for k in first if not torch.equal(first[k], held[k]))}


def main(argv=None) -> int:
    ap = parser(__doc__, timed=False)
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--narrow", type=int, default=0, metavar="R",
                    help="repeat only the first offset magnitude R times")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    topo, state, p = inputs(args.n, args.seed, dev)
    threads = torch.get_num_threads()
    if args.narrow:
        u = advection.advect_velocity(topo, state.velocity, p.dt, p.inv_voxel_size)
        res = narrow(topo, u, 0.5 * p.inv_voxel_size, args.narrow,
                     say=lambda line: print(line, flush=True))
        print(json.dumps({"n": args.n, **res}))
        return 0
    diffs = differing(stages(topo, state, p), stages(topo, state, p), threads)
    for name, d in diffs.items():
        print(f"{name}: {d['count']} values differ, max {d['max']:.3e} at {tuple(d['at'])}",
              flush=True)
    print(json.dumps({"n": args.n, "threads": threads,
                      "differing": {k: d["count"] for k, d in diffs.items()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
